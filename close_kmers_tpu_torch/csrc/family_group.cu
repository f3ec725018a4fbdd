// Family grouping and per-row compaction of the family rollup.
//
// Replaces the grouping lax.scan and the per-row compaction of
// close_kmers_tpu/core/device_family.py::rollup_from_fams (the scan `step`
// over the W*D sorted columns, then the argsort(~emit) left-pack).  That
// is XLA code on the TPU, not a Pallas kernel; in torch it would be a
// loop of ~20 small launches per column, ~18k per 4096-row batch.
//
// Input: each row's (key, weight, position) planes, stably sorted by key
// along the row, row-major [B, M].  Keys >= kPadKey are pads and sort
// last.  Output, per row: the number of family groups and the first `cap`
// groups left-packed in ascending family order -- family, count, weighted
// sum, first position -- as [B, cap] planes; slots past the row's groups
// are zero.
//
// Design: one thread per row, state in registers, one pass over the
// row's valid prefix (the first pad ends it).  A group's weighted sum is a
// chain of single IEEE f32 adds (__fadd_rn, no fast-math, no FMA) in the
// sorted order, which the stable sort keeps in (window, family-list) order:
// the exact visit order of native.family_scores, so the sums are
// bit-identical to the host accumulation.
//
// Bound: latency.  Only B threads exist (4096 at serving batches), each
// walking up to M (~900) columns of 12 B; a thread's reads are sequential
// within its row, so L1 serves most of them, but few warps per SM are in
// flight to hide the misses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int32_t kPadKey = 1 << 30;

__global__ void family_group_kernel(const int32_t* __restrict__ skey,
                                    const float* __restrict__ swt,
                                    const int32_t* __restrict__ spos,
                                    int32_t n_rows, int32_t m, int32_t cap,
                                    int32_t* __restrict__ n_groups,
                                    int32_t* __restrict__ fam,
                                    int32_t* __restrict__ cnt,
                                    float* __restrict__ ws,
                                    int32_t* __restrict__ first) {
  const int32_t b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_rows) return;
  const int64_t in0 = static_cast<int64_t>(b) * m;
  const int64_t out0 = static_cast<int64_t>(b) * cap;
  int32_t cur = 0, c = 0, f0 = 0, k = 0;
  float s = 0.0f;
  bool have = false;
  for (int32_t t = 0; t < m; ++t) {
    const int32_t f = skey[in0 + t];
    if (f >= kPadKey) break;  // sorted: only pads from here on
    const float wv = swt[in0 + t];
    if (have && f == cur) {
      ++c;
      s = __fadd_rn(s, wv);
      continue;
    }
    if (have) {
      if (k < cap) {
        fam[out0 + k] = cur;
        cnt[out0 + k] = c;
        ws[out0 + k] = s;
        first[out0 + k] = f0;
      }
      ++k;
    }
    cur = f;
    c = 1;
    s = wv;
    f0 = spos[in0 + t];
    have = true;
  }
  if (have) {
    if (k < cap) {
      fam[out0 + k] = cur;
      cnt[out0 + k] = c;
      ws[out0 + k] = s;
      first[out0 + k] = f0;
    }
    ++k;
  }
  n_groups[b] = k;
  for (int32_t j = k < cap ? k : cap; j < cap; ++j) {
    fam[out0 + j] = 0;
    cnt[out0 + j] = 0;
    ws[out0 + j] = 0.0f;
    first[out0 + j] = 0;
  }
}

}  // namespace

extern "C" int ck_family_group(const void* skey, const void* swt,
                               const void* spos, int32_t n_rows, int32_t m,
                               int32_t cap, void* n_groups, void* fam,
                               void* cnt, void* ws, void* first,
                               void* stream) {
  if (n_rows > 0) {
    const unsigned blocks = static_cast<unsigned>(
        (static_cast<int64_t>(n_rows) + kThreads - 1) / kThreads);
    family_group_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(skey), static_cast<const float*>(swt),
        static_cast<const int32_t*>(spos), n_rows, m, cap,
        static_cast<int32_t*>(n_groups), static_cast<int32_t*>(fam),
        static_cast<int32_t*>(cnt), static_cast<float*>(ws),
        static_cast<int32_t*>(first));
  }
  return static_cast<int>(cudaGetLastError());
}
