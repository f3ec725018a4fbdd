// Wide-row probes: row fetch, match and select for every window.
//
// Two entries, one design.
//
// ck_probe_select replaces close_kmers_tpu/ops/pallas_select.py::
// select_wide_rows (_select_kernel), the XLA row gather in front of it
// (core/engine.py probe_windows, `payload_wide[hif]`) and the miss masking
// of core/engine.py::_finish_select.  Layout of one payload-wide row
// (row_w int32, row_w >= 1 + 5*wd):
//   [start | lo plane (wd) | fi (wd) | oi (wd) | avg_off (wd) | wt bits (wd) | pad]
//
// ck_famwide_select replaces the folded single-gather probe of
// core/device_family.py::_score_family_jit (the `famwide` branch: the XLA
// row gather `famwide[hif]`, the masked-sum picks and the miss masking).
// It has no Pallas counterpart.  Layout of one famwide row
// (row_w >= (2 + d)*wd):
//   [(fi << lo_bits | lo) (wd) | wt bits (wd) | fam_0 (wd) .. fam_{d-1} (wd) | pad]
// A slot matches when its low lo_bits equal the window's; empty slots hold
// (1 << 30) | lo_mask, whose low bits (8191 for 13 bits) exceed every real
// lo (< 8000), and an invalid window's lo = -2 masks to 8190, so neither
// ever matches.
//
// Bucket keys are unique, so at most one lane of a row's lo plane matches.
//
// Design: one warp per window.  The warp reads the lo plane of row `hi`
// in chunks of 32 lanes (one int32 per lane, coalesced), finds the match
// with __ballot_sync, and then reads only the picked values.  wd > 32
// loops over chunks, so a deeper tier can reuse the match.  An invalid
// window reads nothing (its hi may lie outside the table) and takes the
// miss values, which equal what the reference's probe with hi=0, lo=-2
// gives.
//
// Bound: bytes, at one random row read per window: the lo plane chunk
// (128 B for wd <= 32) plus a few scattered 4-byte picks, against ~29 B
// (probe) or 9 + 4*d B (famwide) written.  The TPU path gathered the whole
// row (row_w*4 B) into HBM and re-read it; here nothing of the row is
// written back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

// The matching slot of a row's lo plane (-1 when none): the first lane
// whose (plane & mask) equals (q & mask).  Called by all 32 lanes.
__device__ __forceinline__ int find_slot(const int32_t* plane, int32_t wd,
                                         int32_t q, int32_t mask, int lane) {
  const int32_t qm = q & mask;
  for (int c = 0; c < wd; c += 32) {
    const int j = c + lane;
    const bool m = j < wd && (plane[j] & mask) == qm;
    const unsigned ballot = __ballot_sync(0xffffffffu, m);
    if (ballot) return c + __ffs(ballot) - 1;
  }
  return -1;
}

__global__ void probe_select_kernel(
    const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ rows,
    int64_t n_windows, int32_t n_rows, int32_t row_w, int32_t wd,
    int32_t n_db, uint8_t* __restrict__ found, int32_t* __restrict__ fi,
    int32_t* __restrict__ oi, int32_t* __restrict__ avg_off,
    float* __restrict__ wt, int32_t* __restrict__ idx) {
  const int lane = threadIdx.x & 31;
  const int64_t w =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_windows) return;  // uniform across the warp
  const int32_t h = hi[w];
  const bool ok = valid[w] != 0 && h >= 0 && h < n_rows;  // warp-uniform
  const int32_t* row = rows + static_cast<int64_t>(ok ? h : 0) * row_w;
  const int pos = ok ? find_slot(row + 1, wd, lo[w], -1, lane) : -1;
  if (lane != 0) return;
  if (pos >= 0) {
    found[w] = 1;
    fi[w] = row[1 + wd + pos];
    oi[w] = row[1 + 2 * wd + pos];
    avg_off[w] = row[1 + 3 * wd + pos];
    wt[w] = __int_as_float(row[1 + 4 * wd + pos]);
    idx[w] = row[0] + pos;
  } else {
    found[w] = 0;
    fi[w] = -1;
    oi[w] = -1;
    avg_off[w] = 0;
    wt[w] = 0.0f;
    idx[w] = n_db;
  }
}

__global__ void famwide_select_kernel(
    const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ rows,
    int64_t n_windows, int32_t n_rows, int32_t row_w, int32_t wd, int32_t d,
    int32_t lo_bits, uint8_t* __restrict__ found, int32_t* __restrict__ fi,
    float* __restrict__ wt, int32_t* __restrict__ fams) {
  const int lane = threadIdx.x & 31;
  const int64_t w =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_windows) return;  // uniform across the warp
  const int32_t h = hi[w];
  const bool ok = valid[w] != 0 && h >= 0 && h < n_rows;  // warp-uniform
  const int32_t* row = rows + static_cast<int64_t>(ok ? h : 0) * row_w;
  const int32_t mask = (1 << lo_bits) - 1;
  const int pos = ok ? find_slot(row, wd, lo[w], mask, lane) : -1;
  // the d family ids: one lane each
  int32_t* out = fams + w * d;
  for (int p = lane; p < d; p += 32)
    out[p] = pos >= 0 ? row[(2 + p) * wd + pos] : -1;
  if (lane != 0) return;
  if (pos >= 0) {
    found[w] = 1;
    fi[w] = row[pos] >> lo_bits;
    wt[w] = __int_as_float(row[wd + pos]);
  } else {
    found[w] = 0;
    fi[w] = -1;
    wt[w] = 0.0f;
  }
}

unsigned blocks_for(int64_t n_windows) {
  return static_cast<unsigned>((n_windows + kWarpsPerBlock - 1) /
                               kWarpsPerBlock);
}

}  // namespace

extern "C" int ck_probe_select(const void* hi, const void* lo,
                               const void* valid, const void* rows,
                               int64_t n_windows, int32_t n_rows,
                               int32_t row_w, int32_t wd, int32_t n_db,
                               void* found, void* fi, void* oi, void* avg_off,
                               void* wt, void* idx, void* stream) {
  if (n_windows > 0) {
    probe_select_kernel<<<blocks_for(n_windows), kWarpsPerBlock * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo),
        static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(rows),
        n_windows, n_rows, row_w, wd, n_db, static_cast<uint8_t*>(found),
        static_cast<int32_t*>(fi), static_cast<int32_t*>(oi),
        static_cast<int32_t*>(avg_off), static_cast<float*>(wt),
        static_cast<int32_t*>(idx));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ck_famwide_select(const void* hi, const void* lo,
                                 const void* valid, const void* rows,
                                 int64_t n_windows, int32_t n_rows,
                                 int32_t row_w, int32_t wd, int32_t d,
                                 int32_t lo_bits, void* found, void* fi,
                                 void* wt, void* fams, void* stream) {
  if (n_windows > 0) {
    famwide_select_kernel<<<blocks_for(n_windows), kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo),
        static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(rows),
        n_windows, n_rows, row_w, wd, d, lo_bits,
        static_cast<uint8_t*>(found), static_cast<int32_t*>(fi),
        static_cast<float*>(wt), static_cast<int32_t*>(fams));
  }
  return static_cast<int>(cudaGetLastError());
}
