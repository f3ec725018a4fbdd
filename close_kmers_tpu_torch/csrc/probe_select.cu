// Payload-wide probe: row fetch, match and select for every window.
//
// Replaces close_kmers_tpu/ops/pallas_select.py::select_wide_rows
// (_select_kernel), the XLA row gather in front of it
// (core/engine.py probe_windows, `payload_wide[hif]`) and the miss
// masking of core/engine.py::_finish_select.
//
// Layout of one payload-wide row (row_w int32, row_w >= 1 + 5*wd):
//   [start | lo plane (wd) | fi (wd) | oi (wd) | avg_off (wd) | wt bits (wd) | pad]
// Bucket keys are unique, so at most one lane of the lo plane matches.
//
// Design: one warp per window.  The warp reads the lo plane of row `hi`
// in chunks of 32 lanes (one int32 per lane, coalesced), finds the match
// with __ballot_sync, and lane 0 reads the four payload values and the
// row start.  wd > 32 loops over chunks, so a deeper tier can reuse the
// kernel.  An invalid window reads nothing (its hi may lie outside the
// table) and takes the miss values, which equal what the reference's
// probe with hi=0, lo=-2 gives.
//
// Bound: bytes, at one random row read per window: the lo plane chunk
// (128 B for wd <= 32) plus five scattered 4-byte payload reads, i.e.
// about row_w*4 bytes touched in the worst case, against ~29 B written.
// The TPU path gathered the whole row (row_w*4 B) into HBM and re-read
// it; here nothing of the row is written back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

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
  const int32_t q = lo[w];
  const bool ok = valid[w] != 0 && h >= 0 && h < n_rows;  // warp-uniform
  const int32_t* row = rows + static_cast<int64_t>(ok ? h : 0) * row_w;
  int pos = -1;
  if (ok) {
    for (int c = 0; c < wd; c += 32) {
      const int j = c + lane;
      const bool m = j < wd && row[1 + j] == q;
      const unsigned ballot = __ballot_sync(0xffffffffu, m);
      if (ballot) {
        pos = c + __ffs(ballot) - 1;
        break;
      }
    }
  }
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

}  // namespace

extern "C" int ck_probe_select(const void* hi, const void* lo,
                               const void* valid, const void* rows,
                               int64_t n_windows, int32_t n_rows,
                               int32_t row_w, int32_t wd, int32_t n_db,
                               void* found, void* fi, void* oi, void* avg_off,
                               void* wt, void* idx, void* stream) {
  if (n_windows > 0) {
    const int64_t blocks = (n_windows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    probe_select_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32,
                          0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo),
        static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(rows),
        n_windows, n_rows, row_w, wd, n_db, static_cast<uint8_t*>(found),
        static_cast<int32_t*>(fi), static_cast<int32_t*>(oi),
        static_cast<int32_t*>(avg_off), static_cast<float*>(wt),
        static_cast<int32_t*>(idx));
  }
  return static_cast<int>(cudaGetLastError());
}
