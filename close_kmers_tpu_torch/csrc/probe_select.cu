// Wide-row probes: row fetch, match and select for every window.
//
// Two entries.
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
// An invalid window reads nothing (its hi may lie outside the table) and
// takes the miss values, which equal what the reference's probe with
// hi=0, lo=-2 gives.
//
// Bound: bytes, at one random row read per window: the lo plane (88 B
// at wd = 22) plus a few scattered 4-byte picks, against ~29 B (probe) or
// 9 + 4*d B (famwide) written.  The TPU path gathered the whole row
// (row_w*4 B) into HBM and re-read it; here nothing of the row is written
// back.  What holds both back on the card is latency: a window makes two
// dependent trips to device memory (the lo plane, then the picks).
//
// probe_select's design: a quarter-warp (8 lanes) per window and
// kPsWindows windows per quarter-warp, all in flight together.  Lane s
// reads ints c + 4s .. c + 4s + 3 of each window's row for c = 0, 32, ...
// while c <= wd, so start (int 0) and the whole lo plane (ints 1..wd) come
// in one 16-B load a lane where wd <= 31 and the rows are 16-B aligned
// (four 4-B loads where not); a ballot within the quarter-warp finds the
// matching slot and a shuffle hands start over from lane 0.  Then lanes
// 0-3 read the fi, oi, avg_off and wt picks of all the windows in one
// round, and lanes 0-5 store the six outputs, consecutive quarter-warps
// on consecutive windows.  ~67,000 windows' rows are in flight on the
// card, 8 times the warp-per-window design it replaced.  What is left is
// device memory: up to ~5.6 bursts of 64 B per hit (two for start and the
// lo plane at wd = 22, fi sharing the second when its slot is <= 8, then
// oi, avg_off and wt, each in its own plane); windows of one row share
// its first two.
//
// famwide_select's design: a quarter-warp (8 lanes) per window and
// kFwWindows windows per quarter-warp, all in flight together: each lane
// reads 16 B of each window's lo plane (32 slots per quarter-warp in one
// load where the rows are 16-B aligned, four 4-B loads where not), the
// match lane's packed value gives fi by shuffle, and the wt and d family
// picks of all the windows go out in one round, one lane each.  A warp
// keeps 8 windows' rows in flight, ~67,000 on the card, 8 times the
// warp-per-window design; more (4 windows a quarter-warp) measured no
// faster.  What is left is device memory: each window's row costs ~6
// bursts of 64 B (the lo plane, then the wt and d picks, each in its own
// plane); on a table far larger than L2, where nearly every window reads
// a row no other window of the batch reads, that is most of the card's
// memory rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPsWindows = 2;              // windows per quarter-warp
constexpr int kPsThreads = 256;
constexpr int kPsGroups = kPsThreads / 8;   // quarter-warps per block

// Ints j0 .. j0 + 3 of a payload-wide row, j0 <= wd (4-B loads stop at
// int wd, the lo plane's last).
template <bool kVec>
__device__ __forceinline__ void ps_load(const int32_t* row, int j0,
                                        int32_t wd, int32_t (&x)[4]) {
  if (kVec) {
    // in the row: j0 and row_w are multiples of 4 and j0 <= wd < row_w
    const int4 q = *reinterpret_cast<const int4*>(row + j0);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) x[t] = j0 + t <= wd ? row[j0 + t] : 0;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kPsThreads) probe_select_kernel(
    const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ rows,
    int64_t n_windows, int32_t n_rows, int32_t row_w, int32_t wd,
    int32_t n_db, uint8_t* __restrict__ found, int32_t* __restrict__ fi,
    int32_t* __restrict__ oi, int32_t* __restrict__ avg_off,
    float* __restrict__ wt, int32_t* __restrict__ idx) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & 7;            // lane within the quarter-warp
  const int first_lane = lane & ~7;    // its first lane in the warp
  // window k of quarter-warp q: consecutive quarter-warps take
  // consecutive windows, so the per-window loads and stores coalesce
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kPsGroups * kPsWindows
                     + (threadIdx.x >> 3);
  int64_t w[kPsWindows];
  const int32_t* row[kPsWindows];
  int32_t q[kPsWindows];
  bool ok[kPsWindows];
#pragma unroll
  for (int k = 0; k < kPsWindows; ++k) {
    w[k] = w0 + static_cast<int64_t>(k) * kPsGroups;
    ok[k] = false;
    q[k] = 0;
    row[k] = rows;
    if (w[k] < n_windows) {
      const int32_t h = hi[w[k]];
      ok[k] = valid[w[k]] != 0 && h >= 0 && h < n_rows;
      q[k] = lo[w[k]];
      if (ok[k]) row[k] = rows + static_cast<int64_t>(h) * row_w;
    }
  }
  // 1. start and the lo plane (ints 0 .. wd) of every window, 32 ints a
  // round, then the matches: lo slot s is int 1 + s
  int pos[kPsWindows];
  int32_t start[kPsWindows];
#pragma unroll
  for (int k = 0; k < kPsWindows; ++k) {
    pos[k] = -1;
    start[k] = 0;
  }
  for (int32_t c = 0; c <= wd; c += 32) {   // uniform: wd is the launch's
    const int j0 = c + 4 * sub;
    int slot[kPsWindows];
    int32_t first[kPsWindows];
#pragma unroll
    for (int k = 0; k < kPsWindows; ++k) {
      slot[k] = -1;
      first[k] = 0;
      if (ok[k] && pos[k] < 0 && j0 <= wd) {
        int32_t x[4];
        ps_load<kVec>(row[k], j0, wd, x);
        first[k] = x[0];
#pragma unroll
        for (int t = 3; t >= 0; --t) {
          const int j = j0 + t;
          if (j >= 1 && j <= wd && x[t] == q[k]) slot[k] = j - 1;
        }
      }
    }
    bool more = false;
#pragma unroll
    for (int k = 0; k < kPsWindows; ++k) {
      const unsigned hit =
          (__ballot_sync(0xffffffffu, slot[k] >= 0) >> first_lane) & 0xffu;
      const int p = __shfl_sync(0xffffffffu, slot[k],
                                first_lane + (hit ? __ffs(hit) - 1 : 0));
      if (c == 0) start[k] = __shfl_sync(0xffffffffu, first[k], first_lane);
      if (hit && pos[k] < 0) pos[k] = p;
      more |= ok[k] && pos[k] < 0;
    }
    if (!__any_sync(0xffffffffu, more)) break;   // uniform
  }
  // 2. the picks of every window together: lane p < 4 reads plane 1 + p
  // (fi, oi, avg_off, wt bits) at the matched slot; then lanes 0-3 and 5
  // store those and idx, lane 4 found
  int32_t* const dst = sub == 0 ? fi : sub == 1 ? oi : sub == 2 ? avg_off
                       : sub == 3 ? reinterpret_cast<int32_t*>(wt) : idx;
  int32_t got[kPsWindows];
#pragma unroll
  for (int k = 0; k < kPsWindows; ++k)
    got[k] = pos[k] >= 0 && sub < 4 ? row[k][1 + (sub + 1) * wd + pos[k]] : 0;
#pragma unroll
  for (int k = 0; k < kPsWindows; ++k) {
    if (w[k] >= n_windows) continue;
    const bool f = pos[k] >= 0;
    if (sub == 4) {
      found[w[k]] = f;
    } else if (sub < 6) {
      dst[w[k]] = f ? (sub < 4 ? got[k] : start[k] + pos[k])
                    : (sub < 2 ? -1 : sub == 5 ? n_db : 0);
    }
  }
}

constexpr int kFwWindows = 2;              // windows per quarter-warp
constexpr int kFwThreads = 256;
constexpr int kFwGroups = kFwThreads / 8;   // quarter-warps per block

// The first slot of chunk c of the quarter-warp's lo plane whose low
// lo_bits equal qm, as (slot, packed value); slot -1 when none.  Each
// lane tests the four slots c + 4*sub .. c + 4*sub + 3 below wd.
template <bool kVec>
__device__ __forceinline__ void fw_match(const int32_t* row, int32_t c,
                                         int32_t wd, int32_t mask,
                                         int32_t qm, int sub, int& slot,
                                         int32_t& packed) {
  const int j0 = c + 4 * sub;
  int32_t x[4];
  if (kVec) {
    // in the row: j0 < wd, and wd + 3 <= row_w when 4 | row_w
    const int4 q = *reinterpret_cast<const int4*>(row + j0);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) x[t] = j0 + t < wd ? row[j0 + t] : 0;
  }
  slot = -1;
#pragma unroll
  for (int t = 3; t >= 0; --t) {
    if (j0 + t < wd && (x[t] & mask) == qm) {
      slot = j0 + t;
      packed = x[t];
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kFwThreads) famwide_select_kernel(
    const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ rows,
    int64_t n_windows, int32_t n_rows, int32_t row_w, int32_t wd, int32_t d,
    int32_t lo_bits, uint8_t* __restrict__ found, int32_t* __restrict__ fi,
    float* __restrict__ wt, int32_t* __restrict__ fams) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & 7;            // lane within the quarter-warp
  const int first_lane = lane & ~7;    // its first lane in the warp
  const int32_t mask = (1 << lo_bits) - 1;
  // window k of quarter-warp q: consecutive quarter-warps take
  // consecutive windows, so the per-window loads and stores coalesce
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kFwGroups * kFwWindows
                     + (threadIdx.x >> 3);
  int64_t w[kFwWindows];
  const int32_t* row[kFwWindows];
  int32_t qm[kFwWindows];
  bool ok[kFwWindows];
#pragma unroll
  for (int k = 0; k < kFwWindows; ++k) {
    w[k] = w0 + static_cast<int64_t>(k) * kFwGroups;
    ok[k] = false;
    qm[k] = 0;
    if (w[k] < n_windows) {
      const int32_t h = hi[w[k]];
      ok[k] = valid[w[k]] != 0 && h >= 0 && h < n_rows;
      qm[k] = lo[w[k]] & mask;
      row[k] = rows + static_cast<int64_t>(ok[k] ? h : 0) * row_w;
    } else {
      row[k] = rows;
    }
  }
  // 1. the lo planes of all kFwWindows windows, then the matches
  int pos[kFwWindows];
  int32_t fiv[kFwWindows];
#pragma unroll
  for (int k = 0; k < kFwWindows; ++k) {
    pos[k] = -1;
    fiv[k] = -1;
  }
  for (int32_t c = 0; c < wd; c += 32) {   // uniform: wd is the launch's
    int slot[kFwWindows];
    int32_t packed[kFwWindows];
#pragma unroll
    for (int k = 0; k < kFwWindows; ++k) {
      slot[k] = -1;
      packed[k] = 0;
      if (ok[k] && pos[k] < 0 && c + 4 * sub < wd)
        fw_match<kVec>(row[k], c, wd, mask, qm[k], sub, slot[k], packed[k]);
    }
#pragma unroll
    for (int k = 0; k < kFwWindows; ++k) {
      const unsigned hit =
          (__ballot_sync(0xffffffffu, slot[k] >= 0) >> first_lane) & 0xffu;
      const int src = first_lane + (hit ? __ffs(hit) - 1 : 0);
      const int p = __shfl_sync(0xffffffffu, slot[k], src);
      const int32_t v = __shfl_sync(0xffffffffu, packed[k], src);
      if (hit && pos[k] < 0) {
        pos[k] = p;
        fiv[k] = v >> lo_bits;
      }
    }
  }
  // 2. the picks, all windows' together: lane p takes plane 1 + p (p = 0
  // the wt bits, p >= 1 family p - 1)
  for (int p0 = 0; p0 <= d; p0 += 8) {
    const int p = p0 + sub;
    int32_t got[kFwWindows];
#pragma unroll
    for (int k = 0; k < kFwWindows; ++k)
      got[k] = pos[k] >= 0 && p <= d ? row[k][(1 + p) * wd + pos[k]]
                                     : (p ? -1 : 0);
#pragma unroll
    for (int k = 0; k < kFwWindows; ++k) {
      if (w[k] >= n_windows || p > d) continue;
      if (p == 0)
        wt[w[k]] = __int_as_float(got[k]);
      else
        fams[w[k] * d + p - 1] = got[k];
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int k = 0; k < kFwWindows; ++k) {
      if (w[k] >= n_windows) continue;
      found[w[k]] = pos[k] >= 0;
      fi[w[k]] = fiv[k];
    }
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
    const unsigned blocks = static_cast<unsigned>(
        (n_windows + kPsGroups * kPsWindows - 1) / (kPsGroups * kPsWindows));
    // 16-B loads of start and the lo plane where every row starts 16-B
    // aligned
    const bool vec = reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                     row_w % 4 == 0;
    auto kernel = vec ? probe_select_kernel<true>
                      : probe_select_kernel<false>;
    kernel<<<blocks, kPsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
    const unsigned blocks = static_cast<unsigned>(
        (n_windows + kFwGroups * kFwWindows - 1) / (kFwGroups * kFwWindows));
    // 16-B loads of the lo plane where every row starts 16-B aligned
    const bool vec = reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                     row_w % 4 == 0;
    auto kernel = vec ? famwide_select_kernel<true>
                      : famwide_select_kernel<false>;
    kernel<<<blocks, kFwThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo),
        static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(rows),
        n_windows, n_rows, row_w, wd, d, lo_bits,
        static_cast<uint8_t*>(found), static_cast<int32_t*>(fi),
        static_cast<float*>(wt), static_cast<int32_t*>(fams));
  }
  return static_cast<int>(cudaGetLastError());
}
