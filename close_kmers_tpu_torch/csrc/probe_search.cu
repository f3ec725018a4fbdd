// Binary-search probe: each window's lower bound in its hi bucket's slice
// of the sorted lo array, then its payload row.
//
// ck_probe_search replaces the binary-search tier of
// close_kmers_tpu/core/engine.py::probe_windows (lines 603-628), which the
// JAX package left to XLA (no Pallas kernel): the bucket_pair gather, the
// n_steps halvings of a fori_loop, the equality test and the [N+1, 4]
// payload gather.  Its plain torch version is
// ops/probe_search.py::probe_search_plain.
//
// Inputs: hi, lo (int32) and valid (bool) of N windows; bucket_pair
// [n_hi, 2] (start, end) int32; lo_arr [n+1] int32, sorted within each
// bucket; payload [n+1, 4] int32 (fi, oi, avg_off, wt bits), row n the
// miss row.  Outputs: found, fi, oi, avg_off, wt, idx of each window, the
// miss values those of payload row n and idx = n.  Domain: 0 <= n <
// 2^31 - 1, every bucket_pair entry in [0, n].
//
// Semantics, bit for bit those of the plain version: an invalid window
// searches bucket 0 for lo = -2 (it finds nothing); each step with left <
// right halves [left, right) at mid = left + ((right - left) >> 1),
// reading lo_arr[mid]; a step with left >= right changes nothing, and the
// search never runs past n_steps (a table carried over with a smaller
// n_steps ends its search early, as the plain version does).  Then idx =
// min(left, n) and found = valid & left < end & lo_arr[idx] == lo.  A
// valid window whose hi lies outside [0, n_hi) reads no bucket and misses
// (the plain version raises there).  The midpoint differs on purpose from
// the reference's (left + right) >> 1 (close_kmers_tpu/core/engine.py:615):
// that sum wraps in int32 once a bucket starts at or above 2^30, and the
// search then reads another bucket's keys; below 2^30 keys the two are
// equal.
//
// Bound: bytes.  A window reads its 9 B of inputs, its 8-B bucket pair,
// the 32-B sectors of lo_arr its lower bound needs and, on a hit, its 16-B
// payload row, and writes 21 B.  What holds the card back is the number
// of scattered 32-B sectors a window reads, not the chain of dependent
// loads: chip_smoke.py's decomposition (PERF.md section 6) found the first
// design (one thread a window, a chain of n_steps halvings) moving ~28-29
// G scattered sectors a second, pair + payload alone at the same rate,
// more chains in flight or more occupancy gaining nothing, windows sorted
// by hi (shared sectors) twice as fast, and a quarter-warp k-ary search
// (8 scattered pivots a round, 8 lanes' instructions a window) slower.
//
// Design: one thread a window reads its bucket's search row (rows [n_hi,
// 8] int32, 32 B, one sector: start, end, then twelve 16-bit slots, or
// six 32-bit ones and bit 31 of end set where a key the row holds lies
// outside [0, 2^16); ops/probe_search.py::search_rows builds them from
// bucket_pair and lo_arr):
//   * a bucket of up to twelve keys (six) holds them in the slots: the
//     count of those below lo is the lower bound, and the slot there tests
//     equality, so the window reads its row and its payload row and
//     nothing of lo_arr;
//   * a larger bucket (L keys) holds pivots, the keys at (j + 1) * s - 1
//     for s = L / (slots + 1) + 1, which leave a segment of at most
//     L / (slots + 1) keys (and the key after it); halvings inside the
//     segment while it spans more than kScan = 12 keys, then one round of
//     up to four aligned 16-B chunks from a & ~3 counts its keys below lo;
//   * then the payload row (16 B) and the six stores.
// The windows of a warp are independent, so their reads overlap.  A
// bucket that does not converge within n_steps (a table carried over
// with fewer n_steps) runs the plain version's halving chain from the
// row's start and end instead; both branches give the plain version's
// planes.  16-B row and payload loads where both start 16-B aligned, 16-B
// lo loads where lo_arr does, 4-B loads otherwise.
//
// ck_probe_search_exp holds the experiments that measured what bounds the
// search (chip_smoke.py's decomposition); the serving path never calls
// them.  Variant 0: the bucket pair, then the payload row of the window's
// known result (known[w], the kernel's idx plane), made to depend on the
// pair: the chain with no search.  Variants 1-3: the first design, one
// thread a window, at 128, 256 and 512 threads a block.  Variants 4-6:
// the first design with 2, 3 and 4 windows a thread, their chains
// interleaved.  Variants 7-11: a quarter-warp k-ary design (8 lanes a
// window, k-ary rounds of kP scattered pivots while the range spans more
// than 29 keys, then one contiguous round of 16 B a lane) with 1, 2 and 4
// windows a quarter-warp and 8 pivots, and with 2 windows and 1 or 3
// pivots.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowW = 8;               // ints of a search row (32 B)
constexpr int kNarrowSlots = 12;       // its 16-bit keys or pivots
constexpr int kWideSlots = 6;          // or its 32-bit ones
constexpr int kScan = 12;              // the most keys the chunk round takes
constexpr int kRowChunks = 4;          // 16-B chunks that hold them
constexpr int kSpan = 29;   // the most keys the quarter-warp's round takes
constexpr unsigned kFull = 0xffffffffu;

// The halving search of the plain version on [left, end): at most n_steps
// steps, each while left < right; returns the final left.
__device__ __forceinline__ int32_t halving(const int32_t* __restrict__ lo_arr,
                                           int32_t left, int32_t end,
                                           int32_t n, int32_t n_steps,
                                           int32_t lc) {
  int32_t right = end;
  for (int32_t s = 0; s < n_steps && left < right; ++s) {
    const int32_t mid = left + ((right - left) >> 1);
    if (__ldg(lo_arr + (mid < n ? mid : n)) < lc) {
      left = mid + 1;
    } else {
      right = mid;
    }
  }
  return left;
}

template <bool kVecPair>
__device__ __forceinline__ void load_pair(const int32_t* __restrict__ pair,
                                          int32_t h, int32_t& start,
                                          int32_t& end) {
  if (kVecPair) {
    const int2 p = __ldg(reinterpret_cast<const int2*>(pair) + h);
    start = p.x;
    end = p.y;
  } else {
    start = __ldg(pair + 2 * static_cast<int64_t>(h));
    end = __ldg(pair + 2 * static_cast<int64_t>(h) + 1);
  }
}

// The four keys at j0 .. j0 + 3 (j0 a multiple of 4, j0 < e): one 16-B
// load where lo_arr is 16-B aligned (the chunk lies in the page of key j0,
// which is in the table), else 4-B loads of the keys below e.
template <bool kVecLo>
__device__ __forceinline__ void load_chunk(const int32_t* __restrict__ lo_arr,
                                           int64_t j0, int64_t e,
                                           int32_t (&x)[4]) {
  if (kVecLo) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(lo_arr + j0));
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) x[t] = j0 + t < e ? __ldg(lo_arr + j0 + t) : 0;
  }
}

// -- the search rows' design (ck_probe_search)

// The key at p of the four chunks x (base = the first chunk's position).
__device__ __forceinline__ int32_t chunk_key(const int32_t (&x)[kRowChunks][4],
                                             int64_t off) {
  int32_t v = 0;
#pragma unroll
  for (int t = 0; t < kRowChunks * 4; ++t) {
    if (off == t) v = x[t >> 2][t & 3];
  }
  return v;
}

template <bool kVec, bool kVecLo>
__global__ void __launch_bounds__(kThreads)
row_search_kernel(const int32_t* __restrict__ hi,
                  const int32_t* __restrict__ lo,
                  const uint8_t* __restrict__ valid,
                  const int32_t* __restrict__ rows, int32_t n_hi,
                  const int32_t* __restrict__ lo_arr,
                  const int32_t* __restrict__ payload, int64_t n_windows,
                  int32_t n, int32_t n_steps, uint8_t* __restrict__ found,
                  int32_t* __restrict__ fi, int32_t* __restrict__ oi,
                  int32_t* __restrict__ avg_off, float* __restrict__ wt,
                  int32_t* __restrict__ idx) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (w >= n_windows) return;
  int32_t row = n;
  const int32_t h = __ldg(hi + w);
  const int32_t lc = __ldg(lo + w);
  if (valid[w] != 0 && h >= 0 && h < n_hi) {
    // 1. the bucket's search row (one 32-B sector)
    const int32_t* r = rows + static_cast<int64_t>(h) * kRowW;
    int32_t x[kRowW];
    if (kVec) {
#pragma unroll
      for (int c = 0; c < kRowW / 4; ++c) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(r) + c);
        x[4 * c] = q.x;
        x[4 * c + 1] = q.y;
        x[4 * c + 2] = q.z;
        x[4 * c + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < kRowW; ++c) x[c] = __ldg(r + c);
    }
    const bool wide = x[1] < 0;
    const int32_t start = x[0], end = x[1] & 0x7fffffff;
    const int32_t len = end - start;
    const int cap = wide ? kWideSlots : kNarrowSlots;
    int32_t key[kNarrowSlots];
#pragma unroll
    for (int j = 0; j < kNarrowSlots; ++j) {
      const int32_t word = x[2 + (j >> 1)];
      key[j] = wide ? (j < kWideSlots ? x[2 + j] : 0)
                    : (j & 1 ? static_cast<int32_t>(
                                   static_cast<uint32_t>(word) >> 16)
                             : (word & 0xffff));
    }
    if (len > 0 && n_steps < 31 && (len >> n_steps) != 0) {
      // a bucket the n_steps halvings do not finish: the plain version's
      const int32_t left = halving(lo_arr, start, end, n, n_steps, lc);
      const int32_t at = left < n ? left : n;
      if (left < end && __ldg(lo_arr + at) == lc) row = at;
    } else if (len > 0 && len <= cap) {
      // 2a. the row holds the bucket: the count of its keys below lo
      int c = 0;
      int32_t kc = 0;
#pragma unroll
      for (int j = 0; j < kNarrowSlots; ++j) c += j < len && key[j] < lc;
#pragma unroll
      for (int j = 0; j < kNarrowSlots; ++j) {
        if (j == c) kc = key[j];
      }
      if (c < len && kc == lc) row = start + c;
    } else if (len > 0) {
      // 2b. the row holds cap pivots, the keys at (j + 1) * s - 1 for
      // s = len / (cap + 1) + 1: the lower bound lies in [a, b], and the
      // key at b (>= lo) is kb where b < end
      const int32_t s = len / (cap + 1) + 1;
      int c = 0;
      int32_t kb = 0;
#pragma unroll
      for (int j = 0; j < kNarrowSlots; ++j) {
        c += j < cap && (j + 1) * s - 1 < len && key[j] < lc;
      }
#pragma unroll
      for (int j = 0; j < kNarrowSlots; ++j) {
        if (j == c) kb = key[j];
      }
      int32_t a = start + c * s;
      int32_t b = (c < cap && (c + 1) * s - 1 < len)
                      ? start + (c + 1) * s - 1 : end;
      // 3. halvings while the range spans more than kScan keys, then
      // one round of 16-B chunks from a & ~3 (at most kRowChunks)
      while (b - a > kScan) {
        const int32_t mid = a + ((b - a) >> 1);
        const int32_t v = __ldg(lo_arr + mid);
        if (v < lc) {
          a = mid + 1;
        } else {
          b = mid;
          kb = v;
        }
      }
      const int64_t base = static_cast<int64_t>(a) & ~int64_t{3};
      int32_t ch[kRowChunks][4];
      int cnt = 0;
#pragma unroll
      for (int t = 0; t < kRowChunks; ++t) {
        const int64_t j0 = base + 4 * t;
        ch[t][0] = ch[t][1] = ch[t][2] = ch[t][3] = 0;
        if (j0 < b) {
          load_chunk<kVecLo>(lo_arr, j0, b, ch[t]);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            cnt += j0 + u >= a && j0 + u < b && ch[t][u] < lc;
          }
        }
      }
      const int32_t p = a + cnt;
      const int32_t kp = p < b ? chunk_key(ch, p - base) : kb;
      if (p < end && kp == lc) row = p;
    }
  }
  // 4. the payload row and the six stores
  int32_t y0, y1, y2, y3;
  if (kVec) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(payload) + row);
    y0 = q.x;
    y1 = q.y;
    y2 = q.z;
    y3 = q.w;
  } else {
    const int32_t* pr = payload + 4 * static_cast<int64_t>(row);
    y0 = __ldg(pr);
    y1 = __ldg(pr + 1);
    y2 = __ldg(pr + 2);
    y3 = __ldg(pr + 3);
  }
  found[w] = row != n;
  fi[w] = y0;
  oi[w] = y1;
  avg_off[w] = y2;
  wt[w] = __int_as_float(y3);
  idx[w] = row;
}

// -- experiments (chip_smoke.py's decomposition; not on the serving path)

// The quarter-warp design, kW windows a quarter-warp, kP pivots (lanes
// 0 .. kP-1) a k-ary round.
template <int kW, int kP, bool kVecPair, bool kVecLo>
__global__ void __launch_bounds__(kThreads)
quarter_kernel(const int32_t* __restrict__ hi,
                    const int32_t* __restrict__ lo,
                    const uint8_t* __restrict__ valid,
                    const int32_t* __restrict__ pair, int32_t n_hi,
                    const int32_t* __restrict__ lo_arr,
                    const int32_t* __restrict__ payload, int64_t n_windows,
                    int32_t n, int32_t n_steps, uint8_t* __restrict__ found,
                    int32_t* __restrict__ fi, int32_t* __restrict__ oi,
                    int32_t* __restrict__ avg_off, float* __restrict__ wt,
                    int32_t* __restrict__ idx) {
  constexpr int kGroups = kThreads / 8;
  const int lane = threadIdx.x & 31;
  const int sub = lane & 7;            // lane within the quarter-warp
  const int first_lane = lane & ~7;    // its first lane in the warp
  // window k of quarter-warp g: consecutive quarter-warps take
  // consecutive windows, so the per-window loads and stores coalesce
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kGroups * kW +
                     (threadIdx.x >> 3);
  int64_t w[kW];
  int32_t lc[kW], a[kW], b[kW], end[kW], row[kW];
  // mode: 0 no search (a miss), 1 the count, 2 the halving chain
  int mode[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    w[k] = w0 + static_cast<int64_t>(k) * kGroups;
    mode[k] = 0;
    lc[k] = 0;
    a[k] = b[k] = end[k] = 0;
    row[k] = n;
    if (w[k] < n_windows) {
      const int32_t h = __ldg(hi + w[k]);
      lc[k] = __ldg(lo + w[k]);
      if (valid[w[k]] != 0 && h >= 0 && h < n_hi) {
        load_pair<kVecPair>(pair, h, a[k], end[k]);
        b[k] = end[k];
        const int32_t len = end[k] - a[k];
        if (len > 0) {
          mode[k] = (n_steps >= 31 || (len >> n_steps) == 0) ? 1 : 2;
        }
      }
    }
  }
  // a bucket that does not converge: the plain version's halvings, every
  // lane of the quarter-warp alike (no warp-wide operation inside)
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    if (mode[k] == 2) {
      const int32_t left = halving(lo_arr, a[k], end[k], n, n_steps, lc[k]);
      const int32_t at = left < n ? left : n;
      if (left < end[k] && __ldg(lo_arr + at) == lc[k]) row[k] = at;
    }
  }
  // k-ary rounds, warp-uniform: while some window's range spans more than
  // kSpan keys (with the key at b when b < end)
  for (;;) {
    bool need[kW];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const int32_t e = b[k] < end[k] ? b[k] + 1 : end[k];
      need[k] = mode[k] == 1 && e - a[k] > kSpan;
      any |= need[k];
    }
    if (!__any_sync(kFull, any)) break;
    int32_t step[kW];
    bool lt[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      step[k] = (b[k] - a[k]) / (kP + 1) + 1;
      const int64_t q = static_cast<int64_t>(a[k]) +
                        static_cast<int64_t>(sub + 1) * step[k] - 1;
      lt[k] = need[k] && sub < kP && q < b[k] && __ldg(lo_arr + q) < lc[k];
    }
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const int c =
          __popc((__ballot_sync(kFull, lt[k]) >> first_lane) & 0xffu);
      if (need[k]) {
        // the keys at pivots 0 .. c-1 lie below lo, pivot c's (if any)
        // does not: the lower bound lies in [a + c*s, a + (c+1)*s - 1]
        const int64_t top = static_cast<int64_t>(a[k]) +
                            static_cast<int64_t>(c + 1) * step[k] - 1;
        if (c < kP && top < b[k]) b[k] = static_cast<int32_t>(top);
        a[k] += c * step[k];
      }
    }
  }
  // the contiguous round: the count of [a, b)'s keys below lo
  {
    int32_t x[kW][4];
    int64_t j0[kW];
    int cnt[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      j0[k] = (static_cast<int64_t>(a[k]) & ~int64_t{3}) + 4 * sub;
      const int64_t e = b[k] < end[k] ? b[k] + 1 : end[k];
      cnt[k] = 0;
      x[k][0] = x[k][1] = x[k][2] = x[k][3] = 0;
      if (mode[k] == 1 && j0[k] < e) {
        load_chunk<kVecLo>(lo_arr, j0[k], e, x[k]);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int64_t p = j0[k] + t;
          cnt[k] += p >= a[k] && p < b[k] && x[k][t] < lc[k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      cnt[k] += __shfl_xor_sync(kFull, cnt[k], 1);
      cnt[k] += __shfl_xor_sync(kFull, cnt[k], 2);
      cnt[k] += __shfl_xor_sync(kFull, cnt[k], 4);
      const int32_t lb = a[k] + cnt[k];
      const int64_t t = lb - j0[k];
      const int32_t key = t == 0 ? x[k][0] : t == 1 ? x[k][1]
                          : t == 2 ? x[k][2] : x[k][3];
      const bool eq = mode[k] == 1 && lb < end[k] && t >= 0 && t < 4 &&
                      key == lc[k];
      if ((__ballot_sync(kFull, eq) >> first_lane) & 0xffu) row[k] = lb;
    }
  }
  // the payload row (lanes 0-3, one int each) and the six stores
  int32_t* const dst = sub == 0 ? fi : sub == 1 ? oi : sub == 2 ? avg_off
                       : sub == 3 ? reinterpret_cast<int32_t*>(wt) : idx;
  int32_t got[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    got[k] = w[k] < n_windows && sub < 4
                 ? __ldg(payload + 4 * static_cast<int64_t>(row[k]) + sub)
                 : 0;
  }
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    if (w[k] >= n_windows) continue;
    if (sub == 4) {
      found[w[k]] = row[k] != n;
    } else if (sub < 6) {
      dst[w[k]] = sub < 4 ? got[k] : row[k];
    }
  }
}

// The first design: one thread a window, kW windows a thread with their
// halving chains interleaved.  kFloor: no search; the payload row of
// known[w] (the window's result), its address made to depend on the
// bucket pair.
template <int kT, int kW, bool kFloor>
__global__ void __launch_bounds__(kT)
search_thread_kernel(const int32_t* __restrict__ hi,
                     const int32_t* __restrict__ lo,
                     const uint8_t* __restrict__ valid,
                     const int32_t* __restrict__ pair, int32_t n_hi,
                     const int32_t* __restrict__ lo_arr,
                     const int32_t* __restrict__ payload,
                     const int32_t* __restrict__ known, int64_t n_windows,
                     int32_t n, int32_t n_steps, uint8_t* __restrict__ found,
                     int32_t* __restrict__ fi, int32_t* __restrict__ oi,
                     int32_t* __restrict__ avg_off, float* __restrict__ wt,
                     int32_t* __restrict__ idx) {
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kT * kW + threadIdx.x;
  int64_t w[kW];
  int32_t lc[kW], left[kW], right[kW], end[kW], row[kW];
  bool live[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    w[k] = w0 + static_cast<int64_t>(k) * kT;
    live[k] = false;
    lc[k] = left[k] = right[k] = end[k] = 0;
    row[k] = n;
    if (w[k] < n_windows) {
      const int32_t h = __ldg(hi + w[k]);
      lc[k] = __ldg(lo + w[k]);
      if (valid[w[k]] != 0 && h >= 0 && h < n_hi) {
        left[k] = __ldg(pair + 2 * static_cast<int64_t>(h));
        end[k] = __ldg(pair + 2 * static_cast<int64_t>(h) + 1);
        right[k] = end[k];
        live[k] = true;
      }
      if (kFloor) {
        // a start above n never occurs: the row waits for the pair
        row[k] = __ldg(known + w[k]) + (left[k] > n ? 1 : 0);
      }
    }
  }
  if (!kFloor) {
    for (int32_t s = 0; s < n_steps; ++s) {
      bool more = false;
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        if (live[k] && left[k] < right[k]) {
          const int32_t mid = left[k] + ((right[k] - left[k]) >> 1);
          if (__ldg(lo_arr + (mid < n ? mid : n)) < lc[k]) {
            left[k] = mid + 1;
          } else {
            right[k] = mid;
          }
          more = true;
        }
      }
      if (!more) break;
    }
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const int32_t at = left[k] < n ? left[k] : n;
      if (live[k] && left[k] < end[k] && __ldg(lo_arr + at) == lc[k]) {
        row[k] = at;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    if (w[k] >= n_windows) continue;
    const int4 q = __ldg(reinterpret_cast<const int4*>(payload) + row[k]);
    found[w[k]] = row[k] != n;
    fi[w[k]] = q.x;
    oi[w[k]] = q.y;
    avg_off[w[k]] = q.z;
    wt[w[k]] = __int_as_float(q.w);
    idx[w[k]] = row[k];
  }
}

// Each launch returns cudaErrorInvalidValue where the grid would pass
// 2^31 - 1 blocks (~1.4e11 windows, more than a card holds).
template <int kW, int kP>
int launch_quarter(const void* hi, const void* lo, const void* valid,
                   const void* pair, int32_t n_hi, const void* lo_arr,
                   const void* payload, int64_t n_windows, int32_t n,
                   int32_t n_steps, void* found, void* fi, void* oi,
                   void* avg_off, void* wt, void* idx, cudaStream_t stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads / 8) * kW;
  const int64_t want = (n_windows + per_block - 1) / per_block;
  if (want >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  const bool vec_pair = reinterpret_cast<uintptr_t>(pair) % 8 == 0;
  const bool vec_lo = reinterpret_cast<uintptr_t>(lo_arr) % 16 == 0;
  auto kernel =
      vec_pair ? (vec_lo ? quarter_kernel<kW, kP, true, true>
                         : quarter_kernel<kW, kP, true, false>)
               : (vec_lo ? quarter_kernel<kW, kP, false, true>
                         : quarter_kernel<kW, kP, false, false>);
  kernel<<<static_cast<unsigned>(want), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(pair),
      n_hi, static_cast<const int32_t*>(lo_arr),
      static_cast<const int32_t*>(payload), n_windows, n, n_steps,
      static_cast<uint8_t*>(found), static_cast<int32_t*>(fi),
      static_cast<int32_t*>(oi), static_cast<int32_t*>(avg_off),
      static_cast<float*>(wt), static_cast<int32_t*>(idx));
  return cudaGetLastError();
}

template <int kT, int kW, bool kFloor>
int launch_thread(const void* hi, const void* lo, const void* valid,
                  const void* pair, int32_t n_hi, const void* lo_arr,
                  const void* payload, const void* known, int64_t n_windows,
                  int32_t n, int32_t n_steps, void* found, void* fi,
                  void* oi, void* avg_off, void* wt, void* idx,
                  cudaStream_t stream) {
  const int64_t want = (n_windows + kT * kW - 1) / (kT * kW);
  if (want >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  search_thread_kernel<kT, kW, kFloor>
      <<<static_cast<unsigned>(want), kT, 0, stream>>>(
          static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo),
          static_cast<const uint8_t*>(valid),
          static_cast<const int32_t*>(pair), n_hi,
          static_cast<const int32_t*>(lo_arr),
          static_cast<const int32_t*>(payload),
          static_cast<const int32_t*>(known), n_windows, n, n_steps,
          static_cast<uint8_t*>(found), static_cast<int32_t*>(fi),
          static_cast<int32_t*>(oi), static_cast<int32_t*>(avg_off),
          static_cast<float*>(wt), static_cast<int32_t*>(idx));
  return cudaGetLastError();
}

}  // namespace

extern "C" int ck_probe_search(const void* hi, const void* lo,
                               const void* valid, const void* rows,
                               int32_t n_hi, const void* lo_arr,
                               const void* payload, int64_t n_windows,
                               int32_t n, int32_t n_steps, void* found,
                               void* fi, void* oi, void* avg_off, void* wt,
                               void* idx, void* stream) {
  if (n_windows <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t want = (n_windows + kThreads - 1) / kThreads;
  if (want >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  // 16-B row and payload loads where both tables start 16-B aligned, 16-B
  // lo loads where lo_arr does
  const bool vec = reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(payload) % 16 == 0;
  const bool vec_lo = reinterpret_cast<uintptr_t>(lo_arr) % 16 == 0;
  auto kernel = vec ? (vec_lo ? row_search_kernel<true, true>
                              : row_search_kernel<true, false>)
                    : (vec_lo ? row_search_kernel<false, true>
                              : row_search_kernel<false, false>);
  kernel<<<static_cast<unsigned>(want), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(rows),
      n_hi, static_cast<const int32_t*>(lo_arr),
      static_cast<const int32_t*>(payload), n_windows, n, n_steps,
      static_cast<uint8_t*>(found), static_cast<int32_t*>(fi),
      static_cast<int32_t*>(oi), static_cast<int32_t*>(avg_off),
      static_cast<float*>(wt), static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}

// Variant v of the experiments above on bucket_pair (known: each window's
// result row, read by variant 0 alone); the payload must start 16-B
// aligned for variants 0-6.  Returns cudaErrorInvalidValue for an unknown
// variant.
extern "C" int ck_probe_search_exp(int32_t variant, const void* hi,
                                   const void* lo, const void* valid,
                                   const void* pair, int32_t n_hi,
                                   const void* lo_arr, const void* payload,
                                   const void* known, int64_t n_windows,
                                   int32_t n, int32_t n_steps, void* found,
                                   void* fi, void* oi, void* avg_off,
                                   void* wt, void* idx, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_windows <= 0) return static_cast<int>(cudaGetLastError());
#define CK_THREAD(T, W, F)                                              \
  return launch_thread<T, W, F>(hi, lo, valid, pair, n_hi, lo_arr,      \
                                payload, known, n_windows, n, n_steps,  \
                                found, fi, oi, avg_off, wt, idx, s)
#define CK_QUARTER(W, P)                                                \
  return launch_quarter<W, P>(hi, lo, valid, pair, n_hi, lo_arr,        \
                              payload, n_windows, n, n_steps, found, fi, \
                              oi, avg_off, wt, idx, s)
  switch (variant) {
    case 0: CK_THREAD(256, 1, true);
    case 1: CK_THREAD(128, 1, false);
    case 2: CK_THREAD(256, 1, false);
    case 3: CK_THREAD(512, 1, false);
    case 4: CK_THREAD(256, 2, false);
    case 5: CK_THREAD(256, 3, false);
    case 6: CK_THREAD(256, 4, false);
    case 7: CK_QUARTER(1, 8);
    case 8: CK_QUARTER(2, 8);
    case 9: CK_QUARTER(4, 8);
    case 10: CK_QUARTER(2, 1);
    case 11: CK_QUARTER(2, 3);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CK_THREAD
#undef CK_QUARTER
}
