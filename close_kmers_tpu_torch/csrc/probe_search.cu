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
// miss values those of payload row n and idx = n.
//
// Semantics, bit for bit those of the plain version: an invalid window
// searches bucket 0 for lo = -2 (it finds nothing); each step with left <
// right halves [left, right) at mid = (left + right) >> 1 in int32
// (wrapping, as torch's int32 add does), reading lo_arr[min(mid, n)]; a
// step with left >= right changes nothing, so the loop stops there, and
// it never runs past n_steps (a table carried over with a smaller
// n_steps ends its search early, as the plain version does).  Then idx =
// min(left, n) and found = valid & left < end & lo_arr[idx] == lo.  A
// valid window whose hi lies outside [0, n_hi) reads no bucket and
// misses (the plain version raises there).  bucket_pair entries must lie
// in [0, n].
//
// Bound: bytes.  A window reads its 9 B of inputs, its 8-B bucket pair,
// the 32-B sectors of lo_arr its lower bound touches (about log2(bucket
// / 8) + 1 distinct ones: the last halvings stay inside one sector) and
// its 16-B payload row, and writes 21 B.  What holds it back is latency:
// the search is a chain of dependent loads, one a step.
//
// Design: one thread per window, 256 a block.  With up to 2,048 threads
// an SM, ~270,000 windows' chains are in flight on 132 SMs, each a chain
// of one bucket-pair load, ~log2(bucket) lo loads and one payload load;
// the windows of a batch are independent, so the card overlaps their
// chains.  A quarter-warp k-ary search that reads 16 B a lane a round
// would cut each chain to a few rounds; that is a later design.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// torch's indexing of a tensor of `len` rows: a negative index counts
// from the end.
__device__ __forceinline__ int64_t wrap(int64_t i, int64_t len) {
  return i < 0 ? i + len : i;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
probe_search_kernel(const int32_t* __restrict__ hi,
                    const int32_t* __restrict__ lo,
                    const uint8_t* __restrict__ valid,
                    const int32_t* __restrict__ pair, int32_t n_hi,
                    const int32_t* __restrict__ lo_arr,
                    const int32_t* __restrict__ payload, int64_t n_windows,
                    int32_t n, int32_t n_steps, uint8_t* __restrict__ found,
                    int32_t* __restrict__ fi, int32_t* __restrict__ oi,
                    int32_t* __restrict__ avg_off, float* __restrict__ wt,
                    int32_t* __restrict__ idx) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t n_lo = static_cast<int64_t>(n) + 1;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       w < n_windows; w += stride) {
    const bool v = valid[w] != 0;
    const int32_t h = v ? __ldg(hi + w) : 0;
    const int32_t lc = v ? __ldg(lo + w) : -2;
    bool hit = false;
    int32_t row = n;
    if (v && h >= 0 && h < n_hi) {
      int32_t left, end;
      if (kVec) {
        const int2 p = __ldg(reinterpret_cast<const int2*>(pair) + h);
        left = p.x;
        end = p.y;
      } else {
        left = __ldg(pair + 2 * static_cast<int64_t>(h));
        end = __ldg(pair + 2 * static_cast<int64_t>(h) + 1);
      }
      int32_t right = end;
      for (int32_t s = 0; s < n_steps && left < right; ++s) {
        const int32_t mid = static_cast<int32_t>(
            static_cast<uint32_t>(left) + static_cast<uint32_t>(right)) >> 1;
        const int32_t m = mid < n ? mid : n;
        if (__ldg(lo_arr + wrap(m, n_lo)) < lc) {
          left = static_cast<int32_t>(static_cast<uint32_t>(mid) + 1u);
        } else {
          right = mid;
        }
      }
      const int32_t at = left < n ? left : n;
      if (left < end && __ldg(lo_arr + wrap(at, n_lo)) == lc) {
        hit = true;
        row = at;
      }
    }
    const int64_t r = wrap(row, n_lo);
    int32_t x0, x1, x2, x3;
    if (kVec) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(payload) + r);
      x0 = q.x;
      x1 = q.y;
      x2 = q.z;
      x3 = q.w;
    } else {
      x0 = __ldg(payload + 4 * r);
      x1 = __ldg(payload + 4 * r + 1);
      x2 = __ldg(payload + 4 * r + 2);
      x3 = __ldg(payload + 4 * r + 3);
    }
    found[w] = hit;
    fi[w] = x0;
    oi[w] = x1;
    avg_off[w] = x2;
    wt[w] = __int_as_float(x3);
    idx[w] = row;
  }
}

}  // namespace

extern "C" int ck_probe_search(const void* hi, const void* lo,
                               const void* valid, const void* pair,
                               int32_t n_hi, const void* lo_arr,
                               const void* payload, int64_t n_windows,
                               int32_t n, int32_t n_steps, void* found,
                               void* fi, void* oi, void* avg_off, void* wt,
                               void* idx, void* stream) {
  if (n_windows > 0) {
    const int64_t want = (n_windows + kThreads - 1) / kThreads;
    const unsigned blocks =
        static_cast<unsigned>(want < (1 << 30) ? want : (1 << 30));
    // 8-B pair and 16-B payload loads where both tables start aligned
    const bool vec = reinterpret_cast<uintptr_t>(pair) % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(payload) % 16 == 0;
    auto kernel = vec ? probe_search_kernel<true>
                      : probe_search_kernel<false>;
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo),
        static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(pair),
        n_hi, static_cast<const int32_t*>(lo_arr),
        static_cast<const int32_t*>(payload), n_windows, n, n_steps,
        static_cast<uint8_t*>(found), static_cast<int32_t*>(fi),
        static_cast<int32_t*>(oi), static_cast<int32_t*>(avg_off),
        static_cast<float*>(wt), static_cast<int32_t*>(idx));
  }
  return static_cast<int>(cudaGetLastError());
}
