// find_best_call's reductions over each row's emitted CALLs (kguts.cc:
// 1008-1152): left-pack the row's calls (at most CAPC = 32; a row with more
// is flagged and reduced over its first 32), collapse adjacent same-function
// calls, bridge-merge F1|F2|F1, per-function totals in ascending function
// order, and the literal libstdc++ partial_sort(first, first + 2) heap with
// the element it displaces into slot 2.
//
// Replaces close_kmers_tpu/core/device_score.py::_best_call_device (XLA:
// two argsort left-packs, a stable sort and four lax.scans over the packed
// stream), which _probe_best_jit runs on the scan's [B, W+1] outputs.
//
// Bound: bytes, and below them the launch.  Per row it reads the emit
// bytes until its 33rd call (all W+1 of them on a row with at most 32
// calls), 12 B for each of the first 32 calls, and writes 36 B.  At the
// query cell's 4096 x 305 with ~1 call a row that is ~1.4 MB, ~0.0004 ms
// at 3.35 TB/s: far below what any launch costs, so the kernel's time is
// its launch plus the longest chain of dependent steps of one row.
//
// What held the first design back: its left-pack read a row 32 bytes a
// round, one byte a lane, and stopped once more than 32 calls were seen.
// The stop made each round's load wait for the previous round's ballot,
// so a row of at most 32 calls (nearly every row) walked its W+1 bytes as
// ceil((W+1)/32) dependent device-memory round trips: 10 at W+1 = 305.
//
// Design: one warp per row, eight rows a block (4096 rows are 512 blocks of
// 256 threads: one wave on 132 SMs).  A row costs two dependent round
// trips, one for its emit bytes and one for its calls' fields; the batch
// waits for its slowest row, one of 2 or more calls when there is one (the
// scalar reductions below).  On an H100 (700 W) this took the query cell's
// launch from 0.0118 to 0.0087-0.0090 ms with the L2 flushed, where a
// one-element fill_ takes 0.0058-0.0081 (chip_smoke.py, PERF.md).
//  * Left-pack in one round: lane l loads the l-th 16-B aligned word that
//    covers the row, so the warp's loads span 512 B at once and every row
//    of up to 497 bytes comes in one load a lane, whatever the alignment
//    of its start (the scan's emit rows are W+1 bytes apart).  Bytes outside
//    [row start, row start + M) are masked; an aligned word holding one
//    byte of the row lies in a mapped page.  Each lane makes a 16-bit mask
//    of its nonzero bytes in the row, a shuffle scan of their counts gives
//    the slot of its first call, and it writes its calls' columns to the
//    slots below 32.  Longer rows loop, the next
//    512 B requested before this round's are counted; the walk stops once
//    more than 32 calls are seen, which is all the overflow flag needs.
//  * Gather: lane k reads call k's count, function and weight.
//  * A row of 0 or 1 call (nearly every row of the query cell) writes its
//    pack at once: the reductions below pass a single call through
//    unchanged (no add, so a -0.0 weight stays -0.0), and drop it when its
//    function reaches the totals' sort key of no entry (2^30).
//  * The reductions are sequential control flow with data-dependent
//    branches over at most 32 entries, so every lane of the warp runs the
//    same scalar state machines in lock step, reading the entries from
//    shared memory by broadcast (no divergence, no bank conflicts); lane 0
//    writes each intermediate list.  The totals need a sort that is stable
//    on the function alone (its order fixes each total's f32 adds): lane k
//    takes entry k's rank, the entries before it with a smaller function
//    or an equal one earlier in the list, and stores it there.
//  * Every f32 sum is one add at a time in the reference's order (no fast
//    math, nothing to contract), and the heap's comparisons are the strict
//    ">" of the reference, so the [B, 9] pack equals the XLA one bit for
//    bit, -0.0 and +0.0 apart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCapc = 32;             // call stream cap (device_score.py:239)
constexpr int kRowsPerBlock = 8;
constexpr int32_t kBig = 1 << 30;     // the totals' sort key of no entry
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWord = 16;             // bytes of one lane's emit load
constexpr int kReach = 32 * kWord;    // bytes of one round of a warp's loads

// The aligned 16-B word at `a` (all zero from the row's end on).
__device__ __forceinline__ uint4 row_word(uintptr_t a, uintptr_t end) {
  return a < end ? __ldg(reinterpret_cast<const uint4*>(a))
                 : make_uint4(0u, 0u, 0u, 0u);
}

// Bit j set where byte j of the 16-B word `w` is not 0.
__device__ __forceinline__ uint32_t nonzero_bytes(uint4 w) {
  const uint32_t x[4] = {w.x, w.y, w.z, w.w};
  uint32_t m = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    uint32_t t = x[u] | (x[u] >> 4);
    t |= t >> 2;
    t |= t >> 1;
    // bit 8j of t is set where byte j is not 0; the product gathers the
    // four into bits 28-31
    m |= (((t & 0x01010101u) * 0x10204080u) >> 28) << (4 * u);
  }
  return m;
}

struct Entry {
  int32_t fi;
  int32_t cnt;
  float wt;
};

// Per-warp shared lists: the packed calls, then the bridge's output, then
// the same output sorted by function.
struct WarpLists {
  int32_t col[kCapc];
  Entry calls[kCapc];
  Entry merged[kCapc];
  Entry sorted[kCapc];
};

// The bridge-merge state machine (kguts.cc:1063-1086): the current entry C
// and the held interior H.  A third entry of C's function merges into C when
// H is small (count < 5) and the two sides together reach 10, discarding H.
struct Bridge {
  bool have_c = false, have_h = false;
  Entry c{0, 0, 0.f}, h{0, 0, 0.f};
  int n_out = 0;

  __device__ void emit(Entry e, Entry* out, int lane) {
    if (lane == 0) out[n_out] = e;
    ++n_out;
  }

  __device__ void push(Entry x, Entry* out, int lane) {
    if (!have_c) {
      c = x;
      have_c = true;
    } else if (!have_h) {
      h = x;
      have_h = true;
    } else if (x.fi == c.fi && h.cnt < 5 && c.cnt + x.cnt >= 10) {
      c.cnt += x.cnt;
      c.wt += x.wt;
      have_h = false;
    } else {
      emit(c, out, lane);
      c = h;
      h = x;
    }
  }

  __device__ void finish(Entry* out, int lane) {
    if (have_c) emit(c, out, lane);
    if (have_h) emit(h, out, lane);
  }
};

// The literal libstdc++ heap select over the totals stream (comp(a, b) :=
// a.wt > b.wt; j counts the entries seen): device_score.py:352-404.
struct Heap {
  int32_t j = 0, v2c = 0;
  Entry h0{0, 0, 0.f}, h1{0, 0, 0.f};

  __device__ void push(Entry e) {
    if (j == 0) {
      h0 = e;
    } else if (j == 1) {          // make_heap([e0, e1])
      if (e.wt > h0.wt) {
        h1 = e;
      } else {
        h1 = h0;
        h0 = e;
      }
    } else {                      // j >= 2: pop_push when comp(e, h0)
      const bool in = e.wt > h0.wt;
      if (j == 2) v2c = in ? h0.cnt : e.cnt;   // the value left in vec[2]
      if (in) {
        if (h1.wt > e.wt) {
          h0 = e;
        } else {
          h0 = h1;
          h1 = e;
        }
      }
    }
    ++j;
  }
};

__global__ void __launch_bounds__(kRowsPerBlock * 32)
best_call_kernel(const uint8_t* __restrict__ emit, int64_t emit_rs,
                 const int32_t* __restrict__ c_cnt, int64_t cnt_rs,
                 const int32_t* __restrict__ c_fi, int64_t fi_rs,
                 const float* __restrict__ c_wt, int64_t wt_rs, int32_t B,
                 int32_t M, int32_t* __restrict__ out) {
  __shared__ WarpLists lists[kRowsPerBlock];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + warp;
  if (row >= B) return;                     // the whole warp leaves together
  WarpLists& L = lists[warp];

  // left-pack the first kCapc emitted columns; n counts the calls seen.
  // Lane l holds the word at a: columns off .. off + 15 of the row.
  const uintptr_t s = reinterpret_cast<uintptr_t>(emit + row * emit_rs);
  const uintptr_t end = s + static_cast<uintptr_t>(M);
  uintptr_t a = (s & ~static_cast<uintptr_t>(kWord - 1)) + lane * kWord;
  uint4 w = row_word(a, end);
  int n = 0;
  for (uintptr_t g = a - lane * kWord; g < end; g += kReach, a += kReach) {
    const uint4 next = row_word(a + kReach, end);   // in flight meanwhile
    const int off = static_cast<int>(static_cast<int64_t>(a) -
                                     static_cast<int64_t>(s));
    const int lo = min(max(-off, 0), kWord);      // the row's bytes in
    const int hi = min(max(M - off, 0), kWord);   // the word: [lo, hi)
    uint32_t m = nonzero_bytes(w) & ((1u << hi) - (1u << lo));
    const int cnt = __popc(m);
    int incl = cnt;   // calls of lanes 0..lane this round
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    for (int k = n + incl - cnt; m != 0 && k < kCapc; m &= m - 1, ++k)
      L.col[k] = off + __ffs(m) - 1;
    n += __shfl_sync(kFull, incl, 31);
    if (n > kCapc) break;
    w = next;
  }
  __syncwarp();
  const int np = n < kCapc ? n : kCapc;
  Entry mine{0, 0, 0.f};
  if (lane < np) {
    const int c = L.col[lane];
    mine = Entry{c_fi[row * fi_rs + c], c_cnt[row * cnt_rs + c],
                 c_wt[row * wt_rs + c]};
  }
  if (np <= 1) {
    // 0 or 1 call: the reductions below would pass it through unchanged
    const int32_t fi = __shfl_sync(kFull, mine.fi, 0);
    const int32_t cnt = __shfl_sync(kFull, mine.cnt, 0);
    const int32_t wt = __shfl_sync(kFull, __float_as_int(mine.wt), 0);
    const bool one = np == 1 && fi < kBig;
    int32_t v = 0;
    switch (lane) {
      case 0: v = one; break;
      case 1: case 4: v = one ? fi : 0; break;
      case 2: case 5: v = one ? cnt : 0; break;
      case 3: case 6: v = one ? wt : 0; break;
      default: break;      // v2c and the overflow flag are 0
    }
    if (lane < 9) out[row * 9 + lane] = v;
    return;
  }
  if (lane < np) L.calls[lane] = mine;
  __syncwarp();

  // collapse adjacent same-function calls (kguts.cc:1023-1040), each group
  // fed to the bridge as it closes
  Bridge br;
  bool have = false;
  Entry g{0, 0, 0.f};
  for (int i = 0; i < np; ++i) {
    const Entry x = L.calls[i];
    if (have && x.fi == g.fi) {
      g.cnt += x.cnt;
      g.wt += x.wt;
    } else {
      if (have) br.push(g, L.merged, lane);
      g = x;
      have = true;
    }
  }
  if (have) br.push(g, L.merged, lane);
  br.finish(L.merged, lane);
  __syncwarp();

  // stable sort by function: lane k places entry k at its rank.  An entry
  // whose function reaches the sort key of no entry (2^30) is dropped, as
  // the reference's totals drop it.
  const int nm = br.n_out;
  int ns = 0;
  {
    const Entry mine = lane < nm ? L.merged[lane] : Entry{kBig, 0, 0.f};
    int rank = 0;
    for (int i = 0; i < nm; ++i) {
      const int32_t f = L.merged[i].fi;
      rank += (f < mine.fi) || (f == mine.fi && i < lane);
      ns += f < kBig;
    }
    __syncwarp();
    if (lane < nm && mine.fi < kBig) L.sorted[rank] = mine;
  }
  __syncwarp();

  // per-function totals in ascending function order, each fed to the heap
  // as its run ends
  Heap hp;
  bool th = false;
  Entry t{0, 0, 0.f};
  for (int i = 0; i < ns; ++i) {
    const Entry x = L.sorted[i];
    if (th && x.fi == t.fi) {
      t.cnt += x.cnt;
      t.wt += x.wt;
    } else {
      if (th) hp.push(t);
      t = x;
      th = true;
    }
  }
  if (th) hp.push(t);

  // sort_heap's swap: vec0 = slot 1, vec1 = slot 0 (one function: slot 0)
  const bool one = hp.j == 1;
  const Entry first = one ? hp.h0 : hp.h1;
  int32_t v = 0;
  switch (lane) {
    case 0: v = hp.j; break;
    case 1: v = first.fi; break;
    case 2: v = first.cnt; break;
    case 3: v = __float_as_int(first.wt); break;
    case 4: v = hp.h0.fi; break;
    case 5: v = hp.h0.cnt; break;
    case 6: v = __float_as_int(hp.h0.wt); break;
    case 7: v = hp.v2c; break;
    case 8: v = n > kCapc; break;
    default: break;
  }
  if (lane < 9) out[row * 9 + lane] = v;
}

}  // namespace

extern "C" int ck_best_call_device(const void* emit, int64_t emit_rs,
                                   const void* c_cnt, int64_t cnt_rs,
                                   const void* c_fi, int64_t fi_rs,
                                   const void* c_wt, int64_t wt_rs, int32_t B,
                                   int32_t M, void* out, void* stream) {
  if (B > 0) {
    const unsigned blocks =
        static_cast<unsigned>((B + kRowsPerBlock - 1) / kRowsPerBlock);
    best_call_kernel<<<blocks, kRowsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(emit), emit_rs,
        static_cast<const int32_t*>(c_cnt), cnt_rs,
        static_cast<const int32_t*>(c_fi), fi_rs,
        static_cast<const float*>(c_wt), wt_rs, B, M,
        static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
