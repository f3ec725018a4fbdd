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
// Design: one warp per row, eight rows a block.
//  * Left-pack: the warp reads the row's emit bytes 32 at a time, one byte a
//    lane (coalesced), and a ballot gives each emitted call its slot
//    (the calls before it: popc of the ballot below the lane, plus the
//    earlier chunks' count).  The first 32 slots take their column in
//    shared memory; the walk stops as soon as more than 32 calls are seen,
//    which is all the overflow flag needs.
//  * Gather: lane k reads call k's count, function and weight.
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
//
// Bound: bytes.  Per row it reads the emit bytes until its 33rd call (all
// W+1 of them on a row with at most 32 calls), 12 B for each of the first 32
// calls, and writes 36 B.  At the query cell's 4096 x 305 with ~1 call a row
// that is ~1.4 MB, ~0.0004 ms at 3.35 TB/s: far below one launch, so the
// kernel's time is its launch and one row's chain of dependent steps (the
// emit chunks read one after another, then the scalar reductions).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCapc = 32;             // call stream cap (device_score.py:239)
constexpr int kRowsPerBlock = 8;
constexpr int32_t kBig = 1 << 30;     // the totals' sort key of no entry
constexpr unsigned kFull = 0xffffffffu;

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

  // left-pack the first kCapc emitted columns; n counts the calls seen
  const uint8_t* e = emit + row * emit_rs;
  int n = 0;
  for (int c0 = 0; c0 < M && n <= kCapc; c0 += 32) {
    const int c = c0 + lane;
    const bool v = c < M && e[c] != 0;
    const unsigned bal = __ballot_sync(kFull, v);
    const int k = n + __popc(bal & ((1u << lane) - 1u));
    if (v && k < kCapc) L.col[k] = c;
    n += __popc(bal);
  }
  __syncwarp();
  const int np = n < kCapc ? n : kCapc;
  if (lane < np) {
    const int c = L.col[lane];
    L.calls[lane] = Entry{c_fi[row * fi_rs + c], c_cnt[row * cnt_rs + c],
                          c_wt[row * wt_rs + c]};
  }
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
