// The gather_hits run/gap/two-hit scoring state machine (kguts.cc:734-877).
//
// Replaces close_kmers_tpu/ops/pallas_scan.py::scan_score_pallas
// (_scan_kernel) and, on the card, the lax.scan of
// core/device_score.py::_scan_score_core, including its chained-tile
// arguments: `init` (13-field carry to resume from), `pos0` (global
// position of column 0), `final_flush` (which rows flush at the end) and
// `want_emit`.
//
// Design.  The machine is sequential over the W window positions of a
// sequence and independent across sequences, so one thread owns one
// sequence and keeps its 13-field state in registers for the whole loop.
// Everything around the machine is arranged so that it never waits for
// device memory and never spends its own instruction slots on it:
//
// * A block owns kRows = 32 consecutive sequences (B = 4096 gives 128
//   blocks for the 132 SMs) and has two warps: warp 0 runs the machine,
//   one sequence per lane; warp 1 (the mover) only moves data.  The
//   kernel reads the inputs in their [B, W] row-major layout (found as
//   bytes, fi, avg_off, wt) and writes emit and the five call planes
//   straight into [B, W + 1]: no transposes around the launch.
// * The inputs go through shared memory in tiles of kTile = 32 positions
//   of the block's 32 rows, double-buffered: while the machine runs tile
//   k, the mover's cp.async copies of tile k + 1 are in flight and it
//   stores tile k - 1's calls; one barrier per tile hands the buffers
//   over.  For each row the 32 lanes copy 32 neighbouring ints
//   (coalesced).  The found bytes are copied as the aligned 4-byte words
//   that cover each row's tile, so no alignment of W is assumed; the last
//   word of the array, if it runs past the end, is assembled byte by
//   byte.
// * Rows are padded (33 ints, 9 found words: odd strides), so the 32
//   threads reading column j of their rows hit 32 distinct banks.
// * The emitted call planes of a tile go to shared memory first (two
//   output stages) and are then stored row by row, 32 lanes on 32
//   neighbouring ints.  The end-of-sequence column W is stored by each
//   scoring thread directly.
// * The machine has no data-dependent branch (see `emits`), and the
//   position loop is unrolled by 4 so that the staged loads of the next
//   positions start early.
// * With want_emit = 0 (chained tiles of the genome path) only the state
//   is written.
//
// Bound: bytes.  Per position and sequence the kernel reads 13 B and, with
// want_emit, writes 21 B; at B = 4096, W = 304 that is ~42 MB, ~0.013 ms
// at 3.35 TB/s.  What limits this design is the machine's dependent chain:
// one warp per SM executes ~100 instructions per position, a few dozen of
// them in sequence, so 304 positions take tens of microseconds whatever
// the memory does.
//
// Exactness: `wsum + wt` and `prev2_wt + prev_wt` are single IEEE f32
// adds in the reference's order (built without fast-math; there is no
// multiply to contract into an FMA).  Integer arithmetic that the int32
// reference lets wrap is done in unsigned.  The drift test is signed
// int32, 0 <= drift <= 20, and the emit test is wsum >= (float)min_wt.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 8;
constexpr int kRows = 32;            // sequences per block (one warp)
constexpr int kThreads = 2 * kRows;  // the scoring warp and the mover
constexpr int kTile = 32;            // positions per staged tile
constexpr int kStride = kTile + 1;   // padded row of a staged int plane
constexpr int kFoundWords = kTile / 4 + 1;   // 9: odd, and covers any
                                             // alignment of a row's tile

// Field order of the packed state arrays: ints [10][B], floats [3][B].
enum { kNumHits, kCurrent, kFirstPos, kPrevFi, kPrevPos, kPrevAv, kPrev2Fi,
       kPrev2Pos, kCnt, kLastMatch, kIntFields };
enum { kPrevWt, kPrev2Wt, kWsum, kFloatFields };

// Shared memory: two input stages and two output stages.
struct InStage {
  int32_t fi[kRows * kStride];
  int32_t av[kRows * kStride];
  float wt[kRows * kStride];
  uint32_t found[kRows * kFoundWords];
};
struct OutStage {
  int32_t start[kRows * kStride];
  int32_t end[kRows * kStride];
  int32_t cnt[kRows * kStride];
  int32_t fi[kRows * kStride];
  float wt[kRows * kStride];
  uint8_t emit[kRows * kStride];
};
struct Smem {
  InStage in[2];
  OutStage out[2];
};

struct State {
  int32_t num_hits, current, first_pos, prev_fi, prev_pos, prev_av;
  int32_t prev2_fi, prev2_pos, cnt, last_match;
  float prev_wt, prev2_wt, wsum;
};

struct Call {
  int32_t start, end, cnt, fi;
  float wt;
};

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Emission test and call fields of process_set_of_hits (kguts.cc:752-755).
// The machine is written without data-dependent branches (bitwise & on
// bools, selects for every update): the 32 sequences of a warp take
// different paths at every step, and divergent branches would serialise
// them.
__device__ __forceinline__ bool emits(const State& s, int32_t min_hits,
                                      float min_wt) {
  return (s.num_hits > 0) & (s.cnt >= min_hits) & (s.wsum >= min_wt);
}

__device__ __forceinline__ Call call_of(const State& s) {
  return Call{s.first_pos, wrap_add(s.last_match, K - 1), s.cnt, s.current,
              s.wsum};
}

// State transition of process_set_of_hits where it fires: reseed from the
// last two buffered hits, or clear (kguts.cc:772-780).  The reseed sum is
// formed whether or not it is taken: one IEEE add, no side effects.
__device__ __forceinline__ void apply_flush(State& s, bool fire) {
  const bool reseed = fire & (s.num_hits >= 2) & (s.prev2_fi != s.current) &
                      (s.prev2_fi == s.prev_fi);
  const bool clear = fire & !reseed;
  const float reseed_wt = s.prev2_wt + s.prev_wt;
  s.current = reseed ? s.prev_fi : s.current;
  s.num_hits = reseed ? 2 : (clear ? 0 : s.num_hits);
  s.cnt = reseed ? 2 : (clear ? 0 : s.cnt);
  s.wsum = reseed ? reseed_wt : (clear ? 0.0f : s.wsum);
  s.first_pos = reseed ? s.prev2_pos : s.first_pos;
  s.last_match = reseed ? s.prev_pos : s.last_match;
}

// Starts the copies of tile [t0, t0 + cols) of the block's rows into
// `st`.  `rows` rows of the block exist (the last block may hold fewer).
__device__ __forceinline__ void load_tile(
    InStage& st, const uint8_t* __restrict__ found,
    const int32_t* __restrict__ fi, const int32_t* __restrict__ av,
    const float* __restrict__ wt, int64_t b0, int32_t rows, int32_t W,
    int32_t t0, int32_t cols, int64_t found_bytes, int lane) {
  if (lane < cols) {
    for (int r = 0; r < rows; ++r) {
      const int64_t g = (b0 + r) * W + t0 + lane;
      cp_async4(&st.fi[r * kStride + lane], fi + g);
      cp_async4(&st.av[r * kStride + lane], av + g);
      cp_async4(&st.wt[r * kStride + lane], wt + g);
    }
  }
  // found: the aligned words over bytes [s, s + cols) of each row
  for (int i = lane; i < rows * kFoundWords; i += kRows) {
    const int r = i / kFoundWords;
    const int wj = i - r * kFoundWords;
    const int64_t s = (b0 + r) * W + t0;
    const int64_t w0 = s >> 2;
    if (wj > (((s + cols - 1) >> 2) - w0)) continue;
    const int64_t word = w0 + wj;
    uint32_t* dst = &st.found[r * kFoundWords + wj];
    if ((word + 1) * 4 <= found_bytes) {
      cp_async4(dst, found + word * 4);
    } else {   // the array's last word runs past its end
      uint32_t v = 0;
      for (int64_t b = word * 4; b < found_bytes; ++b)
        v |= static_cast<uint32_t>(found[b]) << (8 * (b - word * 4));
      *dst = v;
    }
  }
}

// Stores the staged call planes of tile [t0, t0 + cols) row by row: 32
// lanes on 32 neighbouring columns of one row.
__device__ __forceinline__ void store_tile(
    const OutStage& o, uint8_t* __restrict__ emit,
    int32_t* __restrict__ c_start, int32_t* __restrict__ c_end,
    int32_t* __restrict__ c_cnt, int32_t* __restrict__ c_fi,
    float* __restrict__ c_wt, int64_t b0, int32_t rows, int64_t Wo,
    int32_t t0, int32_t cols, int lane) {
  if (lane >= cols) return;
  for (int r = 0; r < rows; ++r) {
    const int i = r * kStride + lane;
    const int64_t g = (b0 + r) * Wo + t0 + lane;
    emit[g] = o.emit[i];
    c_start[g] = o.start[i];
    c_end[g] = o.end[i];
    c_cnt[g] = o.cnt[i];
    c_fi[g] = o.fi[i];
    c_wt[g] = o.wt[i];
  }
}

// The machine over one staged tile: `cols` positions of this thread's
// sequence, from `st`, emitting into `out` when want_emit.
__device__ __forceinline__ void run_tile(
    State& s, const InStage& st, OutStage& out, int lane, int32_t found_off,
    int32_t base, int32_t t0, int32_t cols, int32_t min_hits, float min_wt,
    int32_t max_gap, int32_t order_constraint, int32_t want_emit) {
  const uint8_t* fb =
      reinterpret_cast<const uint8_t*>(&st.found[lane * kFoundWords]) +
      found_off;
#pragma unroll 4
  for (int32_t j = 0; j < cols; ++j) {
    const int o = lane * kStride + j;
    const bool h = fb[j] != 0;
    const int32_t f = st.fi[o];
    const int32_t a = st.av[o];
    const float w = st.wt[o];
    const int32_t posb = wrap_add(base, t0 + j);

    // gap handling (kguts.cc:821-831)
    const bool gap = h & (s.num_hits > 0) &
                     (wrap_add(s.prev_pos, max_gap) < posb);
    const bool gf_flush = gap & (s.num_hits >= min_hits);
    const bool gf_reset = gap & !gf_flush;
    const bool emit_a = gf_flush & emits(s, min_hits, min_wt);
    const Call call_a = call_of(s);
    apply_flush(s, gf_flush);
    s.num_hits = gf_reset ? 0 : s.num_hits;
    s.cnt = gf_reset ? 0 : s.cnt;
    s.wsum = gf_reset ? 0.0f : s.wsum;

    // current_fI seeding (kguts.cc:833-836)
    const bool was0 = s.num_hits == 0;
    const int32_t cur = (h & was0) ? f : s.current;

    // admission (kguts.cc:838-842); order_constraint is uniform
    bool admit = h;
    if (order_constraint) {
      const int32_t drift =
          wrap_sub(wrap_sub(posb, s.prev_pos), wrap_sub(s.prev_av, a));
      admit = h & (was0 | ((f == s.prev_fi) & (drift >= 0) & (drift <= 20)));
    }

    // append (kguts.cc:844-851)
    const bool grow = admit & (f == cur);
    const float grown_wt = s.wsum + w;
    s.first_pos = (admit & was0) ? posb : s.first_pos;
    s.cnt = grow ? s.cnt + 1 : s.cnt;
    s.wsum = grow ? grown_wt : s.wsum;
    s.last_match = grow ? posb : s.last_match;
    s.prev2_fi = admit ? s.prev_fi : s.prev2_fi;
    s.prev2_pos = admit ? s.prev_pos : s.prev2_pos;
    s.prev2_wt = admit ? s.prev_wt : s.prev2_wt;
    s.prev_fi = admit ? f : s.prev_fi;
    s.prev_pos = admit ? posb : s.prev_pos;
    s.prev_av = admit ? a : s.prev_av;
    s.prev_wt = admit ? w : s.prev_wt;
    s.num_hits = admit ? s.num_hits + 1 : s.num_hits;
    s.current = cur;

    // two-in-a-row flush (kguts.cc:852-856)
    const bool tir =
        admit & (s.num_hits > 1) & (cur != f) & (s.prev2_fi == f);
    const bool emit_b = tir & emits(s, min_hits, min_wt);
    const Call call_b = call_of(s);
    apply_flush(s, tir);

    if (want_emit) {
      const Call& c = emit_a ? call_a : call_b;
      out.emit[o] = (emit_a | emit_b) ? 1 : 0;
      out.start[o] = c.start;
      out.end[o] = c.end;
      out.cnt[o] = c.cnt;
      out.fi[o] = c.fi;
      out.wt[o] = c.wt;
    }
  }
}

__device__ __forceinline__ int32_t tile_cols(int32_t W, int32_t k) {
  const int32_t left = W - k * kTile;
  return left < kTile ? left : kTile;
}

__global__ void __launch_bounds__(kThreads) scan_score_kernel(
    const uint8_t* __restrict__ found, const int32_t* __restrict__ fi,
    const int32_t* __restrict__ av, const float* __restrict__ wt, int32_t B,
    int32_t W, const int32_t* __restrict__ init_i,
    const float* __restrict__ init_f, const int32_t* __restrict__ pos0,
    const uint8_t* __restrict__ final_flush, int32_t min_hits,
    int32_t min_weighted_hits, int32_t max_gap, int32_t order_constraint,
    int32_t want_emit, uint8_t* __restrict__ emit,
    int32_t* __restrict__ c_start, int32_t* __restrict__ c_end,
    int32_t* __restrict__ c_cnt, int32_t* __restrict__ c_fi,
    float* __restrict__ c_wt, int32_t* __restrict__ out_i,
    float* __restrict__ out_f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const bool mover = threadIdx.x >= kRows;      // warp 1; warp 0 scores
  const int lane = threadIdx.x & (kRows - 1);
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int32_t rows =
      static_cast<int32_t>(B - b0 < kRows ? B - b0 : kRows);
  const bool live = !mover && lane < rows;
  const int64_t b = b0 + lane;
  const int64_t found_bytes = static_cast<int64_t>(B) * W;
  const int64_t Wo = static_cast<int64_t>(W) + 1;   // output row length
  const int32_t n_tiles = (W + kTile - 1) / kTile;

  State s{};
  if (live && init_i != nullptr) {
    s.num_hits = init_i[kNumHits * B + b];
    s.current = init_i[kCurrent * B + b];
    s.first_pos = init_i[kFirstPos * B + b];
    s.prev_fi = init_i[kPrevFi * B + b];
    s.prev_pos = init_i[kPrevPos * B + b];
    s.prev_av = init_i[kPrevAv * B + b];
    s.prev2_fi = init_i[kPrev2Fi * B + b];
    s.prev2_pos = init_i[kPrev2Pos * B + b];
    s.cnt = init_i[kCnt * B + b];
    s.last_match = init_i[kLastMatch * B + b];
    s.prev_wt = init_f[kPrevWt * B + b];
    s.prev2_wt = init_f[kPrev2Wt * B + b];
    s.wsum = init_f[kWsum * B + b];
  }
  const int32_t base = (live && pos0 != nullptr) ? pos0[b] : 0;
  const float min_wt = static_cast<float>(min_weighted_hits);
  // byte offset of this row's tiles inside their first staged word
  const int32_t found_off = static_cast<int32_t>((b * W) & 3);

  if (mover && n_tiles > 0) {
    load_tile(sm.in[0], found, fi, av, wt, b0, rows, W, 0, tile_cols(W, 0),
              found_bytes, lane);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  // Step k: the scoring warp runs tile k; the mover fetches tile k + 1 and
  // stores tile k - 1's calls.  One barrier per step hands the buffers
  // over: inputs alternate between in[0] and in[1], outputs between
  // out[0] and out[1].
  for (int32_t k = 0; k <= n_tiles; ++k) {
    if (mover) {
      if (k + 1 < n_tiles) {
        load_tile(sm.in[(k + 1) & 1], found, fi, av, wt, b0, rows, W,
                  (k + 1) * kTile, tile_cols(W, k + 1), found_bytes, lane);
        cp_async_commit();
      }
      if (want_emit && k >= 1) {
        store_tile(sm.out[(k - 1) & 1], emit, c_start, c_end, c_cnt, c_fi,
                   c_wt, b0, rows, Wo, (k - 1) * kTile, tile_cols(W, k - 1),
                   lane);
      }
      cp_async_wait<0>();
    } else if (live && k < n_tiles) {
      run_tile(s, sm.in[k & 1], sm.out[k & 1], lane, found_off, base,
               k * kTile, tile_cols(W, k), min_hits, min_wt, max_gap,
               order_constraint, want_emit);
    }
    __syncthreads();
  }

  if (!live) return;
  if (want_emit) {
    // end-of-sequence flush (kguts.cc:873-875)
    const bool flush = final_flush == nullptr || final_flush[b] != 0;
    const bool emit_f = emits(s, min_hits, min_wt) &
                        (s.num_hits >= min_hits) & flush;
    const Call c = call_of(s);
    const int64_t g = b * Wo + W;
    emit[g] = emit_f ? 1 : 0;
    c_start[g] = c.start;
    c_end[g] = c.end;
    c_cnt[g] = c.cnt;
    c_fi[g] = c.fi;
    c_wt[g] = c.wt;
  }

  out_i[kNumHits * B + b] = s.num_hits;
  out_i[kCurrent * B + b] = s.current;
  out_i[kFirstPos * B + b] = s.first_pos;
  out_i[kPrevFi * B + b] = s.prev_fi;
  out_i[kPrevPos * B + b] = s.prev_pos;
  out_i[kPrevAv * B + b] = s.prev_av;
  out_i[kPrev2Fi * B + b] = s.prev2_fi;
  out_i[kPrev2Pos * B + b] = s.prev2_pos;
  out_i[kCnt * B + b] = s.cnt;
  out_i[kLastMatch * B + b] = s.last_match;
  out_f[kPrevWt * B + b] = s.prev_wt;
  out_f[kPrev2Wt * B + b] = s.prev2_wt;
  out_f[kWsum * B + b] = s.wsum;
}

}  // namespace

extern "C" int ck_scan_score(
    const void* found, const void* fi, const void* av, const void* wt,
    int32_t B, int32_t W, const void* init_i, const void* init_f,
    const void* pos0, const void* final_flush, int32_t min_hits,
    int32_t min_weighted_hits, int32_t max_gap, int32_t order_constraint,
    int32_t want_emit, void* emit, void* c_start, void* c_end, void* c_cnt,
    void* c_fi, void* c_wt, void* out_i, void* out_f, void* stream) {
  // cp.async copies found as 4-byte words: its base must be aligned
  if (reinterpret_cast<uintptr_t>(found) & 3)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (B > 0) {
    constexpr int kSmem = static_cast<int>(sizeof(Smem));
    cudaError_t err = cudaFuncSetAttribute(
        scan_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (B + kRows - 1) / kRows;
    scan_score_kernel<<<blocks, kThreads, kSmem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(found), static_cast<const int32_t*>(fi),
        static_cast<const int32_t*>(av), static_cast<const float*>(wt), B, W,
        static_cast<const int32_t*>(init_i), static_cast<const float*>(init_f),
        static_cast<const int32_t*>(pos0),
        static_cast<const uint8_t*>(final_flush), min_hits, min_weighted_hits,
        max_gap, order_constraint, want_emit, static_cast<uint8_t*>(emit),
        static_cast<int32_t*>(c_start), static_cast<int32_t*>(c_end),
        static_cast<int32_t*>(c_cnt), static_cast<int32_t*>(c_fi),
        static_cast<float*>(c_wt), static_cast<int32_t*>(out_i),
        static_cast<float*>(out_f));
  }
  return static_cast<int>(cudaGetLastError());
}
