// The gather_hits run/gap/two-hit scoring state machine (kguts.cc:734-877).
//
// Replaces close_kmers_tpu/ops/pallas_scan.py::scan_score_pallas
// (_scan_kernel) and, on the card, the lax.scan of
// core/device_score.py::_scan_score_core, including its chained-tile
// arguments: `init` (13-field carry to resume from), `pos0` (global
// position of column 0), `final_flush` (which rows flush at the end) and
// `want_emit`.
//
// Design: the machine is sequential over the W window positions of a
// sequence and independent across sequences, so one thread owns one
// sequence and keeps its 13-field state in registers for the whole loop.
// The wrapper hands the inputs over as [W, B] and takes the outputs back
// as [W + 1, B], so at every step the threads of a warp touch
// neighbouring addresses.  Any B works (no tile multiple).
//
// Bound: bytes.  Per position and sequence the kernel reads 13 B (found,
// fi, avg_off, wt) and, with want_emit, writes 21 B (emit and five call
// fields); the state update is a few dozen integer ops.  At serving
// batches (B = 4096) only B threads exist, so few warps per SM hide the
// memory latency: the kernel is latency-bound there, not bandwidth-bound.
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
constexpr int kThreads = 64;

// Field order of the packed state arrays: ints [10][B], floats [3][B].
enum { kNumHits, kCurrent, kFirstPos, kPrevFi, kPrevPos, kPrevAv, kPrev2Fi,
       kPrev2Pos, kCnt, kLastMatch, kIntFields };
enum { kPrevWt, kPrev2Wt, kWsum, kFloatFields };

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

// Emission test and call fields of process_set_of_hits (kguts.cc:752-755).
__device__ __forceinline__ bool emits(const State& s, int32_t min_hits,
                                      float min_wt) {
  return s.num_hits > 0 && s.cnt >= min_hits && s.wsum >= min_wt;
}

__device__ __forceinline__ Call call_of(const State& s) {
  return Call{s.first_pos, wrap_add(s.last_match, K - 1), s.cnt, s.current,
              s.wsum};
}

// State transition of process_set_of_hits where it fires: reseed from the
// last two buffered hits, or clear (kguts.cc:772-780).
__device__ __forceinline__ void apply_flush(State& s, bool fire) {
  if (!fire) return;
  const bool reseed = s.num_hits >= 2 && s.prev2_fi != s.current &&
                      s.prev2_fi == s.prev_fi;
  if (reseed) {
    s.current = s.prev_fi;
    s.num_hits = 2;
    s.cnt = 2;
    s.wsum = s.prev2_wt + s.prev_wt;
    s.first_pos = s.prev2_pos;
    s.last_match = s.prev_pos;
  } else {
    s.num_hits = 0;
    s.cnt = 0;
    s.wsum = 0.0f;
  }
}

__global__ void scan_score_kernel(
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
  const int32_t b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  State s{};
  if (init_i != nullptr) {
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
  const int32_t base = pos0 != nullptr ? pos0[b] : 0;
  const float min_wt = static_cast<float>(min_weighted_hits);

  for (int32_t t = 0; t < W; ++t) {
    const int64_t o = static_cast<int64_t>(t) * B + b;
    const bool h = found[o] != 0;
    const int32_t f = fi[o];
    const int32_t a = av[o];
    const float w = wt[o];
    const int32_t posb = wrap_add(base, t);

    // gap handling (kguts.cc:821-831)
    const bool gap = h && s.num_hits > 0 && wrap_add(s.prev_pos, max_gap) < posb;
    const bool gf_flush = gap && s.num_hits >= min_hits;
    const bool gf_reset = gap && !gf_flush;
    const bool emit_a = gf_flush && emits(s, min_hits, min_wt);
    const Call call_a = call_of(s);
    apply_flush(s, gf_flush);
    if (gf_reset) {
      s.num_hits = 0;
      s.cnt = 0;
      s.wsum = 0.0f;
    }

    // current_fI seeding (kguts.cc:833-836)
    const bool was0 = s.num_hits == 0;
    const int32_t cur = (h && was0) ? f : s.current;

    // admission (kguts.cc:838-842)
    bool admit = h;
    if (order_constraint) {
      const int32_t drift =
          wrap_sub(wrap_sub(posb, s.prev_pos), wrap_sub(s.prev_av, a));
      admit = h && (was0 || (f == s.prev_fi && drift >= 0 && drift <= 20));
    }

    // append (kguts.cc:844-851)
    if (admit) {
      if (was0) s.first_pos = posb;
      if (f == cur) {
        s.cnt += 1;
        s.wsum = s.wsum + w;
        s.last_match = posb;
      }
      s.prev2_fi = s.prev_fi;
      s.prev2_pos = s.prev_pos;
      s.prev2_wt = s.prev_wt;
      s.prev_fi = f;
      s.prev_pos = posb;
      s.prev_av = a;
      s.prev_wt = w;
      s.num_hits += 1;
    }
    s.current = cur;

    // two-in-a-row flush (kguts.cc:852-856)
    const bool tir = admit && s.num_hits > 1 && cur != f && s.prev2_fi == f;
    const bool emit_b = tir && emits(s, min_hits, min_wt);
    const Call call_b = call_of(s);
    apply_flush(s, tir);

    if (want_emit) {
      const Call& c = emit_a ? call_a : call_b;
      emit[o] = (emit_a || emit_b) ? 1 : 0;
      c_start[o] = c.start;
      c_end[o] = c.end;
      c_cnt[o] = c.cnt;
      c_fi[o] = c.fi;
      c_wt[o] = c.wt;
    }
  }

  if (want_emit) {
    // end-of-sequence flush (kguts.cc:873-875)
    const bool flush = final_flush == nullptr || final_flush[b] != 0;
    const bool emit_f = emits(s, min_hits, min_wt) && s.num_hits >= min_hits &&
                        flush;
    const Call c = call_of(s);
    const int64_t o = static_cast<int64_t>(W) * B + b;
    emit[o] = emit_f ? 1 : 0;
    c_start[o] = c.start;
    c_end[o] = c.end;
    c_cnt[o] = c.cnt;
    c_fi[o] = c.fi;
    c_wt[o] = c.wt;
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
  if (B > 0) {
    const int blocks = (B + kThreads - 1) / kThreads;
    scan_score_kernel<<<blocks, kThreads, 0,
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
