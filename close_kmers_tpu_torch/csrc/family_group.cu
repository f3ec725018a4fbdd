// Family rollup of one batch: per row, the 1/degree weights, the sort by
// family, the grouping and the left-pack of the groups.
//
// Two entries, chosen by the wrapper from the row width W*D alone.
//
// ck_family_group replaces the row-local part of
// close_kmers_tpu/core/device_family.py::rollup_from_fams (lines 197-253:
// the 1/degree weights from host constants, the stable lax.sort by family
// id along the row, the grouping lax.scan and the per-row left-pack), XLA
// code on the TPU with no Pallas counterpart.  Input: the [B, W, D] family
// rows (-1 = pad or miss) and the D weights float32(1)/float32(k), k =
// 1..D, made on the host.  Output, per row: the number of family groups
// and the first `cap` groups in ascending family order -- family, count,
// weighted sum, first flat position w*D + j -- as [B, cap] planes, zero
// past the row's groups.  Rows up to kMaxCols = W*D slots.
//
// ck_family_group_sorted is the wide route, for rows past kMaxCols: the
// same output from the row already stably sorted by key (torch.sort in the
// wrapper) as (key, weight, position) planes, walked from device memory by
// one thread per row.
//
// Design of ck_family_group.  Bound: bytes -- the rows once in, the four
// [B, cap] planes once out (at the global pack's cap = W*D+1 the output
// is four times the input).  What stood in the way was the sort: the
// port's first route sorted in device memory (torch.sort) and read the
// row back one thread per row.  Here a row belongs to a team of warps and
// never leaves the SM:
//   1. the row's ids are loaded coalesced into shared memory, and each
//      window's degree gives the weight of each of its slots;
//   2. each thread takes E consecutive slots into registers as 64-bit
//      keys (family << 32 | slot), pads as (1 << 30 << 32 | slot): the
//      slot makes every key distinct, so an unstable sort gives the
//      stable order, and ids up to 2^30 - 1 fit;
//   3. a bitonic network sorts them: stages whose partner lies in the
//      same thread run in registers, in another lane by shuffle, in
//      another warp through shared memory;
//   4. group starts are found in registers (the previous slot's key, by
//      shuffle across lanes) and ranked by a warp scan; the sorted
//      weights go to shared memory, and each start's thread writes its
//      family and first position;
//   5. one thread per group adds its group's weights in sorted order, a
//      chain of single IEEE adds (__fadd_rn, no FMA, no fast-math): the
//      (window, family-list) order of native.family_scores, so the sums
//      are bit-identical to the host and to the reference's scan.  A tree
//      sum would round differently.
// The network's compare-exchanges are most of the work, and a thread's
// E keys cost 2E registers: E = 8 slots a thread in teams of 1, 2 or 4
// warps (W*D <= 1024, the serving shapes; 8 single-warp rows to a block)
// keeps ~80 registers and enough warps on an SM to cover the shuffles'
// latency; wider rows take E = 32 in teams of 2-8 warps, which measured
// faster there.  Shared memory indices are padded by one word per 32
// (pad_idx), so the threads' E-slot runs fall on distinct banks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int32_t kPadKey = 1 << 30;
constexpr int kMaxCols = 8192;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int pad_idx(int i) { return i + (i >> 5); }

// A row's team: WARPS warps, E slots per thread, N = 32 * WARPS * E slots
// (a power of two >= W*D).  Single-warp teams share a block, eight rows
// to a block; wider teams take a block each.  ck_family_group picks the
// team from W*D.
template <int E, int WARPS>
struct Team {
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kN = kThreads * E;
  static constexpr int kRows = WARPS == 1 ? 8 : 1;
  static constexpr int kBlock = kRows * kThreads;
  static constexpr int kPadded = kN + kN / 32;
  // per row, in 32-bit words: area A (the loaded ids; the 64-bit exchange
  // of wide teams; then the sorted weights), area B (the slots' weights,
  // then the group starts), and four words per warp
  static constexpr int kAWords = WARPS == 1 ? kPadded : 2 * kPadded;
  static constexpr int kRowWords = kAWords + kPadded + 4 * WARPS;
  static constexpr int kSmemBytes = kRows * kRowWords * 4;
};

template <int WARPS>
__device__ __forceinline__ void team_sync() {
  if constexpr (WARPS == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// The in-register stage J (< E) of the bitonic network, sub-network K:
// slots i and i | J of this thread meet, ascending where (i & K) == 0.
template <int E, int J>
__device__ __forceinline__ void register_stage(u64 (&v)[E], int base, int k) {
  // k >= E: one direction for all of this thread's slots
  const bool up_all = (base & k) == 0;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    if (r & J) continue;
    const bool up = k >= E ? up_all : (r & k) == 0;
    const u64 a = v[r], b = v[r | J];
    const bool keep = (a < b) == up;
    v[r] = keep ? a : b;
    v[r | J] = keep ? b : a;
  }
}

// Stage (k, j) of the bitonic network over the team's registers: slot i
// meets slot i ^ j, in ascending order where (i & k) == 0.  The partner
// lies in this thread's registers (j < E), in another lane (shuffle) or in
// another warp (through shared memory).
template <int E, int WARPS>
__device__ __forceinline__ void bitonic_stage(u64 (&v)[E], int base, int lane,
                                              u64* xbuf, int k, int j) {
  if (WARPS > 1 && j >= 32 * E) {
#pragma unroll
    for (int r = 0; r < E; ++r) xbuf[pad_idx(base + r)] = v[r];
    __syncthreads();
    const bool take_min = ((base & j) == 0) == ((base & k) == 0);
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const u64 o = xbuf[pad_idx((base + r) ^ j)];
      v[r] = (v[r] < o) == take_min ? v[r] : o;
    }
    __syncthreads();
  } else if (j >= E) {
    // the lower lane keeps the smaller key where ascending
    const bool take_min = ((lane & (j / E)) == 0) == ((base & k) == 0);
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const u64 o = __shfl_xor_sync(kFull, v[r], j / E);
      v[r] = (v[r] < o) == take_min ? v[r] : o;
    }
  } else {
    switch (j) {
      case 1: register_stage<E, 1>(v, base, k); break;
      case 2: register_stage<E, 2>(v, base, k); break;
      case 4: register_stage<E, 4>(v, base, k); break;
      case 8: if constexpr (E > 8) register_stage<E, 8>(v, base, k); break;
      default: if constexpr (E > 16) register_stage<E, 16>(v, base, k);
    }
  }
}

template <int E, int WARPS, int K, int J>
__device__ __forceinline__ void unrolled_stages(u64 (&v)[E], int base,
                                                int lane, u64* xbuf) {
  bitonic_stage<E, WARPS>(v, base, lane, xbuf, K, J);
  if constexpr (J > 1)
    unrolled_stages<E, WARPS, K, J / 2>(v, base, lane, xbuf);
  else if constexpr (K < Team<E, WARPS>::kN)
    unrolled_stages<E, WARPS, 2 * K, K>(v, base, lane, xbuf);
}

// The team's registers sorted ascending.  With E <= 8 slots a thread the
// network is unrolled whole (constant stages, no loop); with more, the
// stage loops run at run time and only the register stages' bodies are
// unrolled, so the code stays small enough for the instruction cache:
// unrolled whole, the E = 32 network is ~10,000 instructions.
template <int E, int WARPS>
__device__ __forceinline__ void bitonic_sort(u64 (&v)[E], int base, int lane,
                                             u64* xbuf) {
  if constexpr (E <= 8) {
    unrolled_stages<E, WARPS, 2, 1>(v, base, lane, xbuf);
  } else {
#pragma unroll 1
    for (int k = 2; k <= Team<E, WARPS>::kN; k <<= 1) {
#pragma unroll 1
      for (int j = k >> 1; j > 0; j >>= 1)
        bitonic_stage<E, WARPS>(v, base, lane, xbuf, k, j);
    }
  }
}

__device__ __forceinline__ uint32_t key_of(u64 x) {
  return static_cast<uint32_t>(x >> 32);
}

template <int E, int WARPS>
__global__ void __launch_bounds__(Team<E, WARPS>::kBlock)
    family_group_kernel(const int32_t* __restrict__ fams,
                        const float* __restrict__ wts, int32_t n_rows,
                        int32_t n_win, int32_t d, int32_t cap,
                        int32_t* __restrict__ n_groups,
                        int32_t* __restrict__ fam, int32_t* __restrict__ cnt,
                        float* __restrict__ ws, int32_t* __restrict__ first) {
  using T = Team<E, WARPS>;
  extern __shared__ __align__(16) uint32_t smem[];
  const int team = threadIdx.x / T::kThreads;
  const int tid = threadIdx.x % T::kThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * T::kRows + team;
  // uniform per team: a wide team has the block to itself and the grid
  // has no spare block
  if (row >= n_rows) return;
  uint32_t* area = smem + team * T::kRowWords;
  int32_t* ids = reinterpret_cast<int32_t*>(area);
  u64* xbuf = reinterpret_cast<u64*>(area);
  float* sorted_w = reinterpret_cast<float*>(area);
  float* wbuf = reinterpret_cast<float*>(area + T::kAWords);
  int32_t* gstart = reinterpret_cast<int32_t*>(wbuf);
  int32_t* wsum = reinterpret_cast<int32_t*>(area + T::kAWords + T::kPadded);
  u64* wlast = reinterpret_cast<u64*>(wsum + 2 * WARPS);

  // 1. the row's ids, coalesced, all E loads of a thread in flight at
  // once (-1 past the row, up to N); each window's weight on each of
  // its slots
  const int m = n_win * d;
  const int32_t* src = fams + row * m;
  {
    int32_t x[E];
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int p = r * T::kThreads + tid;
      x[r] = p < m ? __ldg(src + p) : -1;
    }
#pragma unroll
    for (int r = 0; r < E; ++r) ids[pad_idx(r * T::kThreads + tid)] = x[r];
  }
  team_sync<WARPS>();
  for (int w = tid; w < n_win; w += T::kThreads) {
    int deg = 0;
    for (int j = 0; j < d; ++j) deg += ids[pad_idx(w * d + j)] >= 0;
    const float wt = deg ? __ldg(wts + deg - 1) : 0.0f;
    for (int j = 0; j < d; ++j) wbuf[pad_idx(w * d + j)] = wt;
  }

  // 2. E consecutive slots per thread as (key << 32 | slot)
  const int base = tid * E;
  u64 v[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int i = base + r;
    const int32_t f = ids[pad_idx(i)];
    const uint32_t key = f >= 0 ? static_cast<uint32_t>(f) : kPadKey;
    v[r] = (static_cast<u64>(key) << 32) | static_cast<uint32_t>(i);
  }
  team_sync<WARPS>();   // area A is free from here on

  // 3. sort
  bitonic_sort<E, WARPS>(v, base, lane, xbuf);

  // 4. group starts: a valid slot whose key differs from the slot before
  u64 before = __shfl_up_sync(kFull, v[E - 1], 1);
  if constexpr (WARPS > 1) {
    if (lane == 31) wlast[warp] = v[E - 1];
    __syncthreads();
    if (lane == 0 && warp > 0) before = wlast[warp - 1];
  }
  const bool has_before = base > 0;
  unsigned starts = 0;   // bit r: slot base + r starts a group
  int n_valid_mine = 0;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const uint32_t k = key_of(v[r]);
    const bool valid = k < static_cast<uint32_t>(kPadKey);
    const uint32_t kb = r ? key_of(v[r - 1]) : key_of(before);
    const bool is_start = valid && (!(r || has_before) || kb != k);
    starts |= static_cast<unsigned>(is_start) << r;
    n_valid_mine += valid;
  }
  // rank the starts: a scan over the warp, then over the warps
  const int mine = __popc(starts);
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  int n_valid = n_valid_mine;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n_valid += __shfl_xor_sync(kFull, n_valid, o);
  int warp_total = __shfl_sync(kFull, incl, 31);
  int g = incl - mine;
  int total = warp_total;
  if constexpr (WARPS > 1) {
    if (lane == 0) {
      wsum[warp] = warp_total;
      wsum[WARPS + warp] = n_valid;
    }
    __syncthreads();
    total = 0;
    n_valid = 0;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) {
      if (q < warp) g += wsum[q];
      total += wsum[q];
      n_valid += wsum[WARPS + q];
    }
  }
  // the sorted slots' weights into area A (the ids are dead), then the
  // group starts into area B (the slots' weights are dead)
#pragma unroll
  for (int r = 0; r < E; ++r)
    sorted_w[pad_idx(base + r)] =
        base + r < n_valid
            ? wbuf[pad_idx(static_cast<int>(static_cast<uint32_t>(v[r])))]
            : 0.0f;
  team_sync<WARPS>();
  const int64_t out0 = row * cap;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    if (!((starts >> r) & 1u)) continue;
    gstart[g] = base + r;
    if (g < cap) {
      fam[out0 + g] = static_cast<int32_t>(key_of(v[r]));
      first[out0 + g] = static_cast<int32_t>(static_cast<uint32_t>(v[r]));
    }
    ++g;
  }
  if (tid == 0) {
    gstart[total] = n_valid;
    n_groups[row] = total;
  }
  team_sync<WARPS>();

  // 5. one thread per group: its count and its chain of adds
  const int n_out = total < cap ? total : cap;
  for (int q = tid; q < n_out; q += T::kThreads) {
    const int s = gstart[q], e = gstart[q + 1];
    float sum = sorted_w[pad_idx(s)];
    int t = s + 1;
    for (; t + 4 <= e; t += 4) {
      const float a = sorted_w[pad_idx(t)], b = sorted_w[pad_idx(t + 1)];
      const float c = sorted_w[pad_idx(t + 2)], dd = sorted_w[pad_idx(t + 3)];
      sum = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(sum, a), b), c), dd);
    }
    for (; t < e; ++t) sum = __fadd_rn(sum, sorted_w[pad_idx(t)]);
    cnt[out0 + q] = e - s;
    ws[out0 + q] = sum;
  }
  for (int q = n_out + tid; q < cap; q += T::kThreads) {
    fam[out0 + q] = 0;
    cnt[out0 + q] = 0;
    ws[out0 + q] = 0.0f;
    first[out0 + q] = 0;
  }
}

template <int E, int WARPS>
cudaError_t launch_team(const int32_t* fams, const float* wts, int32_t n_rows,
                        int32_t n_win, int32_t d, int32_t cap,
                        int32_t* n_groups, int32_t* fam, int32_t* cnt,
                        float* ws, int32_t* first, cudaStream_t stream) {
  using T = Team<E, WARPS>;
  auto kernel = family_group_kernel<E, WARPS>;
  // all the SM's unified memory as shared memory: the team's registers
  // and its row's shared memory set how many rows an SM holds
  static const cudaError_t opt_in = [&] {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    return rc != cudaSuccess ? rc : cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  }();
  if (opt_in != cudaSuccess) return opt_in;
  const unsigned blocks =
      static_cast<unsigned>((static_cast<int64_t>(n_rows) + T::kRows - 1) /
                            T::kRows);
  kernel<<<blocks, T::kBlock, T::kSmemBytes, stream>>>(
      fams, wts, n_rows, n_win, d, cap, n_groups, fam, cnt, ws, first);
  return cudaGetLastError();
}

// The wide route: one thread per row walks its sorted (key, weight,
// position) planes from device memory (the port's first design of this
// kernel, kept for rows past kMaxCols).
constexpr int kSortedThreads = 64;

__global__ void family_group_sorted_kernel(
    const int32_t* __restrict__ skey, const float* __restrict__ swt,
    const int32_t* __restrict__ spos, int32_t n_rows, int32_t m, int32_t cap,
    int32_t* __restrict__ n_groups, int32_t* __restrict__ fam,
    int32_t* __restrict__ cnt, float* __restrict__ ws,
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

extern "C" int ck_family_group_max_cols() { return kMaxCols; }

extern "C" int ck_family_group(const void* fams, const void* wts,
                               int32_t n_rows, int32_t n_win, int32_t d,
                               int32_t cap, void* n_groups, void* fam,
                               void* cnt, void* ws, void* first,
                               void* stream) {
  const int64_t m = static_cast<int64_t>(n_win) * d;
  if (n_rows < 0 || n_win < 0 || d < 1 || cap < 0 || m > kMaxCols)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return static_cast<int>(cudaGetLastError());
  const auto* f = static_cast<const int32_t*>(fams);
  const auto* w = static_cast<const float*>(wts);
  auto* ng = static_cast<int32_t*>(n_groups);
  auto* fa = static_cast<int32_t*>(fam);
  auto* cn = static_cast<int32_t*>(cnt);
  auto* wsp = static_cast<float*>(ws);
  auto* fi = static_cast<int32_t*>(first);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (m <= 256)
    rc = launch_team<8, 1>(f, w, n_rows, n_win, d, cap, ng, fa, cn, wsp, fi, s);
  else if (m <= 512)
    rc = launch_team<8, 2>(f, w, n_rows, n_win, d, cap, ng, fa, cn, wsp, fi, s);
  else if (m <= 1024)
    rc = launch_team<8, 4>(f, w, n_rows, n_win, d, cap, ng, fa, cn, wsp, fi, s);
  else if (m <= 2048)
    rc = launch_team<32, 2>(f, w, n_rows, n_win, d, cap, ng, fa, cn, wsp, fi, s);
  else if (m <= 4096)
    rc = launch_team<32, 4>(f, w, n_rows, n_win, d, cap, ng, fa, cn, wsp, fi, s);
  else
    rc = launch_team<32, 8>(f, w, n_rows, n_win, d, cap, ng, fa, cn, wsp, fi, s);
  return static_cast<int>(rc);
}

extern "C" int ck_family_group_sorted(const void* skey, const void* swt,
                                      const void* spos, int32_t n_rows,
                                      int32_t m, int32_t cap, void* n_groups,
                                      void* fam, void* cnt, void* ws,
                                      void* first, void* stream) {
  if (n_rows > 0) {
    const unsigned blocks = static_cast<unsigned>(
        (static_cast<int64_t>(n_rows) + kSortedThreads - 1) / kSortedThreads);
    family_group_sorted_kernel<<<blocks, kSortedThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(skey), static_cast<const float*>(swt),
        static_cast<const int32_t*>(spos), n_rows, m, cap,
        static_cast<int32_t*>(n_groups), static_cast<int32_t*>(fam),
        static_cast<int32_t*>(cnt), static_cast<float*>(ws),
        static_cast<int32_t*>(first));
  }
  return static_cast<int>(cudaGetLastError());
}
