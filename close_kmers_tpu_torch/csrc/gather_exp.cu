// The probe-gather experiments' four kernels: the floors of the probe's
// row reads on this card.
//
// Each replaces one Pallas kernel of scripts/gather_exp.py and computes
// what it computes; the (8, 128)-broadcast outputs there were the TPU's
// minimum output tile and are not part of the result.
//
// ck_dma_gather replaces pallas_dma_gather (per-row DMA HBM->VMEM through a
//   16-deep semaphore ring): out[k, :] = table[idx[k], :], int32 rows.
//   Design: one warp per row at a time, each warp walking its rows (k =
//   warp, warp + n_warps, ...) with DEPTH rows in flight through its own
//   shared-memory ring, filled by cp.async (16 B when the row is 16-byte
//   aligned and a multiple of 16 B, else 4 B); cp.async.wait_group
//   plays the DMA semaphore.  Each lane writes out exactly the chunks it
//   copied, so the wait needs no warp barrier.  Any n (the TPU needed
//   n % 512 == 0).  The wrapper checks the ids against R.
//   Bound: bytes, w*4 B read at a random row and w*4 B written per id.
//
// ck_vgather replaces pallas_vgather (a [2048, 128] i32 tile resident in
//   VMEM, rows gathered from it by id): out[c] = the sum of every element
//   of tile[id] over the ids of chunk c.  The TPU's 1 MB tile does not fit
//   a block's 227 KB of shared memory, so the tile is the caller's (the
//   experiment takes 448 x 128 i32 = 224 KB, opt-in dynamic shared
//   memory).  Design: persistent blocks of 32 warps, one per SM; each
//   copies the tile into shared memory once (biased by 2^31, so that the
//   adds need no sign extension), then walks its chunks in rounds.  A warp
//   takes 32-id groups of each chunk: one coalesced load brings a group's
//   ids, one a lane, the next group's load goes out before this group's
//   rows are read, and each __shfl_sync hands two row offsets to the warp.
//   A 128-int row is one 16-B shared-memory read per lane (4-B reads where
//   w % 4 != 0), four rows in flight into four 64-bit accumulators.  Each warp
//   writes one partial sum per chunk into the shared memory left beside
//   the tile, and one barrier per round (every chunk of the block, at the
//   experiment's shape) precedes the chunks' final sums.
//   Bound: shared-memory reads, w*4 B per id, and as much the 64-bit adds
//   (2 integer operations per element over 64 INT32 lanes per SM); device
//   memory reads only the ids (4 B each) and the tile once per block.
//
// ck_hbmstream replaces pallas_hbmstream (a sequential stream of the table
//   through the auto-pipelined grid, one f32 sum per block of rows):
//   out[b] = the sum of rows [b*blk, (b+1)*blk).  Design: persistent
//   blocks stride over the row blocks; in a row block the threads stride
//   with 16-byte loads, four in flight per thread.
//   Bound: device memory bandwidth (every byte read once).
//
// ck_dmaflush replaces pallas_dmaflush (VMEM -> scattered HBM block writes
//   through a 4-deep semaphore ring): for program i and slot j,
//   out[dst[i, j]*rpd : +rpd] = buf[j*rpd : +rpd] (rows of w int32).  The
//   same buf serves every program, as the TPU's index map (0, 0) made it.
//   Design: one warp per block copy, 16-byte loads and stores when the
//   copy is 16-byte aligned.  dst must hold distinct rows (the kernel does
//   not check: that would need a host sync).
//   Bound: device memory write bandwidth at rpd*w*4 B (4 KB at 8 x 128)
//   per scattered copy; buf (1 MB) stays in L2.
//
// The two sums are the exact integer sum, rounded once to f32 (64-bit
// accumulation, __ll2float_rn), so they equal the plain torch versions bit
// for bit at any size, and the Pallas f32 sums while the sum stays below
// 2^24.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGatherWarps = 4;     // warps per block of ck_dma_gather
constexpr int kReduceThreads = 512; // threads per block of hbmstream
constexpr int kVgWarps = 32;        // warps per block of ck_vgather
constexpr int kVgThreads = kVgWarps * 32;  // also ids between a warp's groups
constexpr int kVgUnroll = 4;        // rows in flight per warp
constexpr int kVgMaxSlots = 32;     // chunks per round: one summing warp each
static_assert(kVgWarps == 32, "a chunk's final sum takes one partial a lane");
static_assert(kVgUnroll % 2 == 0, "a shuffle hands over two rows");
constexpr int kFlushWarps = 8;      // warps per block of ck_dmaflush

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <bool VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if (VEC) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- dma_gather

template <int DEPTH, bool VEC>
__global__ void dma_gather_kernel(const int32_t* __restrict__ table,
                                  const int32_t* __restrict__ idx, int64_t n,
                                  int32_t w, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t ring[];  // [warps][DEPTH][w]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t* my = ring + static_cast<int64_t>(warp) * DEPTH * w;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kGatherWarps + warp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kGatherWarps;
  const int64_t m = g < n ? (n - 1 - g) / stride + 1 : 0;  // rows of the warp
  constexpr int kInts = VEC ? 4 : 1;                      // ints per copy
  const int chunks = w / kInts;

  auto issue = [&](int64_t i) {  // the warp's row i into slot i % DEPTH
    const int32_t* src = table + static_cast<int64_t>(idx[g + i * stride]) * w;
    int32_t* dst = my + static_cast<int>(i % DEPTH) * w;
    for (int c = lane; c < chunks; c += 32)
      cp_async<VEC>(dst + c * kInts, src + c * kInts);
  };

  for (int64_t i = 0; i < DEPTH - 1; ++i) {  // prologue: DEPTH-1 in flight
    if (i < m) issue(i);
    cp_async_commit();
  }
  for (int64_t i = 0; i < m; ++i) {
    if (i + DEPTH - 1 < m) issue(i + DEPTH - 1);
    cp_async_commit();            // an empty group past the end keeps count
    cp_async_wait<DEPTH - 1>();   // this lane's copies of row i have landed
    const int32_t* s = my + static_cast<int>(i % DEPTH) * w;
    int32_t* o = out + (g + i * stride) * w;
    if (VEC) {
      for (int c = lane; c < chunks; c += 32)
        reinterpret_cast<int4*>(o)[c] = reinterpret_cast<const int4*>(s)[c];
    } else {
      for (int c = lane; c < chunks; c += 32) o[c] = s[c];
    }
  }
  cp_async_wait<0>();
}

template <int DEPTH>
int launch_dma_gather(const int32_t* table, const int32_t* idx, int64_t n,
                      int32_t w, int32_t* out, bool vec, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(kGatherWarps) * DEPTH * w * 4;
  auto kern = vec ? dma_gather_kernel<DEPTH, true>
                  : dma_gather_kernel<DEPTH, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  // at least 64 rows per warp, so that its ring fills
  const int64_t want = (n + kGatherWarps * 64 - 1) / (kGatherWarps * 64);
  const unsigned blocks =
      static_cast<unsigned>(want < (1 << 20) ? want : (1 << 20));
  kern<<<blocks, kGatherWarps * 32, smem, st>>>(table, idx, n, w, out);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- the sums

// Sum of one int64 per thread over the block, in thread 0.
__device__ __forceinline__ long long block_sum(long long v) {
  __shared__ long long part[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // part[] is free again (a previous call has read it)
  if (lane == 0) part[warp] = v;
  __syncthreads();
  long long s = 0;
  if (threadIdx.x == 0)
    for (int i = 0; i < (blockDim.x >> 5); ++i) s += part[i];
  return s;
}

// One 64-bit add per element: the tile is held biased (x ^ 2^31, that is
// x + 2^31 as an unsigned value), so a row's ints add as unsigned with a
// carry and no sign extension; the chunk's sum less ids * w * 2^31 is the
// exact sum modulo 2^64, as the signed int64 sum is.
__device__ __forceinline__ void vg_add4(unsigned long long& acc, uint4 v) {
  acc += v.x;
  acc += v.y;
  acc += v.z;
  acc += v.w;
}

// kVgUnroll rows of the tile at offsets r[] (ints), added into acc[], each
// into its own accumulator.  kVec: 16-B reads (w % 4 == 0), a 128-int
// row in one warp instruction; else 4-B reads.
template <bool kVec>
__device__ __forceinline__ void vg_add_rows(
    const uint32_t* t, const int32_t (&r)[kVgUnroll], int32_t w, int lane,
    unsigned long long (&acc)[kVgUnroll]) {
  if (kVec) {
    for (int c = 4 * lane; c < w; c += 128) {
      uint4 v[kVgUnroll];
#pragma unroll
      for (int u = 0; u < kVgUnroll; ++u)
        v[u] = *reinterpret_cast<const uint4*>(t + r[u] + c);
#pragma unroll
      for (int u = 0; u < kVgUnroll; ++u) vg_add4(acc[u], v[u]);
    }
  } else {
    for (int c = lane; c < w; c += 32) {
#pragma unroll
      for (int u = 0; u < kVgUnroll; ++u) acc[u] += t[r[u] + c];
    }
  }
}

// Adds the rows of a group of n (<= 32) ids into acc[]: lane j holds the
// j-th id's row offset (id * w ints) in `off`.  The tile holds fewer than
// 2^16 ints, so a whole group goes two offsets a shuffle.  kW: the row
// width when fixed at compile time, else 0 (w at run time).
template <bool kVec, int kW>
__device__ __forceinline__ void vg_rows(const uint32_t* t, int32_t off, int n,
                                        int32_t w_run, int lane,
                                        unsigned long long (&acc)[kVgUnroll]) {
  const int32_t w = kW ? kW : w_run;
  if (n == 32) {                      // lanes j < 16: rows j and j + 16
    const uint32_t pair =
        static_cast<uint32_t>(off) |
        (static_cast<uint32_t>(__shfl_down_sync(0xffffffffu, off, 16)) << 16);
    for (int j = 0; j < 16; j += kVgUnroll / 2) {
      int32_t r[kVgUnroll];
#pragma unroll
      for (int u = 0; u < kVgUnroll / 2; ++u) {
        const uint32_t p = __shfl_sync(0xffffffffu, pair, j + u);
        r[2 * u] = static_cast<int32_t>(p & 0xffffu);
        r[2 * u + 1] = static_cast<int32_t>(p >> 16);
      }
      vg_add_rows<kVec>(t, r, w, lane, acc);
    }
    return;
  }
  for (int j = 0; j < n; ++j) {                         // n is warp-uniform
    const int32_t r = __shfl_sync(0xffffffffu, off, j);
    if (kVec) {
      for (int c = 4 * lane; c < w; c += 128)
        vg_add4(acc[0], *reinterpret_cast<const uint4*>(t + r + c));
    } else {
      for (int c = lane; c < w; c += 32) acc[0] += t[r + c];
    }
  }
}

// Persistent blocks of kVgWarps warps, one per SM (the tile fills its
// shared memory).  Block b takes chunks b, b + gridDim.x, ...; the
// block's chunks go in rounds of `slots`, each warp adding the rows of
// its 32-id groups of every chunk of the round (group g of a chunk to
// warp g % kVgWarps) and writing one partial sum per chunk beside the
// tile; after the round's one barrier, warp i adds chunk i's partials.
template <bool kVec, int kW>
__global__ void __launch_bounds__(kVgThreads, 1) vgather_kernel(
    const int32_t* __restrict__ tile, int32_t tile_ints, bool tile_vec,
    const int32_t* __restrict__ idx, int64_t n_chunks, int32_t chunk,
    int32_t w, int32_t slots, float* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t t[];
  unsigned long long* part =            // [slots][kVgWarps], 8-B aligned
      reinterpret_cast<unsigned long long*>(t + ((tile_ints + 1) & ~1));
  if (tile_vec) {                       // the tile, biased, into t
    const uint4* src = reinterpret_cast<const uint4*>(tile);
    for (int i = threadIdx.x; i < tile_ints / 4; i += kVgThreads) {
      uint4 v = src[i];
      v.x ^= 0x80000000u;
      v.y ^= 0x80000000u;
      v.z ^= 0x80000000u;
      v.w ^= 0x80000000u;
      reinterpret_cast<uint4*>(t)[i] = v;
    }
  } else {
    for (int i = threadIdx.x; i < tile_ints; i += kVgThreads)
      t[i] = static_cast<uint32_t>(tile[i]) ^ 0x80000000u;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this block's chunks, and this warp's 32-id groups in each chunk
  const int64_t m =
      blockIdx.x < n_chunks ? (n_chunks - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int first = warp * 32;
  const int groups = first < chunk ? (chunk - first - 1) / kVgThreads + 1
                                   : 0;
  const unsigned long long bias =
      (static_cast<unsigned long long>(chunk) * w) << 31;
  for (int64_t base = 0; base < m; base += slots) {
    const int cnt = static_cast<int>(m - base < slots ? m - base : slots);
    const int total = cnt * groups;
    // the ids of the warp's item i (chunk i / groups of the round, group
    // i % groups), one a lane: loaded one item ahead of its rows
    auto ids_of = [&](int i) {
      const int ch = i / groups;
      const int g = first + (i - ch * groups) * kVgThreads;
      const int64_t c = blockIdx.x + (base + ch) * gridDim.x;
      return g + lane < chunk ? idx[c * chunk + g + lane] : 0;
    };
    unsigned long long acc[kVgUnroll];
#pragma unroll
    for (int u = 0; u < kVgUnroll; ++u) acc[u] = 0;
    int32_t next = total > 0 ? ids_of(0) : 0;
    for (int i = 0; i < total; ++i) {
      const int32_t id = next;
      if (i + 1 < total) next = ids_of(i + 1);
      const int ch = i / groups;
      const int g = first + (i - ch * groups) * kVgThreads;
      vg_rows<kVec, kW>(t, id * w, chunk - g < 32 ? chunk - g : 32, w, lane,
                        acc);
      if (i - ch * groups == groups - 1) {       // the chunk's last group
        unsigned long long s = 0;
#pragma unroll
        for (int u = 0; u < kVgUnroll; ++u) {
          s += acc[u];
          acc[u] = 0;
        }
        for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
        if (lane == 0) part[ch * kVgWarps + warp] = s;
      }
    }
    if (groups == 0 && lane == 0)
      for (int ch = 0; ch < cnt; ++ch) part[ch * kVgWarps + warp] = 0;
    __syncthreads();
    if (warp < cnt) {
      unsigned long long s = part[warp * kVgWarps + lane];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
      if (lane == 0)
        out[blockIdx.x + (base + warp) * gridDim.x] =
            __ll2float_rn(static_cast<long long>(s - bias));
    }
    if (base + slots < m) __syncthreads();   // part[] is read before reuse
  }
}

template <bool VEC>
__global__ void hbmstream_kernel(const int32_t* __restrict__ table,
                                 int64_t n_blk, int64_t blk_ints,
                                 float* __restrict__ out) {
  for (int64_t b = blockIdx.x; b < n_blk; b += gridDim.x) {
    const int32_t* p = table + b * blk_ints;
    long long acc = 0;
    if (VEC) {
      const int4* q = reinterpret_cast<const int4*>(p);
      const int64_t nq = blk_ints / 4;
      int64_t i = threadIdx.x;
      for (; i + 3 * kReduceThreads < nq; i += 4 * kReduceThreads) {
        int4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = __ldcs(q + i + u * kReduceThreads);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc += static_cast<long long>(v[u].x) + v[u].y + v[u].z + v[u].w;
      }
      for (; i < nq; i += kReduceThreads) {
        const int4 v = __ldcs(q + i);
        acc += static_cast<long long>(v.x) + v.y + v.z + v.w;
      }
    } else {
      for (int64_t i = threadIdx.x; i < blk_ints; i += kReduceThreads)
        acc += p[i];
    }
    const long long s = block_sum(acc);
    if (threadIdx.x == 0) out[b] = __ll2float_rn(s);
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// ---------------------------------------------------------------- dmaflush

template <bool VEC>
__global__ void dmaflush_kernel(const int32_t* __restrict__ dst,
                                const int32_t* __restrict__ buf,
                                int64_t n_dmas, int32_t per_prog,
                                int64_t copy_ints, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t k =
      static_cast<int64_t>(blockIdx.x) * kFlushWarps + (threadIdx.x >> 5);
  if (k >= n_dmas) return;
  const int32_t* s = buf + (k % per_prog) * copy_ints;  // slot j of program i
  int32_t* o = out + static_cast<int64_t>(dst[k]) * copy_ints;
  if (VEC) {
    const int64_t nq = copy_ints / 4;
    for (int64_t c = lane; c < nq; c += 32)
      reinterpret_cast<int4*>(o)[c] = __ldg(reinterpret_cast<const int4*>(s) + c);
  } else {
    for (int64_t c = lane; c < copy_ints; c += 32) o[c] = s[c];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int ck_dma_gather(const void* table, const void* idx, int64_t n,
                             int32_t w, int32_t depth, void* out,
                             void* stream) {
  if (n <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  const auto* t = static_cast<const int32_t*>(table);
  const auto* ix = static_cast<const int32_t*>(idx);
  auto* o = static_cast<int32_t*>(out);
  const bool vec = w % 4 == 0 && aligned16(table) && aligned16(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (depth) {
    case 1: return launch_dma_gather<1>(t, ix, n, w, o, vec, st);
    case 2: return launch_dma_gather<2>(t, ix, n, w, o, vec, st);
    case 4: return launch_dma_gather<4>(t, ix, n, w, o, vec, st);
    case 8: return launch_dma_gather<8>(t, ix, n, w, o, vec, st);
    case 16: return launch_dma_gather<16>(t, ix, n, w, o, vec, st);
    case 32: return launch_dma_gather<32>(t, ix, n, w, o, vec, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int ck_vgather(const void* tile, int32_t tile_rows, int32_t w,
                          const void* idx, int64_t n_chunks, int32_t chunk,
                          void* out, void* stream) {
  if (n_chunks <= 0) return static_cast<int>(cudaGetLastError());
  const int32_t tile_ints = tile_rows * w;
  // the tile, 8-B rounded, then as many rounds' partial sums as fit
  const size_t tile_bytes = (static_cast<size_t>(tile_ints) * 4 + 7) & ~size_t{7};
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int64_t room =
      (static_cast<int64_t>(optin) - static_cast<int64_t>(tile_bytes)) /
      (kVgWarps * 8);
  if (room < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int32_t slots = static_cast<int32_t>(room < kVgMaxSlots ? room
                                                                : kVgMaxSlots);
  const size_t smem = tile_bytes + static_cast<size_t>(slots) * kVgWarps * 8;
  // the experiment's 128-int rows with the width fixed at compile time
  auto kern = w == 128    ? vgather_kernel<true, 128>
              : w % 4 == 0 ? vgather_kernel<true, 0>
                           : vgather_kernel<false, 0>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  const int64_t sms = sm_count();
  const unsigned blocks =
      static_cast<unsigned>(n_chunks < sms ? n_chunks : sms);
  kern<<<blocks, kVgThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tile), tile_ints,
      tile_ints % 4 == 0 && aligned16(tile),
      static_cast<const int32_t*>(idx), n_chunks, chunk, w, slots,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ck_hbmstream(const void* table, int64_t n_blk,
                            int64_t blk_ints, void* out, void* stream) {
  if (n_blk <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t cap = static_cast<int64_t>(sm_count()) * 4;
  const unsigned blocks = static_cast<unsigned>(n_blk < cap ? n_blk : cap);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const int32_t*>(table);
  auto* o = static_cast<float*>(out);
  if (blk_ints % 4 == 0 && aligned16(table))
    hbmstream_kernel<true><<<blocks, kReduceThreads, 0, st>>>(t, n_blk,
                                                              blk_ints, o);
  else
    hbmstream_kernel<false><<<blocks, kReduceThreads, 0, st>>>(t, n_blk,
                                                               blk_ints, o);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ck_dmaflush(const void* dst, const void* buf, int64_t n_dmas,
                           int32_t per_prog, int64_t copy_ints, void* out,
                           void* stream) {
  if (n_dmas <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks =
      static_cast<unsigned>((n_dmas + kFlushWarps - 1) / kFlushWarps);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const int32_t*>(dst);
  const auto* b = static_cast<const int32_t*>(buf);
  auto* o = static_cast<int32_t*>(out);
  if (copy_ints % 4 == 0 && aligned16(buf) && aligned16(out))
    dmaflush_kernel<true><<<blocks, kFlushWarps * 32, 0, st>>>(
        d, b, n_dmas, per_prog, copy_ints, o);
  else
    dmaflush_kernel<false><<<blocks, kFlushWarps * 32, 0, st>>>(
        d, b, n_dmas, per_prog, copy_ints, o);
  return static_cast<int>(cudaGetLastError());
}
