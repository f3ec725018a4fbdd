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
//   memory).  Design: persistent blocks, one per SM; each copies the tile
//   into shared memory once, then walks chunks; in a chunk each warp takes
//   an id, its lanes read the row from shared memory (consecutive lanes,
//   consecutive banks) and add into int64.
//   Bound: shared-memory reads, w*4 B per id; device memory reads only the
//   ids (4 B each) and the tile once per block.
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
// The two sums are the exact integer sum, rounded once to f32 (int64
// accumulation, __ll2float_rn), so they equal the plain torch versions bit
// for bit at any size, and the Pallas f32 sums while the sum stays below
// 2^24.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGatherWarps = 4;     // warps per block of ck_dma_gather
constexpr int kReduceThreads = 512; // threads per block of the two sums
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

__global__ void vgather_kernel(const int32_t* __restrict__ tile,
                               int32_t tile_ints, const int32_t* __restrict__ idx,
                               int64_t n_chunks, int32_t chunk, int32_t w,
                               float* __restrict__ out) {
  extern __shared__ __align__(16) int32_t t[];
  for (int i = threadIdx.x; i < tile_ints; i += blockDim.x) t[i] = tile[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int32_t* ids = idx + c * chunk;
    long long acc = 0;
    for (int k = warp; k < chunk; k += n_warps) {
      const int32_t* row = t + static_cast<int64_t>(ids[k]) * w;
      for (int j = lane; j < w; j += 32) acc += row[j];
    }
    const long long s = block_sum(acc);
    if (threadIdx.x == 0) out[c] = __ll2float_rn(s);
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
  const size_t smem = static_cast<size_t>(tile_ints) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      vgather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  const int64_t sms = sm_count();
  const unsigned blocks =
      static_cast<unsigned>(n_chunks < sms ? n_chunks : sms);
  vgather_kernel<<<blocks, kReduceThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tile), tile_ints,
      static_cast<const int32_t*>(idx), n_chunks, chunk, w,
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
