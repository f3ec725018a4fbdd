// Row gather: out[i, :] = table[idx[i], :] for an int32 table [R, w], with
// the id test on the card.
//
// Replaces close_kmers_tpu/ops/pallas_gather.py::pallas_row_gather
// (_gather_kernel), which fetched each row HBM->VMEM with its own DMA from
// a semaphore ring, and the XLA gather it stood in for on the family path
// (core/device_family.py::_gather_fams: [N+1, D] family rows by the
// probe's matched-row ids).
//
// Design: a block owns a tile of consecutive output rows.  One thread per
// row reads its id once, tests it against [0, R), starts the loads of the
// row's w ints back to back (four at a time, before any of them is
// stored) and puts them into a shared-memory tile laid out as the output
// is; the block then stores the tile as one contiguous run, neighbouring
// threads on neighbouring ints (coalesced, no division per element).  The
// latency of the id read and the dependent row read is hidden by
// occupancy: the tile is dynamic shared memory of 256 rows x w ints (3 KB
// at the family path's w = 3), so eight 256-thread blocks fit an SM; a
// tile holds fewer rows when w > 32 (at most 32 KB).  Any n and any w
// work: the TPU's 1024-row chunks were its tiling unit, not part of the
// contract.
//
// Bad ids: a row whose id lies outside [0, R) is written as zeros and sets
// the 4-byte flag `bad` (cleared by this entry point before the launch).
// The kernel never traps: a trap would poison the CUDA context.  The
// wrapper queues the flag's copy to the host right after the launch, and
// the caller raises IndexError once it has waited for its own result, so
// the check costs no extra host read before the launch.
//
// Bound: bytes.  Per output row it reads 4 B of id and w*4 B of table (one
// 32-byte sector per row when w <= 8, the rows being scattered) and writes
// w*4 B.  At the family path's shapes (1.25M ids, w = 3) that is ~35 MB
// counted once, ~0.010 ms at 3.35 TB/s; the scattered row reads cost a
// sector each, which makes ~70 MB of traffic the practical floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileInts = 8192;   // 32 KB of staged rows per block

__global__ void row_gather_kernel(const int32_t* __restrict__ table,
                                  const int32_t* __restrict__ idx, int64_t n,
                                  int32_t R, int32_t w, int32_t tile_rows,
                                  int32_t* __restrict__ out,
                                  int32_t* __restrict__ bad) {
  extern __shared__ int32_t tile[];   // tile_rows * w ints
  const int64_t n_tiles = (n + tile_rows - 1) / tile_rows;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t row0 = t * tile_rows;
    const int32_t rows = static_cast<int32_t>(
        n - row0 < tile_rows ? n - row0 : tile_rows);
    if (static_cast<int32_t>(threadIdx.x) < rows) {
      const int32_t r = idx[row0 + threadIdx.x];
      const bool ok = static_cast<uint32_t>(r) < static_cast<uint32_t>(R);
      if (!ok) *bad = 1;
      const int32_t* src = table + static_cast<int64_t>(ok ? r : 0) * w;
      int32_t* dst = tile + threadIdx.x * w;
      for (int32_t j0 = 0; j0 < w; j0 += 4) {
        int32_t v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = (ok && j0 + q < w) ? __ldg(src + j0 + q) : 0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j0 + q < w) dst[j0 + q] = v[q];
      }
    }
    __syncthreads();
    int32_t* dst = out + row0 * w;
    const int32_t total = rows * w;
    for (int32_t e = threadIdx.x; e < total; e += blockDim.x) dst[e] = tile[e];
    __syncthreads();
  }
}

}  // namespace

extern "C" int ck_row_gather(const void* table, const void* idx, int64_t n,
                             int32_t R, int32_t w, void* out, void* bad,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(bad, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0 && w > 0) {
    if (w > kTileInts) return static_cast<int>(cudaErrorInvalidValue);
    const int32_t tile_rows = kTileInts / w < kThreads ? kTileInts / w
                                                      : kThreads;
    const int64_t want = (n + tile_rows - 1) / tile_rows;
    const unsigned blocks =
        static_cast<unsigned>(want < (1 << 20) ? want : (1 << 20));
    const size_t smem = sizeof(int32_t) * tile_rows * w;
    row_gather_kernel<<<blocks, kThreads, smem, s>>>(
        static_cast<const int32_t*>(table), static_cast<const int32_t*>(idx),
        n, R, w, tile_rows, static_cast<int32_t*>(out),
        static_cast<int32_t*>(bad));
  }
  return static_cast<int>(cudaGetLastError());
}
