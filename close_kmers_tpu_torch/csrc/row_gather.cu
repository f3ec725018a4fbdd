// Row gather: out[i, :] = table[idx[i], :] for an int32 table [R, w].
//
// Replaces close_kmers_tpu/ops/pallas_gather.py::pallas_row_gather
// (_gather_kernel), which fetched each row HBM->VMEM with its own DMA from
// a semaphore ring, and the XLA gather it stood in for on the family path
// (core/device_family.py::_gather_fams: [N+1, D] family rows by the
// probe's matched-row ids).
//
// Design: one thread per output element, in a grid-stride loop over the
// flat [n, w] output.  Consecutive threads write consecutive ints, so the
// stores coalesce; the reads are scattered rows, w ints each, and the
// index load repeats across the w threads of a row (served by L1).  Any n
// and any w work: the TPU's 1024-row chunks were its tiling unit, not part
// of the contract.  The wrapper checks the ids against R before the
// launch, so the kernel does no bounds test.
//
// Bound: bytes.  Per output row it reads 4 B of index and w*4 B of table
// (one 32-byte sector per row when w <= 8) and writes w*4 B.  At the family
// path's shapes (1.25M ids, w = 3) that is ~45 MB of traffic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void row_gather_kernel(const int32_t* __restrict__ table,
                                  const int32_t* __restrict__ idx,
                                  int64_t n_elems, int32_t w,
                                  int32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n_elems; e += stride) {
    const int64_t i = e / w;
    const int32_t j = static_cast<int32_t>(e - i * w);
    out[e] = table[static_cast<int64_t>(idx[i]) * w + j];
  }
}

}  // namespace

extern "C" int ck_row_gather(const void* table, const void* idx, int64_t n,
                             int32_t w, void* out, void* stream) {
  const int64_t n_elems = n * w;
  if (n_elems > 0) {
    const int64_t want = (n_elems + kThreads - 1) / kThreads;
    const unsigned blocks =
        static_cast<unsigned>(want < (1 << 20) ? want : (1 << 20));
    row_gather_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(table), static_cast<const int32_t*>(idx),
        n_elems, w, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
