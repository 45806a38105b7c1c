// fused_gather_fold: gather_xor with the [n, BW] db slab resident on chip.
//
// Replaces the TPU kernel of the reference package's kernels/fused.py
// (`_kernel`: the whole record axis of one word block held in fast memory,
// an in-kernel loop walking the prefetched indices).
//
// Bound: bytes. The function is gather_xor's, so the least time counts
// only the distinct live rows the indices name: distinct*W*4 + q*m*4 +
// q*W*4 bytes over the memory rate. The kernel itself reads the whole slab
// from device memory once per block that stages it ("wq": once per word
// block for the whole batch; "qw": once per query), after which the index
// walk reads shared memory only.
//
// Design: the slab lives in dynamic shared memory (up to the opt-in limit
// of 227 KB a block, which the Python gate `fused_block_w` enforces),
// staged and walked by the code in fused_slab.cuh (16 B staging loads,
// warp-shuffle fold, atomicXor into the zeroed output). In "qw" order a
// block serves one query; in "wq" order one block per word block stages
// the slab once and loops over every query of the batch.
#include "fused_slab.cuh"

namespace {

__global__ void __launch_bounds__(pir_slab::THREADS)
fused_gather_fold_kernel(const uint32_t* __restrict__ db,
                         const int32_t* __restrict__ idx,
                         uint32_t* __restrict__ out, int n, int w, int q,
                         int m, int block_w, int lw, int all_queries,
                         int vec4) {
  extern __shared__ __align__(16) uint32_t slab[];  // [n][bw]

  const int tile_lo = blockIdx.x * block_w;
  const int bw = min(block_w, w - tile_lo);
  pir_slab::stage(slab, db, n, w, tile_lo, bw, vec4);

  const int q_lo = all_queries ? 0 : blockIdx.y;
  const int q_hi = all_queries ? q : blockIdx.y + 1;
  for (int b = q_lo; b < q_hi; ++b)
    pir_slab::fold_row(slab, idx + (long long)b * m,
                       out + (long long)b * w + tile_lo, n, m, bw, lw);
}

}  // namespace

// out must be zeroed by the caller; n * min(block_w, w) * 4 bytes must fit
// the opt-in dynamic shared memory of a block (the caller's gate).
PIR_EXPORT int pir_fused_gather_fold(const void* db, const void* idx,
                                     void* out, int n, int w, int q, int m,
                                     int block_w, int all_queries,
                                     void* stream) {
  if (n <= 0 || w <= 0 || q <= 0 || m <= 0 || block_w <= 0) return 0;
  const int bw = block_w < w ? block_w : w;
  const int lw = pir_slab::lanes_for(bw);
  const size_t smem = (size_t)n * bw * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      fused_gather_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int w_tiles = pir_ceil_div(w, bw);
  const int vec4 = (w % 4 == 0) && (bw % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(db) % 16 == 0);
  dim3 grid(w_tiles, all_queries ? 1 : q), block(pir_slab::THREADS);
  fused_gather_fold_kernel<<<grid, block, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      (const uint32_t*)db, (const int32_t*)idx, (uint32_t*)out, n, w, q, m,
      bw, lw, all_queries, vec4);
  return (int)cudaGetLastError();
}
