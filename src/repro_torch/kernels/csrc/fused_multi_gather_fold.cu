// fused_multi_gather_fold: the jagged multi-index answer with the [n, BW]
// db slab resident on chip. Output row r*k_max + i is the XOR of the slab
// rows named by idx[r*k_max + i] when i < offsets[r+1] - offsets[r], and
// zero otherwise, whatever that index row holds.
//
// Replaces the TPU kernel of the reference package's kernels/fused.py
// (`_multi_kernel`: the jagged descriptor in scalar memory, one grid step
// per (request, word block) folding all k_max index rows of the request
// against the resident block).
//
// Bound: bytes, as for fused_gather_fold: the distinct rows the LIVE index
// rows name, the live index rows and the output, over the memory rate. The
// kernel reads the whole slab once per block that stages it ("wr": once
// per word block for the whole batch; "rw": once per request, against
// once per index row for the flat kernel in "qw" order).
//
// Design: the staging and the index walk are fused_gather_fold's
// (fused_slab.cuh). A block reads its request's count from the offsets in
// device memory and folds only the live rows; a dead row keeps the zeros
// the caller wrote and its indices are never read. In "rw" order a block
// serves one request; in "wr" order one block per word block stages the
// slab once and loops over every request.
#include "fused_slab.cuh"

namespace {

__global__ void __launch_bounds__(pir_slab::THREADS)
fused_multi_gather_fold_kernel(const uint32_t* __restrict__ db,
                               const int32_t* __restrict__ idx,
                               const int32_t* __restrict__ offsets,
                               uint32_t* __restrict__ out, int n, int w,
                               int requests, int k_max, int m, int block_w,
                               int lw, int all_requests, int vec4) {
  extern __shared__ __align__(16) uint32_t slab[];  // [n][bw]

  const int tile_lo = blockIdx.x * block_w;
  const int bw = min(block_w, w - tile_lo);
  pir_slab::stage(slab, db, n, w, tile_lo, bw, vec4);

  const int r_lo = all_requests ? 0 : blockIdx.y;
  const int r_hi = all_requests ? requests : blockIdx.y + 1;
  for (int r = r_lo; r < r_hi; ++r) {
    // the same count for every thread of the block: the fold's shuffles
    // stay whole-warp
    const int count = __ldg(offsets + r + 1) - __ldg(offsets + r);
    const int live = max(0, min(count, k_max));
    for (int i = 0; i < live; ++i) {
      const long long row = (long long)r * k_max + i;
      pir_slab::fold_row(slab, idx + row * m, out + row * w + tile_lo, n, m,
                         bw, lw);
    }
  }
}

}  // namespace

// out ([requests * k_max, w]) must be zeroed by the caller; offsets is
// [requests + 1] in device memory; n * min(block_w, w) * 4 bytes must fit
// the opt-in dynamic shared memory of a block (the caller's gate).
PIR_EXPORT int pir_fused_multi_gather_fold(const void* db, const void* idx,
                                           const void* offsets, void* out,
                                           int n, int w, int requests,
                                           int k_max, int m, int block_w,
                                           int all_requests, void* stream) {
  if (n <= 0 || w <= 0 || requests <= 0 || k_max <= 0 || m <= 0 ||
      block_w <= 0)
    return 0;
  const int bw = block_w < w ? block_w : w;
  const int lw = pir_slab::lanes_for(bw);
  const size_t smem = (size_t)n * bw * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      fused_multi_gather_fold_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int w_tiles = pir_ceil_div(w, bw);
  const int vec4 = (w % 4 == 0) && (bw % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(db) % 16 == 0);
  dim3 grid(w_tiles, all_requests ? 1 : requests), block(pir_slab::THREADS);
  fused_multi_gather_fold_kernel<<<grid, block, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      (const uint32_t*)db, (const int32_t*)idx, (const int32_t*)offsets,
      (uint32_t*)out, n, w, requests, k_max, m, bw, lw, all_requests, vec4);
  return (int)cudaGetLastError();
}
