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
// of 227 KB a block, which the Python gate `fused_block_w` enforces; all
// of it goes to the slab, so the block keeps no reduction scratch there),
// staged with 16 B loads where the rows allow it: one block stages up to
// 227 KB alone, so the staging is bound by load latency, not bandwidth.
// A block is 256 threads laid out as LW lanes along the slab's words by
// 256/LW lanes along indices. After its walk a warp folds its row lanes
// with shuffles and adds its partial to the zeroed output with atomicXor
// (bit-exact in any order). In "qw" order a block serves one query; in
// "wq" order one block per word block stages the slab once and loops
// over every query of the batch.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAXV = 4;  // words per lane per pass: 32 lanes x 4 = 128

__global__ void __launch_bounds__(THREADS)
fused_gather_fold_kernel(const uint32_t* __restrict__ db,
                         const int32_t* __restrict__ idx,
                         uint32_t* __restrict__ out, int n, int w, int q,
                         int m, int block_w, int lw, int all_queries,
                         int vec4) {
  extern __shared__ __align__(16) uint32_t slab[];  // [n][bw]

  const int tid = threadIdx.x;
  const int tile_lo = blockIdx.x * block_w;
  const int bw = min(block_w, w - tile_lo);

  // stage the slab: consecutive threads read consecutive words of a row,
  // 16 B at a time where the row pieces are 16 B aligned (vec4 is the
  // host's statement that db is, and that w and block_w are multiples of
  // 4; a ragged last tile falls back to single words)
  if (vec4 && bw % 4 == 0) {
    const int bw4 = bw / 4;
    const int total4 = n * bw4;  // the slab fits shared memory: int range
    const uint4* db4 = reinterpret_cast<const uint4*>(db);
    uint4* slab4 = reinterpret_cast<uint4*>(slab);
    const long long row4 = w / 4, lo4 = tile_lo / 4;
#pragma unroll 4
    for (int e = tid; e < total4; e += THREADS) {
      const int i = e / bw4, c = e % bw4;
      slab4[e] = __ldg(db4 + i * row4 + lo4 + c);
    }
  } else {
    const int total = n * bw;
#pragma unroll 4
    for (int e = tid; e < total; e += THREADS) {
      const int i = e / bw, c = e % bw;
      slab[e] = __ldg(db + (long long)i * w + tile_lo + c);
    }
  }
  __syncthreads();

  const int tx = tid % lw;        // lane along words
  const int ty = tid / lw;        // lane along indices
  const int rows_par = THREADS / lw;
  const int q_lo = all_queries ? 0 : blockIdx.y;
  const int q_hi = all_queries ? q : blockIdx.y + 1;

  for (int b = q_lo; b < q_hi; ++b) {
    const int32_t* my_idx = idx + (long long)b * m;
    for (int wbase = 0; wbase < bw; wbase += lw * MAXV) {
      uint32_t acc[MAXV];
#pragma unroll
      for (int v = 0; v < MAXV; ++v) acc[v] = 0u;
      for (int j = ty; j < m; j += rows_par) {
        const int32_t row = __ldg(my_idx + j);
        if (row >= 0 && row < n) {
          const uint32_t* p = slab + (long long)row * bw + wbase + tx;
#pragma unroll
          for (int v = 0; v < MAXV; ++v)
            if (wbase + tx + v * lw < bw) acc[v] ^= p[v * lw];
        }
      }
#pragma unroll
      for (int v = 0; v < MAXV; ++v) {
        // lanes of one warp that share tx hold different index rows
        const uint32_t r = pir_warp_xor_rows(acc[v], lw);
        const int c = wbase + tx + v * lw;
        if ((tid % 32) < lw && c < bw && r != 0u)
          atomicXor(out + (long long)b * w + tile_lo + c, r);
      }
    }
  }
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
  int lw = 1;
  while (lw < bw && lw < 32) lw <<= 1;
  const size_t smem = (size_t)n * bw * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      fused_gather_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int w_tiles = pir_ceil_div(w, bw);
  const int vec4 = (w % 4 == 0) && (bw % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(db) % 16 == 0);
  dim3 grid(w_tiles, all_queries ? 1 : q), block(THREADS);
  fused_gather_fold_kernel<<<grid, block, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      (const uint32_t*)db, (const int32_t*)idx, (uint32_t*)out, n, w, q, m,
      bw, lw, all_queries, vec4);
  return (int)cudaGetLastError();
}
