// The [n, BW] db slab in shared memory and the index walk over it: the
// staging and fold code shared by fused_gather_fold.cu (one index row per
// query) and fused_multi_gather_fold.cu (k_max index rows per request).
//
// A block is THREADS threads laid out as lw lanes along the slab's words by
// THREADS / lw lanes along indices. The slab takes all the shared memory the
// caller's gate allows, so the block keeps no reduction scratch there: after
// its walk a warp folds its index lanes with shuffles and adds its partial
// to the zeroed output with atomicXor (bit-exact in any order).
#pragma once
#include "common.cuh"

namespace pir_slab {

constexpr int THREADS = 256;
constexpr int MAXV = 4;  // words per lane per pass: 32 lanes x 4 = 128

// Lanes along words for a word tile of bw words: the next power of two
// >= bw, at most a warp.
static inline int lanes_for(int bw) {
  int lw = 1;
  while (lw < bw && lw < 32) lw <<= 1;
  return lw;
}

// Stage db[:, tile_lo : tile_lo + bw] into slab ([n][bw]). Consecutive
// threads read consecutive words of a row, 16 B at a time where the row
// pieces are 16 B aligned (vec4 is the host's statement that db is, and
// that w and block_w are multiples of 4; a ragged last tile falls back to
// single words): one block stages up to 227 KB alone, so the staging is
// bound by load latency, not bandwidth. Ends in a barrier.
__device__ __forceinline__ void stage(uint32_t* slab,
                                      const uint32_t* __restrict__ db, int n,
                                      int w, int tile_lo, int bw, int vec4) {
  const int tid = threadIdx.x;
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
}

// out_row[c] ^= XOR_{j : 0 <= idx_row[j] < n} slab[idx_row[j]][c] for every
// c < bw, out_row pointing at the tile's first word of one output row.
// Every thread of the block must call it (the shuffles take whole warps).
__device__ __forceinline__ void fold_row(const uint32_t* slab,
                                         const int32_t* __restrict__ idx_row,
                                         uint32_t* __restrict__ out_row, int n,
                                         int m, int bw, int lw) {
  const int tid = threadIdx.x;
  const int tx = tid % lw;  // lane along words
  const int ty = tid / lw;  // lane along indices
  const int rows_par = THREADS / lw;
  for (int wbase = 0; wbase < bw; wbase += lw * MAXV) {
    uint32_t acc[MAXV];
#pragma unroll
    for (int v = 0; v < MAXV; ++v) acc[v] = 0u;
    for (int j = ty; j < m; j += rows_par) {
      const int32_t row = __ldg(idx_row + j);
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
      if ((tid % 32) < lw && c < bw && r != 0u) atomicXor(out_row + c, r);
    }
  }
}

}  // namespace pir_slab
