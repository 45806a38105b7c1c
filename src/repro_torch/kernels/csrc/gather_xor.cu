// gather_xor: out[q, :] = XOR_{j : idx[q, j] >= 0} db[idx[q, j], :]
//
// Replaces the TPU kernel of the reference package's kernels/gather_xor.py
// (`_kernel`: scalar-prefetched indices drive one row DMA per grid step).
//
// Bound: bytes. Only the selected rows are touched; the least time is the
// distinct live rows x W*4 bytes + the index bytes + the output, over the
// memory rate.
//
// Design: scalar prefetch becomes "the block reads its own indices". A
// block owns (query, word tile, index chunk): TX lanes cover the word
// tile with 16 B loads where W allows, TY lanes walk the chunk's indices
// in turn and fetch rows by pointer arithmetic; padding (idx < 0) is
// predicated. A serving batch has only q x ceil(W / block_w) output
// tiles, too few for the card, so the index walk is split across blocks
// and partial folds are combined with atomicXor into a zeroed output
// (bit-exact and deterministic: XOR is associative and commutative).
// grid_order chooses which of blockIdx.y / blockIdx.z walks queries and
// which walks word tiles; every order and block_w gives identical bits.
#include "common.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 8;

template <int VEC>
__global__ void __launch_bounds__(TX * TY)
gather_xor_kernel(const uint32_t* __restrict__ db,
                  const int32_t* __restrict__ idx,
                  uint32_t* __restrict__ out, int n, int w, int q, int m,
                  int block_w, int idx_per_block, int q_on_z) {
  __shared__ uint32_t sred[TY][TX * VEC];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b = q_on_z ? blockIdx.z : blockIdx.y;   // query
  const int jt = q_on_z ? blockIdx.y : blockIdx.z;  // word tile
  const int tile_lo = jt * block_w;
  const int tile_hi = min(w, tile_lo + block_w);
  const long long j_begin = (long long)blockIdx.x * idx_per_block;
  const int j_end = (int)min((long long)m, j_begin + idx_per_block);
  const int32_t* my_idx = idx + (long long)b * m;

  for (int wbase = tile_lo; wbase < tile_hi; wbase += TX * VEC) {
    const int w0 = wbase + tx * VEC;
    const bool w_ok = w0 < tile_hi;  // VEC==4: tile bounds are 4-aligned
    uint32_t acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0u;

    if (w_ok) {
#pragma unroll 4
      for (int j = (int)j_begin + ty; j < j_end; j += TY) {
        const int32_t row = __ldg(my_idx + j);
        if (row >= 0 && row < n) {
          const uint32_t* p = db + (long long)row * w + w0;
          if constexpr (VEC == 4) {
            const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
            acc[0] ^= t.x; acc[1] ^= t.y; acc[2] ^= t.z; acc[3] ^= t.w;
          } else {
            acc[0] ^= __ldg(p);
          }
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int v = 0; v < VEC; ++v) sred[ty][tx * VEC + v] = acc[v];
    __syncthreads();
    for (int c = ty * TX + tx; c < TX * VEC; c += TX * TY) {
      uint32_t r = 0u;
#pragma unroll
      for (int y = 0; y < TY; ++y) r ^= sred[y][c];
      const int wc = wbase + c;
      if (r != 0u && wc < tile_hi)
        atomicXor(out + (long long)b * w + wc, r);
    }
  }
}

}  // namespace

// out must be zeroed by the caller. q_on_z = 1 puts queries on the slow
// grid axis ("qwm"), 0 puts word tiles there ("wqm").
PIR_EXPORT int pir_gather_xor(const void* db, const void* idx, void* out,
                              int n, int w, int q, int m, int block_w,
                              int q_on_z, void* stream) {
  if (n <= 0 || w <= 0 || q <= 0 || m <= 0 || block_w <= 0) return 0;
  const bool vec4 = (w % 4 == 0) && (block_w % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(db) % 16 == 0);
  const int w_tiles = pir_ceil_div(w, block_w);
  long long want_chunks = 2048 / ((long long)w_tiles * q) + 1;
  long long per = (m + want_chunks - 1) / want_chunks;
  const long long min_per = 4 * TY;  // keep a few loads in flight per lane
  if (per < min_per) per = min_per;
  const int m_chunks = pir_ceil_div(m, per);
  dim3 grid(m_chunks, q_on_z ? w_tiles : q, q_on_z ? q : w_tiles);
  dim3 block(TX, TY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4)
    gather_xor_kernel<4><<<grid, block, 0, s>>>(
        (const uint32_t*)db, (const int32_t*)idx, (uint32_t*)out, n, w, q, m,
        block_w, (int)per, q_on_z);
  else
    gather_xor_kernel<1><<<grid, block, 0, s>>>(
        (const uint32_t*)db, (const int32_t*)idx, (uint32_t*)out, n, w, q, m,
        block_w, (int)per, q_on_z);
  return (int)cudaGetLastError();
}
