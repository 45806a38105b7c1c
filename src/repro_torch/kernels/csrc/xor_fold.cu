// xor_fold: out[q, :] = XOR_{i : mask[q, i] != 0} db[i, :]
//
// Replaces the TPU kernel of the reference package's kernels/xor_fold.py
// (`_kernel`, grid (q-blocks, w-blocks, n-blocks) with n innermost).
//
// Bound: bytes. Every db word is read once per tile of QT queries and does
// one AND+XOR per query: ~1 integer op per byte, far below the card's
// op/byte balance, so the least time is (n*W*4 + q*n + q*W*4) bytes over
// the memory rate.
//
// Design: the TPU grid's sequential n axis becomes a loop inside the
// block. An output tile alone (QT queries x TW words) gives far too few
// blocks to fill the card at serving batch sizes, so the record axis is
// also split across blocks; partial folds are combined with atomicXor
// into a zeroed output (XOR is associative and commutative: bit-exact and
// deterministic in any order). A block is TX x TY threads: TX lanes cover
// the word tile (16 B per thread when W allows), TY lanes take rows in
// turn. The mask tile for the block's rows is staged in shared memory
// transposed ([row][query]) so one broadcast read serves all QT queries.
// The ragged edges of q, n and W are predicated, never padded.
#include "common.cuh"

namespace {

constexpr int QT = 8;    // queries per block (accumulators in registers)
constexpr int TX = 32;   // lanes along words
constexpr int TY = 8;    // lanes along rows
constexpr int MROWS = 512;  // mask rows staged per step

template <int VEC>
__global__ void __launch_bounds__(TX * TY)
xor_fold_kernel(const uint32_t* __restrict__ db,
                const uint8_t* __restrict__ mask,
                uint32_t* __restrict__ out, int n, int w, int q,
                int rows_per_block) {
  __shared__ __align__(8) uint8_t smask[MROWS * QT];
  __shared__ uint32_t sred[TY][QT][TX * VEC];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int w0 = (blockIdx.y * TX + tx) * VEC;
  const int q0 = blockIdx.z * QT;
  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  const long long r_end_ll = r_begin + rows_per_block;
  const int r_end = (int)(r_end_ll < n ? r_end_ll : n);
  const bool w_ok = w0 < w;  // VEC==4 implies w % 4 == 0

  uint32_t acc[QT][VEC];
#pragma unroll
  for (int a = 0; a < QT; ++a)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[a][v] = 0u;

  for (int rs = (int)r_begin; rs < r_end; rs += MROWS) {
    const int rcount = min(MROWS, r_end - rs);
    __syncthreads();
    for (int e = tid; e < MROWS * QT; e += TX * TY) {
      const int a = e / MROWS, r = e % MROWS;  // coalesced along rows
      uint8_t m = 0;
      if (r < rcount && q0 + a < q)
        m = mask[(long long)(q0 + a) * n + rs + r] != 0;
      smask[r * QT + a] = m;
    }
    __syncthreads();
    if (w_ok) {
#pragma unroll 4
      for (int r = ty; r < rcount; r += TY) {
        const uint32_t* p = db + (long long)(rs + r) * w + w0;
        uint32_t val[VEC];
        if constexpr (VEC == 4) {
          const uint4 t = *reinterpret_cast<const uint4*>(p);
          val[0] = t.x; val[1] = t.y; val[2] = t.z; val[3] = t.w;
        } else {
          val[0] = *p;
        }
        const uint2 mm = *reinterpret_cast<const uint2*>(&smask[r * QT]);
        const uint32_t mw[2] = {mm.x, mm.y};
#pragma unroll
        for (int a = 0; a < QT; ++a) {
          const uint32_t sel = 0u - ((mw[a >> 2] >> (8 * (a & 3))) & 1u);
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[a][v] ^= val[v] & sel;
        }
      }
    }
  }

  // fold the TY row lanes, then one atomicXor per output word
#pragma unroll
  for (int a = 0; a < QT; ++a)
#pragma unroll
    for (int v = 0; v < VEC; ++v) sred[ty][a][tx * VEC + v] = acc[a][v];
  __syncthreads();
  for (int e = tid; e < QT * TX * VEC; e += TX * TY) {
    const int a = e / (TX * VEC), c = e % (TX * VEC);
    uint32_t r = 0u;
#pragma unroll
    for (int y = 0; y < TY; ++y) r ^= sred[y][a][c];
    const int wc = blockIdx.y * TX * VEC + c;
    if (r != 0u && q0 + a < q && wc < w)
      atomicXor(out + (long long)(q0 + a) * w + wc, r);
  }
}

}  // namespace

// out must be zeroed by the caller. Returns cudaGetLastError().
PIR_EXPORT int pir_xor_fold(const void* db, const void* mask, void* out,
                            int n, int w, int q, void* stream) {
  if (n <= 0 || w <= 0 || q <= 0) return 0;
  const bool vec4 = (w % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(db) % 16 == 0);
  const int vec = vec4 ? 4 : 1;
  const int w_tiles = pir_ceil_div(w, TX * vec);
  const int q_tiles = pir_ceil_div(q, QT);
  // enough row chunks to keep every SM busy several times over, but no
  // chunk shorter than one staged mask tile
  long long want_chunks = 2048 / ((long long)w_tiles * q_tiles) + 1;
  long long rows = (n + want_chunks - 1) / want_chunks;
  rows = ((rows + MROWS - 1) / MROWS) * MROWS;
  const int n_chunks = pir_ceil_div(n, rows);
  dim3 grid(n_chunks, w_tiles, q_tiles), block(TX, TY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4)
    xor_fold_kernel<4><<<grid, block, 0, s>>>(
        (const uint32_t*)db, (const uint8_t*)mask, (uint32_t*)out, n, w, q,
        (int)rows);
  else
    xor_fold_kernel<1><<<grid, block, 0, s>>>(
        (const uint32_t*)db, (const uint8_t*)mask, (uint32_t*)out, n, w, q,
        (int)rows);
  return (int)cudaGetLastError();
}
