// parity_matmul: out = (mask @ planes) mod 2 over 0/1 operands.
//   mask [q, n] uint8, planes [n, B] uint8 -> out [q, B] uint8 bits.
//
// Replaces the TPU kernel of the reference package's
// kernels/parity_matmul.py (`_kernel`: bf16 operands, fp32 accumulator in
// scratch, mod-2 epilogue on the last n step).
//
// Bound: the larger of 2*q*n*B integer operations over the card's int8
// peak and (q*n + n*B + q*B) bytes over its memory rate. On an H100
// (1979e12 int8 operations/s, 3.35e12 bytes/s) the planes' bytes dominate
// below q of about 300 and the operations above.
//
// Design: a shared-memory tiled product with exact integer accumulation.
// The uint8 operands are packed four along n into 32-bit words as they
// are staged, so the inner loop is __dp4a (4 multiply-adds per
// instruction) into 32-bit accumulators: exact for every n < 2^31, and no
// widened copy of the operands ever exists in device memory. A block of
// 16 x 16 threads owns a 64 x 64 output tile (4 x 4 per thread) and walks
// n in steps of 64. The epilogue keeps `acc & 1`, so only bits are
// written. Ragged q, n and B are predicated while staging.
#include "common.cuh"

namespace {

constexpr int BM = 64;  // queries per tile
constexpr int BN = 64;  // bit columns per tile
constexpr int BK = 64;  // n per step (bytes) = 16 packed words
constexpr int KW = BK / 4;
constexpr int TPB = 256;

__global__ void __launch_bounds__(TPB)
parity_matmul_kernel(const uint8_t* __restrict__ mask,
                     const uint8_t* __restrict__ planes,
                     uint8_t* __restrict__ out, int q, int n, int b) {
  __shared__ uint32_t sa[BM][KW + 1];  // [query][k word], padded
  __shared__ uint32_t sb[KW][BN];      // [k word][column]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;

  unsigned int acc[4][4];  // exact for n < 2^32 summands
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0u;

  uint8_t* sa8 = reinterpret_cast<uint8_t*>(&sa[0][0]);
  uint8_t* sb8 = reinterpret_cast<uint8_t*>(&sb[0][0]);

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();
    // mask tile: BM x BK bytes, coalesced along n
    for (int e = tid; e < BM * BK; e += TPB) {
      const int r = e / BK, kk = e % BK;
      uint8_t v = 0;
      if (row0 + r < q && k0 + kk < n)
        v = mask[(long long)(row0 + r) * n + k0 + kk] != 0;
      sa8[(r * (KW + 1)) * 4 + kk] = v;
    }
    // planes tile: BK x BN bytes, coalesced along the bit columns, stored
    // with the four n-neighbours of a column in one word
    for (int e = tid; e < BK * BN; e += TPB) {
      const int kk = e / BN, c = e % BN;
      uint8_t v = 0;
      if (k0 + kk < n && col0 + c < b)
        v = planes[(long long)(k0 + kk) * b + col0 + c] != 0;
      sb8[((kk / 4) * BN + c) * 4 + (kk % 4)] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      uint32_t a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sa[ty * 4 + i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = sb[kw][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __dp4a(a[i], bb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < b) out[(long long)r * b + c] = (uint8_t)(acc[i][j] & 1u);
    }
  }
}

}  // namespace

PIR_EXPORT int pir_parity_matmul(const void* mask, const void* planes,
                                 void* out, int q, int n, int b,
                                 void* stream) {
  if (q <= 0 || b <= 0) return 0;
  dim3 grid(pir_ceil_div(b, BN), pir_ceil_div(q, BM)), block(TPB);
  parity_matmul_kernel<<<grid, block, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      (const uint8_t*)mask, (const uint8_t*)planes, (uint8_t*)out, q, n, b);
  return (int)cudaGetLastError();
}
