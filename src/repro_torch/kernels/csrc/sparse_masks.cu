// sparse_masks: the Sparse-PIR plan's [d, B, n] uint8 masks, drawn and
// written in one pass. Column (b, j) of batch row b gets Hamming weight
// w = w_q[b] at j == q_idx[b] and w_even[b, j] elsewhere, and its ones sit
// on a uniformly random w-subset of the d server slots, independent of
// every other column; out[s, b, j] = 1 where slot s is in that subset.
//
// Replaces no Pallas kernel: the reference draws the subset with
// `jnp.argsort` of d uniforms a column (src/repro/core/sparse.py:109, the
// slot ranks) and compares the ranks with w. The port did the same with
// torch's rand + argsort + scatter + compare + a permuted copy, which moved
// ~50x the output's bytes through B*n*d float32 uniforms, int64 sort
// orders and two [B, n, d] u8 tensors.
//
// Bound: bytes. The output is d*B*n bytes (1.28e10 at B = 128, n = 1e6,
// d = 100: 3.82 ms at 3.35 TB/s), the weights B*n more; nothing else of
// size B*n*d exists. The draws are integer work: ~12 Philox calls a column
// at d = 100, theta = 0.25 (Floyd's steps, two 64-bit draws a call).
//
// Design:
// - Floyd's algorithm draws the subset in min(w, d - w) steps (where
//   w > d/2 it draws the d - w zeros and flips): step i takes
//   t uniform in [0, d - k + i] and inserts t, or d - k + i if t is taken.
// - Randomness: Philox4x32-10 with the plan's 64-bit key (key[0], key[1],
//   the low 32 bits of each) and counter (col lo, col hi, i / 2, 0), col =
//   b*n + j the column's global id, so a column's bits depend on neither
//   the launch geometry nor the other columns; each call gives two 64-bit
//   draws, step i takes words (0, 1) or (2, 3) as (lo, hi).
// - A 64-bit draw x maps to [0, k) by multiply-high, floor(x * k / 2^64),
//   so each outcome has probability within 2^-64 of 1/k. (The float32
//   argsort it replaces tied with probability ~C(100, 2) / 2^24 ~ 3e-4 a
//   column, and the stable sort then favoured low slots.)
// - A thread takes RUN = 16 consecutive columns of one batch row, so for
//   each server s it writes out[s, b, j0 .. j0+16) as one 16-byte store
//   where that address is 16-byte aligned (always, when n % 16 == 0), and
//   as byte stores at a ragged edge or an unaligned row. Neighbouring
//   threads take neighbouring runs: a warp writes 512 contiguous bytes of
//   a row per server. Offsets are 64-bit (the output passes 2^31 bytes).
// - The sets live in shared memory, 4 columns interleaved: word x of the
//   thread's group g (columns 4g .. 4g+3) holds slots 8x .. 8x+7, slot s
//   of column 4g + l at bit 4 * (s % 8) + l. A step's test and insertion
//   are then one load and one store at a computed address, and a store's
//   16 bytes are 4 nibbles, each spread to 4 bytes by one multiply. The
//   words sit [word][thread], so a warp's accesses fall on 32 banks. NW =
//   ceil(d/32) (1, 2, 4 or 8, a template argument read from d) sizes them:
//   16 * NW words a thread. (Holding the 16 sets in registers instead took
//   24.5 ms at B = 128, n = 1e6, d = 100 against 11.7: the selects among a
//   column's words, and the bit-by-bit transpose for the stores, cost more
//   ALU work than the shared-memory traffic.)
// - The key is read from device memory: no host round trip; the kernel
//   allocates nothing and launches on the caller's stream.
//
// kernels/sparse_masks.py::sparse_masks_plain repeats these steps in torch
// int64 arithmetic; the two agree bit for bit.
#include "common.cuh"

namespace {

constexpr int RUN = 16;

// threads a block and words a group of 4 columns: 32 KB of shared memory
// a block at NW 4 and 8
template <int NW>
struct Shape {
  static constexpr int THREADS = NW == 8 ? 64 : 128;
  static constexpr int GROUP_WORDS = 4 * NW;
};

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    c[0] = hi1 ^ c[1] ^ k0;
    c[1] = lo1;
    c[2] = hi0 ^ c[3] ^ k1;
    c[3] = lo0;
  }
}

// One Floyd step of column l of a group whose words start at `words`
// (stride STRIDE): t = floor((hi:lo) * (j + 1) / 2^64); insert t, or j if
// t is taken.
template <int STRIDE>
__device__ __forceinline__ void floyd_step(uint32_t* words, uint32_t lo,
                                           uint32_t hi, uint32_t j, int l) {
  const unsigned long long p = (unsigned long long)lo * (j + 1);
  const uint32_t t =
      (uint32_t)(((unsigned long long)hi * (j + 1) + (p >> 32)) >> 32);
  const uint32_t word = words[(t >> 3) * STRIDE];
  const uint32_t slot = ((word >> (4 * (t & 7) + l)) & 1u) ? j : t;
  words[(slot >> 3) * STRIDE] |= 1u << (4 * (slot & 7) + l);
}

template <int NW>
__global__ void __launch_bounds__(Shape<NW>::THREADS)
sparse_masks_kernel(const uint8_t* __restrict__ w_even,
                    const uint8_t* __restrict__ w_q,
                    const long long* __restrict__ q_idx,
                    const long long* __restrict__ key,
                    uint8_t* __restrict__ out, int B, int n, int d) {
  constexpr int T = Shape<NW>::THREADS;
  constexpr int GW = Shape<NW>::GROUP_WORDS;
  __shared__ uint32_t sets[RUN / 4 * GW][T];
  const long long runs = ((long long)n + RUN - 1) / RUN;
  const long long tid = (long long)blockIdx.x * T + threadIdx.x;
  if (tid >= (long long)B * runs) return;
  const int b = (int)(tid / runs);
  const long long j0 = (tid - (long long)b * runs) * RUN;
  const int len = (int)min((long long)RUN, (long long)n - j0);
  const uint32_t k0 = (uint32_t)__ldg(key);
  const uint32_t k1 = (uint32_t)__ldg(key + 1);
  const long long q = __ldg(q_idx + b);
  const long long row = (long long)b * n;

#pragma unroll
  for (int x = 0; x < RUN / 4 * GW; ++x) sets[x][threadIdx.x] = 0;
  uint32_t flips = 0;  // bit c: column c drew its zeros
  for (int c = 0; c < len; ++c) {
    const long long j = j0 + c;
    const int w = j == q ? __ldg(w_q + b) : __ldg(w_even + row + j);
    const bool flip = 2 * w > d;
    const int k = flip ? d - w : w;
    flips |= (uint32_t)flip << c;
    uint32_t* words = &sets[(c >> 2) * GW][threadIdx.x];
    const unsigned long long col = (unsigned long long)(row + j);
    for (int i = 0; i < k; i += 2) {  // two steps a Philox call
      uint32_t r[4] = {(uint32_t)col, (uint32_t)(col >> 32),
                       (uint32_t)(i >> 1), 0u};
      philox4x32_10(r, k0, k1);
      const uint32_t top = (uint32_t)(d - k + i);
      floyd_step<T>(words, r[0], r[1], top, c & 3);
      if (i + 1 < k) floyd_step<T>(words, r[2], r[3], top + 1, c & 3);
    }
  }

  const long long plane = (long long)B * n;
  uint8_t* base = out + row + j0;
  for (int x = 0; x < GW; ++x) {  // slots 8x .. 8x+7
    uint32_t group[RUN / 4];
#pragma unroll
    for (int g = 0; g < RUN / 4; ++g) group[g] = sets[g * GW + x][threadIdx.x];
#pragma unroll
    for (int sub = 0; sub < 8; ++sub) {
      const int s = x * 8 + sub;
      if (s >= d) break;
      uint32_t p[RUN / 4];  // byte l of p[g]: column 4g + l
#pragma unroll
      for (int g = 0; g < RUN / 4; ++g)
        p[g] = ((((group[g] >> (4 * sub)) ^ (flips >> (4 * g))) & 0xFu) *
                0x00204081u) & 0x01010101u;
      uint8_t* dst = base + (long long)s * plane;
      if (len == RUN && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(p[0], p[1], p[2], p[3]);
      } else {
#pragma unroll
        for (int c = 0; c < RUN; ++c)
          if (c < len) dst[c] = (uint8_t)(p[c >> 2] >> (8 * (c & 3)));
      }
    }
  }
}

template <int NW>
cudaError_t launch(const void* w_even, const void* w_q, const void* q_idx,
                   const void* key, void* out, int B, int n, int d,
                   cudaStream_t s) {
  constexpr int T = Shape<NW>::THREADS;
  const long long threads = (long long)B * (((long long)n + RUN - 1) / RUN);
  const long long blocks = (threads + T - 1) / T;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  sparse_masks_kernel<NW><<<(unsigned)blocks, T, 0, s>>>(
      (const uint8_t*)w_even, (const uint8_t*)w_q, (const long long*)q_idx,
      (const long long*)key, (uint8_t*)out, B, n, d);
  return cudaGetLastError();
}

}  // namespace

// w_even: [B, n] uint8; w_q: [B] uint8; q_idx: [B] int64; key: [2] int64;
// out: [d, B, n] uint8, every byte written. 1 <= d <= 255.
PIR_EXPORT int pir_sparse_masks(const void* w_even, const void* w_q,
                                const void* q_idx, const void* key, void* out,
                                int B, int n, int d, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d > 255) return (int)cudaErrorInvalidValue;
  if (d <= 32) return (int)launch<1>(w_even, w_q, q_idx, key, out, B, n, d, s);
  if (d <= 64) return (int)launch<2>(w_even, w_q, q_idx, key, out, B, n, d, s);
  if (d <= 128)
    return (int)launch<4>(w_even, w_q, q_idx, key, out, B, n, d, s);
  return (int)launch<8>(w_even, w_q, q_idx, key, out, B, n, d, s);
}
