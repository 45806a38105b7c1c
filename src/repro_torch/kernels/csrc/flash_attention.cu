// flash_attention_fwd: out = softmax(mask(q k^T / sqrt(d))) v per (batch*head)
// row, with an online softmax so the [Sq, Sk] score matrix never leaves the
// chip. Masks by absolute position from 0: kpos <= qpos if causal, then
// kpos > qpos - window if a window is set. Masked scores take the finite
// value -1e30 (not -inf), the padding keys >= sk take -inf, the f32 carry
// is (acc, m, l), and the epilogue is acc / max(l, 1e-30) cast to the
// input type.
//
// Replaces the TPU kernel of the reference package's
// kernels/flash_attention.py (`_kernel`: a grid (B*H, q blocks, kv blocks)
// with kv innermost, carrying acc/m/l in VMEM scratch across grid steps).
//
// Bound: operations. The work is 4 * (unmasked q,k pairs) * d flops (the
// two products) against 4 * (Sq + 2 Sk + Sq) * d bytes of Q/K/V/O per row
// at f32; at the LM's shapes (S = 4096, d = 64) that is about 600 flops a
// byte, far above the card's ridge point. This kernel runs the products on
// the CUDA cores in f32 (no tensor cores yet), so its ceiling is the f32
// FMA rate, not the bf16 tensor-core rate the bound is taken at.
//
// Design (a first kernel that is right and simple, not yet fast):
// - One block of 256 threads per (bh, 64-row q tile); the blocks of the
//   last q tiles, which see the most keys under a causal mask, go first.
//   A loop over 64-key tiles takes the place of the TPU's sequential kv
//   grid axis, and the carry lives in registers.
// - q (scaled once), k and v are converted to f32 as they are staged into
//   shared memory; q and k are stored transposed ([d][64 + 4]) so that a
//   thread reads four rows (or four keys) of one column as one float4.
// - The threads form a 16 x 16 grid: thread (tx, ty) computes the 4 x 4
//   scores of rows 4ty.. and keys 4tx.. (register tiling), takes the row
//   max and row sum over the 16 lanes of its half-warp with shuffles, and
//   writes its probabilities transposed to shared memory for the P.V
//   product, where it owns 4 rows x d/16 output columns.
// - Ragged edges (rows >= Sq, keys >= Sk, columns >= d) are zero-filled in
//   shared memory, which is what the reference's zero padding of Sq and Sk
//   does. Keys >= Sk take -inf, not -1e30, so p = 0 there exactly: a row
//   that the mask empties (Sq > Sk with a window) averages its Sk real
//   keys, as the plain version does, and the padding never enters l. The
//   last key tile always holds a real key, so m stays finite. Head dims
//   up to 256 are taken by padding the column count to the next of 16,
//   32, 64, 128, 256 in the tiles.
// - Key tiles that the mask empties for every row of the q tile are
//   skipped: those after the diagonal under a causal mask, and, with a
//   window and Sq <= Sk, those before the window. Both skips give the same
//   bits as computing them: after the diagonal p = exp(-1e30 - m) = 0 and
//   alpha = 1; before the window the finite -1e30 gives p = 1 garbage that
//   the first tile holding a real key wipes with alpha = exp(-1e30 - m) = 0
//   (a row under a causal mask with window >= 1 always holds its diagonal
//   key).
// - expf, never __expf: the f32 result holds the reference's tolerance.
// Later work (ROADMAP): tensor cores (mma/wgmma), TMA or cp.async staging
// with a pipeline of tiles, and a split of long key ranges across blocks.
#include "common.cuh"

#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int LD = BQ + 4;    // row stride (floats) of the transposed tiles
constexpr float NEG_INF = -1e30f;

static_assert(BQ == BK, "the transposed tiles share one row stride");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Output columns a thread owns: 4 adjacent columns per 64 (one float4 of a
// v row) when the padded head dim is at least 64, else one per 16.
template <int DP>
struct Cols {
  static constexpr int N = DP / 16;
  __device__ static __forceinline__ int col(int tx, int c) {
    if constexpr (DP >= 64) {
      return (c / 4) * 64 + tx * 4 + (c % 4);
    } else {
      return tx + 16 * c;
    }
  }
};

template <int DP>
constexpr size_t smem_bytes() {
  // qt [DP][LD], kt [DP][LD], vs [BK][DP], pt [BK][LD]
  return (size_t)(2 * DP * LD + BK * DP + BK * LD) * sizeof(float);
}

template <int DP, typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int bh_count,
                 int sq, int sk, int d, int causal, long long window,
                 float scale) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // q tile, transposed, scaled
  float* kt = qt + DP * LD;                     // k tile, transposed
  float* vs = kt + DP * LD;                     // v tile, [key][column]
  float* pt = vs + BK * DP;                     // probabilities, transposed

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // key quad (scores) / column group (output)
  const int ty = tid / 16;  // row quad
  const int nq = (sq + BQ - 1) / BQ;
  const int bh = blockIdx.x % bh_count;
  const int q0 = (nq - 1 - (int)(blockIdx.x / bh_count)) * BQ;
  const long long qbase = (long long)bh * sq * d;
  const long long kbase = (long long)bh * sk * d;

  for (int i = tid; i < BQ * DP; i += THREADS) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (q0 + r < sq && c < d)
      x = to_f32(q[qbase + (long long)(q0 + r) * d + c]) * scale;
    qt[c * LD + r] = x;
  }

  const int nk = (sk + BK - 1) / BK;
  int kt_begin = 0, kt_end = nk;
  if (causal) {
    const int q_last = min(q0 + BQ, sq) - 1;
    kt_end = min(nk, q_last / BK + 1);
    if (window > 0 && sq <= sk) {
      const long long first_key = (long long)q0 - window + 1;
      if (first_key > 0) kt_begin = (int)(first_key / BK);
    }
  }

  constexpr int NC = Cols<DP>::N;
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kti = kt_begin; kti < kt_end; ++kti) {
    const int k0 = kti * BK;
    __syncthreads();  // the last tile's kt, vs and pt have been read
    for (int i = tid; i < BK * DP; i += THREADS) {
      const int r = i / DP, c = i % DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < sk && c < d) {
        const long long off = kbase + (long long)(k0 + r) * d + c;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      kt[c * LD + r] = kx;
      vs[r * DP + c] = vx;
    }
    __syncthreads();

    // scores of rows 4ty.. x keys 4tx..
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(qt + c * LD + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(kt + c * LD + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // mask, then the online softmax of each row over this tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = q0 + ty * 4 + i;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long kpos = k0 + tx * 4 + j;
        bool ok = true;
        if (causal) ok = kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) s[i][j] = NEG_INF;
        if (kpos >= sk) s[i][j] = -INFINITY;  // padding: not even in l
        rmax = fmaxf(rmax, s[i][j]);
      }
      // the 16 lanes of a half-warp hold the 64 keys of the same rows
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rsum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * LD + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += p v
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + kk * LD + ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      if constexpr (DP >= 64) {
#pragma unroll
        for (int g = 0; g < DP / 64; ++g) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(vs + kk * DP + g * 64 + tx * 4);
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][g * 4 + e] = fmaf(pv[i], vv[e], acc[i][g * 4 + e]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float vv = vs[kk * DP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = Cols<DP>::col(tx, c);
      if (col < d) store_as(out + qbase + (long long)r * d + col, acc[i][c] / den);
    }
  }
}

template <int DP, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, int d, int causal, int window, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<DP>();
  auto kern = flash_fwd_kernel<DP, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)bh * ((sq + BQ - 1) / BQ);
  const float scale = (float)(1.0 / sqrt((double)d));
  kern<<<(unsigned)blocks, THREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, bh, sq, sk, d, causal,
      (long long)window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh,
             int sq, int sk, int d, int causal, int window, cudaStream_t s) {
  if (d <= 16) return launch<16, T>(q, k, v, out, bh, sq, sk, d, causal, window, s);
  if (d <= 32) return launch<32, T>(q, k, v, out, bh, sq, sk, d, causal, window, s);
  if (d <= 64) return launch<64, T>(q, k, v, out, bh, sq, sk, d, causal, window, s);
  if (d <= 128) return launch<128, T>(q, k, v, out, bh, sq, sk, d, causal, window, s);
  return launch<256, T>(q, k, v, out, bh, sq, sk, d, causal, window, s);
}

}  // namespace

// q, out: [bh, sq, d]; k, v: [bh, sk, d], all contiguous, one element type:
// dtype 0 = float32, 1 = bfloat16. window: -1 = none, else >= 1. d <= 256.
PIR_EXPORT int pir_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* out, int bh,
                                       int sq, int sk, int d, int causal,
                                       int window, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  if (sk <= 0 || d <= 0 || d > 256 || window == 0 || window < -1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, bh, sq, sk, d, causal, window, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, bh, sq, sk, d, causal, window,
                                   s);
  return (int)cudaErrorInvalidValue;
}
