// flash_attention_fwd: out = softmax(mask(cap(q k^T / sqrt(d)))) v per
// (batch*head) row, with an online softmax so the [Sq, Sk] score matrix
// never leaves the chip. Masks by absolute position, keys from 0 and
// queries from q_offset (qpos = row + q_offset): kpos <= qpos if causal,
// then kpos > qpos - window if a window is set. cap(s) = softcap *
// tanh(s / softcap) when softcap > 0 (gemma-2), applied before the mask
// as the reference's _attn_core does. Masked scores take the finite value
// -1e30 (not -inf), the padding keys >= sk take -inf, the f32 carry is
// (acc, m, l), and the epilogue is acc / max(l, 1e-30) cast to the input
// type. Takes float32 and bfloat16 operands at every head dim up to 256
// (bf16 at d 64, 128 and 256 goes to flash_attention_wgmma.cu instead).
//
// Replaces the TPU kernel of the reference package's
// kernels/flash_attention.py (`_kernel`: a grid (B*H, q blocks, kv blocks)
// with kv innermost, carrying acc/m/l in VMEM scratch across grid steps).
//
// Bound: operations. The work is 4 * (unmasked q,k pairs) * d flops (the
// two products) against 4 * (Sq + 2 Sk + Sq) * d bytes of Q/K/V/O per row
// at f32. Both products run on the TF32 tensor cores (mma.sync m16n8k8)
// at f32 accuracy: each f32 operand x is split into x_hi, x rounded to
// TF32, and x_lo, the exact rest x - x_hi truncated to TF32, and a product
// is a_lo b_hi + a_hi b_lo + a_hi b_hi in f32 (3xTF32; one TF32 pass keeps
// 11 bits and misses the f32 tolerance). bf16 operands are exact in TF32,
// so Q K^T takes one pass there and P V two (P's halves). Three passes of
// mma.sync, which Hopper issues at a fraction of wgmma's rate, are what
// bound this kernel at long sequences (PERF.md).
//
// Design:
// - One block of 4 warps per (bh, 64-row q tile); the blocks of the last q
//   tiles, which see the most keys under a causal mask, go first. A warp
//   owns 16 q rows and walks the key tiles on its own; the block shares
//   the staging of K and V.
// - K/V tiles (64 keys; 32 at a padded head dim of 128 or 256) go through
//   a ring of NS stages in shared memory by cp.async (16-byte copies that
//   zero-fill rows >= sk and columns >= d), issued NS - 1 tiles ahead, one
//   __syncthreads a tile. NS fills about 110 KB a block (two blocks an
//   SM): at BERT4Rec's head (S 200, d 32, f32) the whole head is in flight
//   from the first barrier. Each warp's 16 q rows ride with the first
//   tile. Operands that cp.async cannot read (d not a multiple of 16
//   bytes, or an unaligned tensor) are staged by plain loads instead.
// - Rows are padded (Q and K: 8 elements; V: 16 bytes) so that the
//   fragment loads below hit 32 distinct banks. Operands stay in their
//   type in shared memory and are split into TF32 halves as a warp loads
//   its fragments (three bit operations and a subtraction an element).
// - S = Q K^T: the m16n8k8 A fragment takes Q's columns 2t, 2t+1 of each
//   8 as the contraction's t, t+4, and K's B fragment the same, so both
//   are one 8-byte (f32) or 4-byte (bf16) load a thread. The scale, with
//   log2(e) folded in, multiplies the scores, so bf16 Q stays exact.
// - P V takes P straight from the S accumulator: accumulator columns 2t,
//   2t+1 become contraction index t, t+4, so V's rows are read in that
//   order and P never passes through shared memory. Each tile's P V sums
//   into fresh accumulators (at most 64 columns a pass), added to O in
//   f32: the tensor cores truncate as they accumulate, so a chain as long
//   as the sequence drifts towards the f32 tolerance at thousands of keys.
// - The row max and sum are reduced over the 4 lanes (a quad) that hold a
//   row; l stays a per-lane partial sum until the epilogue.
// - A tile that no mask or skip touches runs a copy of the tile code with
//   no predicate in its loops. Masks are evaluated only on the tiles that
//   cross a boundary (padding, the diagonal, the window edge). Key tiles
//   that the mask empties for every row of the block are skipped, and
//   inside a tile a warp skips the 8-key blocks its 16 rows do not see
//   (after the diagonal, padding, and before the window). Both skips give
//   the same bits as computing them: after the diagonal p = exp(-1e30 -
//   m) = 0 and alpha = 1; before the window the finite -1e30 gives p = 1
//   garbage that the first tile holding a real key wipes with alpha =
//   exp(-1e30 - m) = 0 (a row under a causal mask with window >= 1 and Sq
//   <= Sk always holds its diagonal key). The padding keys take -inf, so a
//   row that the mask empties (Sq > Sk with a window) averages its Sk real
//   keys, as the plain version does.
// - exp2f with log2(e) folded into the scale, never __expf.
// - Two instances a head dim and type, by the template flag GEN: the
//   plain one (no offset, no cap) is the code it was (the offset's
//   position arithmetic, taken at run time, cost ~2 % at 4096 tokens in
//   f32); the general one takes the offset and a cap flag that is the
//   same for the whole grid (gemma-2's prefill runs it at offset 0). With
//   the cap, a score is s * scale / cap, then tanhf (the accurate one:
//   tanh.approx.f32's ~2^-11 relative error, times a cap of 50, would
//   cost the f32 tolerance), then * cap * log2(e), so the exp2 domain is
//   entered after the cap. The masks come after the cap: a padding key
//   stays -inf (tanh(-inf) = -1 would bring it back).
// - The query offset shifts every position test: the tile range, the
//   per-warp 8-key blocks, the fullness test and the per-element mask all
//   use the absolute position row + q_offset. The window skip needs every
//   row's diagonal key to be a real one: Sq + q_offset <= Sk.
#include "common.cuh"

#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // q rows per block
constexpr float NEG_INF = -1e30f;
constexpr int STAGE_BUDGET = 110 * 1024;  // shared bytes a block aims at

template <int DP, typename T>
struct Tiles {
  static constexpr int BK = DP >= 128 ? 32 : 64;  // keys per tile
  static constexpr int LDQ = DP + 8;  // row strides, in elements of T
  static constexpr int LDK = DP + 8;
  static constexpr int LDV = DP + 16 / (int)sizeof(T);
  static constexpr int Q_BYTES = BQ * LDQ * (int)sizeof(T);
  static constexpr int STAGE_ELEMS = BK * (LDK + LDV);
  static constexpr int STAGE_BYTES = STAGE_ELEMS * (int)sizeof(T);
  static constexpr int FIT = (STAGE_BUDGET - Q_BYTES) / STAGE_BYTES;
  static constexpr int NS = FIT < 2 ? 2 : (FIT > 5 ? 5 : FIT);
  static constexpr int SMEM = Q_BYTES + NS * STAGE_BYTES;
};

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// x = hi + lo in TF32: hi is x rounded to nearest (ties away, the bits
// cvt.rna.tf32.f32 gives for a finite x), x - hi is exact in f32 and is
// truncated to TF32 (an error below 2^-22 |x|). Four instructions: the
// operands are finite, so cvt.rna's care for NaN and infinity, which
// costs more on sm_90a, is not needed.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// c += a b over one m16n8k8 tile (TF32 in, f32 accumulate)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows r0 .. r0 + ROWS - 1 of a [n, d] matrix at `base` into `dst` (row
// stride `ld`), zero past row n and column d, by the NT threads numbered
// `tid`: by cp.async when `vec` (d * sizeof(T) a multiple of 16 and the
// tensors 16-byte aligned), else by plain loads.
template <int DP, int ROWS, int NT, typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld,
                                           const T* __restrict__ src,
                                           long long base, int r0, int n,
                                           int d, bool vec, int tid) {
  if (vec) {
    constexpr int CH = 16 / (int)sizeof(T);  // elements a copy
    constexpr int CPR = DP / CH;             // copies a row
    static_assert(ROWS * CPR % NT == 0, "whole copies a thread");
#pragma unroll
    for (int j = 0; j < ROWS * CPR / NT; ++j) {
      const int i = tid + j * NT;
      const int r = i / CPR, c = (i % CPR) * CH;
      const bool ok = r0 + r < n && c < d;
      const long long off = ok ? base + (long long)(r0 + r) * d + c : base;
      cp_async16(dst + r * ld + c, src + off, ok);
    }
  } else {
    for (int i = tid; i < ROWS * DP; i += NT) {
      const int r = i / DP, c = i % DP;
      T x = T(0.f);
      if (r0 + r < n && c < d) x = src[base + (long long)(r0 + r) * d + c];
      dst[r * ld + c] = x;
    }
  }
}

// Two adjacent elements (the contraction's t, t + 4) as TF32 hi and lo
// halves; bf16 is exact in TF32, so its lo halves are never read.
__device__ __forceinline__ void frag2(const float* p, uint32_t (&hi)[2],
                                      uint32_t (&lo)[2]) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  split(x.x, hi[0], lo[0]);
  split(x.y, hi[1], lo[1]);
}
__device__ __forceinline__ void frag2(const __nv_bfloat16* p,
                                      uint32_t (&hi)[2], uint32_t (&)[2]) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  hi[0] = w << 16;  // bf16 -> f32 bits
  hi[1] = w & 0xffff0000u;
}
__device__ __forceinline__ uint32_t bits_f32(__nv_bfloat16 x) {
  return (uint32_t)__bfloat16_as_ushort(x) << 16;
}

// One key tile for one warp's 16 rows: S = Q K^T, the online softmax, O +=
// P V. FULL: every 8-key block is seen and no mask applies (no predicate
// in the loops); else the blocks [nb_begin, nb_end) and the masks.
// qa: the absolute position of the warp's first row (row + q_offset).
// s -> s * pre, or in GEN post * f(s * pre) (f = tanh when capped).
template <bool FULL, bool GEN, int DP, typename T>
__device__ __forceinline__ void attend_tile(
    const T* qs, const T* ks, const T* vs, int nb_begin, int nb_end, int k0,
    int qa, int sk, int causal, long long window, float pre, float post,
    bool capped, int g, int t, float (&m)[2], float (&l)[2],
    float (&o)[DP / 8][4]) {
  using L = Tiles<DP, T>;
  constexpr int NB = L::BK / 8, KC = DP / 8;
  constexpr bool F32 = sizeof(T) == 4;
  auto seen = [&](int nb) { return FULL || (nb >= nb_begin && nb < nb_end); };

  // S = Q K^T: A takes Q's columns 2t, 2t + 1 of each 8 as the
  // contraction's t, t + 4, and K's B fragment the same
  float s[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t h0[2], l0[2], h1[2], l1[2];
    frag2(qs + g * L::LDQ + kc * 8 + 2 * t, h0, l0);
    frag2(qs + (g + 8) * L::LDQ + kc * 8 + 2 * t, h1, l1);
    const uint32_t ah[4] = {h0[0], h1[0], h0[1], h1[1]};
    const uint32_t al[4] = {l0[0], l1[0], l0[1], l1[1]};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      if (!seen(nb)) continue;
      uint32_t kh[2], kl[2];
      frag2(ks + (nb * 8 + g) * L::LDK + kc * 8 + 2 * t, kh, kl);
      if constexpr (F32) {
        mma(s[nb], al, kh[0], kh[1]);
        mma(s[nb], ah, kl[0], kl[1]);
      }
      mma(s[nb], ah, kh[0], kh[1]);
    }
  }

  // scale (log2 units; the cap first), mask, then the online softmax of
  // rows g, g + 8. The general instance takes one sequence either way:
  // post * f(s * pre), f = tanh with the cap, else the identity (pre =
  // scale_log2, post = 1, so s * pre * 1 is the plain instance's s *
  // scale_log2 bit for bit)
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (GEN) {
        const float x = s[nb][e] * pre;
        s[nb][e] = post * (capped ? tanhf(x) : x);
      } else {
        s[nb][e] *= pre;
      }
      if constexpr (!FULL) {
        const int kpos = k0 + nb * 8 + 2 * t + (e & 1);
        const long long qpos = qa + g + 8 * (e >> 1);
        bool ok = true;
        if (causal) ok = kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) s[nb][e] = NEG_INF;
        if (kpos >= sk) s[nb][e] = -INFINITY;  // padding: not even in l
      }
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = NEG_INF;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      if (seen(nb)) mx = fmaxf(mx, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      if (seen(nb)) {
        s[nb][2 * r] = exp2f(s[nb][2 * r] - m_new);
        s[nb][2 * r + 1] = exp2f(s[nb][2 * r + 1] - m_new);
        sum += s[nb][2 * r] + s[nb][2 * r + 1];
      }
    l[r] = l[r] * alpha[r] + sum;
  }

  // O = alpha O + P V, P from the accumulator: its columns 2t, 2t + 1 are
  // the contraction's t, t + 4, so thread t reads V rows 2t and 2t + 1.
  // The tile's sum starts from zero in fresh accumulators and is added to
  // O in f32, so no chain of tensor-core accumulations outlasts a tile; at
  // most 64 columns a pass bound the registers that takes.
  constexpr int CW = KC < 8 ? KC : 8;  // column blocks a pass
#pragma unroll
  for (int c0 = 0; c0 < KC; c0 += CW) {
    float acc[CW][4];
#pragma unroll
    for (int j = 0; j < CW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      if (!seen(nb)) continue;
      uint32_t ph[4], pl[4];
      split(s[nb][0], ph[0], pl[0]);
      split(s[nb][2], ph[1], pl[1]);
      split(s[nb][1], ph[2], pl[2]);
      split(s[nb][3], ph[3], pl[3]);
      const T* v0 = vs + (nb * 8 + 2 * t) * L::LDV + c0 * 8 + g;
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        if constexpr (F32) {
          uint32_t vh0, vl0, vh1, vl1;
          split(v0[j * 8], vh0, vl0);
          split(v0[j * 8 + L::LDV], vh1, vl1);
          mma(acc[j], pl, vh0, vh1);
          mma(acc[j], ph, vl0, vl1);
          mma(acc[j], ph, vh0, vh1);
        } else {
          const uint32_t b0 = bits_f32(v0[j * 8]);
          const uint32_t b1 = bits_f32(v0[j * 8 + L::LDV]);
          mma(acc[j], pl, b0, b1);
          mma(acc[j], ph, b0, b1);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[c0 + j][e] = fmaf(o[c0 + j][e], alpha[e >> 1], acc[j][e]);
  }
}

template <int DP, typename T, bool GEN>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int bh_count,
                 int sq, int sk, int d, int causal, long long window,
                 int q_offset, float pre, float post, int capped, int vec) {
  using L = Tiles<DP, T>;
  constexpr int BK = L::BK, NS = L::NS, NB = BK / 8, KC = DP / 8;
  extern __shared__ float4 smem4[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group, thread in it
  const int nq = (sq + BQ - 1) / BQ;
  const int bh = blockIdx.x % bh_count;
  const int q0 = (nq - 1 - (int)(blockIdx.x / bh_count)) * BQ;
  const int qw = q0 + 16 * warp;  // the warp's first row
  const bool active = qw < sq;
  const int qw_last = min(qw + 15, sq - 1);
  // absolute positions (row + q_offset; q_offset + sq < 2^31, checked) of
  // the warp's rows; in the plain instance they are the rows
  const int q_off = GEN ? q_offset : 0;
  const int qwa = qw + q_off, qwa_last = qw_last + q_off;
  const long long qbase = (long long)bh * sq * d;
  const long long kbase = (long long)bh * sk * d;

  T* qs = reinterpret_cast<T*>(smem4) + warp * 16 * L::LDQ;
  T* ring = reinterpret_cast<T*>(reinterpret_cast<char*>(smem4) + L::Q_BYTES);

  const int nk = (sk + BK - 1) / BK;
  int kt_begin = 0, kt_end = nk;
  const bool window_skip = causal && window > 0 && sq + q_off <= sk;
  if (causal) {
    const int q_last = min(q0 + BQ, sq) - 1 + q_off;
    kt_end = min(nk, q_last / BK + 1);
    if (window_skip) {
      const long long first_key = (long long)q0 + q_off - window + 1;
      if (first_key > 0) kt_begin = (int)(first_key / BK);
    }
  }
  const int ntiles = kt_end - kt_begin;

  // the warp's q rows ride with the first tile
  if (active)
    stage_rows<DP, 16, 32>(qs, L::LDQ, q, qbase, qw, sq, d, vec, lane);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < ntiles) {
      T* ks = ring + s * L::STAGE_ELEMS;
      const int k0 = (kt_begin + s) * BK;
      stage_rows<DP, BK, THREADS>(ks, L::LDK, k, kbase, k0, sk, d, vec,
                                  threadIdx.x);
      stage_rows<DP, BK, THREADS>(ks + BK * L::LDK, L::LDV, v, kbase, k0, sk,
                                  d, vec, threadIdx.x);
    }
    cp_async_commit();
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[KC][4];
#pragma unroll
  for (int n = 0; n < KC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    if (it + NS - 1 < ntiles) {
      T* ks = ring + ((it + NS - 1) % NS) * L::STAGE_ELEMS;
      const int k0 = (kt_begin + it + NS - 1) * BK;
      stage_rows<DP, BK, THREADS>(ks, L::LDK, k, kbase, k0, sk, d, vec,
                                  threadIdx.x);
      stage_rows<DP, BK, THREADS>(ks + BK * L::LDK, L::LDV, v, kbase, k0, sk,
                                  d, vec, threadIdx.x);
    }
    cp_async_commit();
    if (!active) continue;

    const int k0 = (kt_begin + it) * BK;
    // the 8-key blocks of this tile that the warp's rows can see
    int nb_begin = 0, nb_end = min(NB, (sk - k0 + 7) / 8);
    if (causal)
      nb_end = qwa_last < k0 ? 0 : min(nb_end, (qwa_last - k0) / 8 + 1);
    if (window_skip) {
      const long long first_key = (long long)qwa - window + 1;
      if (first_key > k0) {
        const long long skip = (first_key - k0) / 8;
        nb_begin = skip < NB ? (int)skip : NB;
      }
    }
    if (nb_begin >= nb_end) continue;
    const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > qwa) ||
                      (window > 0 && k0 <= (long long)qwa + 15 - window);
    const T* ks = ring + (it % NS) * L::STAGE_ELEMS;
    const T* vs = ks + BK * L::LDK;
    if (edge || nb_begin > 0 || nb_end < NB)
      attend_tile<false, GEN, DP>(qs, ks, vs, nb_begin, nb_end, k0, qwa, sk,
                                  causal, window, pre, post, capped, g, t, m,
                                  l, o);
    else
      attend_tile<true, GEN, DP>(qs, ks, vs, 0, NB, k0, qwa, sk, causal,
                                 window, pre, post, capped, g, t, m, l, o);
  }
  cp_async_wait<0>();
  if (!active) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float den = l[r];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    den = fmaxf(den, 1e-30f);
    const int row = qw + g + 8 * r;
    if (row >= sq) continue;
    T* dst = out + qbase + (long long)row * d;
#pragma unroll
    for (int n = 0; n < KC; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < d) store_as(dst + col, o[n][2 * r] / den);
      if (col + 1 < d) store_as(dst + col + 1, o[n][2 * r + 1] / den);
    }
  }
}

template <int DP, typename T, bool GEN>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, int d, int causal, int window, int q_off,
           float cap, cudaStream_t s) {
  constexpr int smem = Tiles<DP, T>::SMEM;
  auto kern = flash_fwd_kernel<DP, T, GEN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)bh * ((sq + BQ - 1) / BQ);
  // scores in log2 units: exp2f(x * log2(e) / sqrt(d)) = exp(x / sqrt(d));
  // with a cap: tanh of s / (sqrt(d) cap), then * cap * log2(e)
  const int capped = cap > 0.f;
  const float pre = capped ? (float)(1.0 / (sqrt((double)d) * cap))
                           : (float)(1.4426950408889634 / sqrt((double)d));
  const float post = capped ? (float)(1.4426950408889634 * cap) : 1.f;
  const int vec = (d * (int)sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  kern<<<(unsigned)blocks, THREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, bh, sq, sk, d, causal,
      (long long)window, q_off, pre, post, capped, vec);
  return (int)cudaGetLastError();
}

template <typename T, bool GEN>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh,
             int sq, int sk, int d, int causal, int window, int q_off,
             float cap, cudaStream_t s) {
#define PIR_FLASH_LAUNCH(DP)                                                \
  return launch<DP, T, GEN>(q, k, v, out, bh, sq, sk, d, causal, window,   \
                            q_off, cap, s)
  if (d <= 16) PIR_FLASH_LAUNCH(16);
  if (d <= 32) PIR_FLASH_LAUNCH(32);
  if (d <= 64) PIR_FLASH_LAUNCH(64);
  if (d <= 128) PIR_FLASH_LAUNCH(128);
  PIR_FLASH_LAUNCH(256);
#undef PIR_FLASH_LAUNCH
}

}  // namespace

// q, out: [bh, sq, d]; k, v: [bh, sk, d], all contiguous, one element type:
// dtype 0 = float32, 1 = bfloat16. window: -1 = none, else >= 1. d <= 256.
// q_offset >= 0 with q_offset + sq < 2^31; softcap: 0 = none, else > 0.
PIR_EXPORT int pir_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* out, int bh,
                                       int sq, int sk, int d, int causal,
                                       int window, int q_offset, float softcap,
                                       int dtype, void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  if (sk <= 0 || d <= 0 || d > 256 || window == 0 || window < -1 ||
      q_offset < 0 || q_offset > INT_MAX - sq ||
      !(softcap >= 0.f && softcap < INFINITY))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a cap or an offset goes to the general instance
  const bool gen = softcap > 0.f || q_offset > 0;
#define PIR_FLASH_DISPATCH(T)                                               \
  if (gen)                                                                  \
    return dispatch<T, true>(q, k, v, out, bh, sq, sk, d, causal, window,   \
                             q_offset, softcap, s);                         \
  return dispatch<T, false>(q, k, v, out, bh, sq, sk, d, causal, window,    \
                            q_offset, softcap, s)
  if (dtype == 0) {
    PIR_FLASH_DISPATCH(float);
  }
  if (dtype == 1) {
    PIR_FLASH_DISPATCH(__nv_bfloat16);
  }
#undef PIR_FLASH_DISPATCH
  return (int)cudaErrorInvalidValue;
}
