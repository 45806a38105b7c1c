// flash_attention_wgmma: the bf16 flash-attention forward on Hopper's
// tensor cores. out = softmax(mask(cap(q k^T / sqrt(d)))) v per
// (batch*head) row, d in {64, 128, 256}, with the masks (queries at row +
// q_offset), the softcap, the finite -1e30, the f32 carry (acc, m, l) and
// the acc / max(l, 1e-30) epilogue of flash_attention.cu, which keeps
// float32 operands and the other head dims.
//
// Replaces the TPU kernel of the reference package's
// kernels/flash_attention.py (`_kernel`: a grid (B*H, q blocks, kv blocks)
// with kv innermost, carrying acc/m/l in VMEM scratch across grid steps).
//
// Bound: operations. The function costs 4 * d flops per unmasked (q, k)
// pair (the two products) against 2 * (2 Sq + 2 Sk) * d bytes of Q/K/V/O
// per row; at the LM's shapes (S = 4096, d = 64) that is ~1000 flops a
// byte, far above the card's bf16 ridge point. This kernel runs 6 * d
// flops per computed pair on the tensor cores: P.V is issued twice (see
// below), 1.5x the function's tensor work, so its ceiling is 2/3 of the
// bf16 peak counted at 4 * d.
//
// Design:
// - Grid and block. One block of three warpgroups per (bh, 128-row q
//   tile): warpgroups 0 and 1 each own 64 q rows and run the products and
//   the softmax; one thread of warpgroup 2 issues every TMA load. The
//   producer warpgroup gives its registers to the two others (setmaxnreg:
//   24 against 240 a thread). The blocks of the last q tiles, which see the
//   most keys under a causal mask, launch first.
// - Staging. TMA (cp.async.bulk.tensor, 3-d maps over [bh][S][d]) loads
//   the Q tile once and K/V tiles of BK keys into a ring of STAGES stages,
//   bf16 as they are in memory (never widened), each stage with a full
//   mbarrier (the transaction bytes) and an empty one (one arrival per
//   consumer warpgroup). The producer runs up to STAGES tiles ahead while
//   the consumers compute. Every tile is stored as [d / 64] blocks of
//   [rows][64] with the 128-byte swizzle, which is the layout the wgmma
//   descriptors below read without bank conflicts. Ragged Sq and Sk edges
//   come in as TMA's out-of-bounds zero fill, as the reference zero-pads
//   them. Keys >= Sk take -inf, not -1e30: a row that the mask empties
//   (Sq > Sk with a window) then averages the Sk real keys, as the plain
//   version does, and the padding never enters l (m starts at -1e30, so
//   no -inf - -inf arises).
// - S = Q K^T: wgmma.m64nBKk16, A = Q and B = K from shared memory, both
//   K-major (d contiguous), f32 accumulators in registers, then * 1/sqrt(d)
//   in f32 (the reference scales q first: the two agree within f32 noise,
//   exactly at d = 64).
// - Mask and online softmax in registers. A thread holds two rows of the
//   64 x BK tile; a row's max is reduced over the 4 lanes that hold it by
//   shuffles, its sum is carried per lane and reduced once at the end. The
//   mask arithmetic runs only on tiles that cross the diagonal, the window
//   edge or the ragged Sk edge. Both tile skips of flash_attention.cu are
//   kept (after the diagonal; before the window when Sq <= Sk), with its
//   argument that they give the same bits: the finite -1e30 makes exp of a
//   fully masked row 1 until a real key wipes it with alpha = 0. exp runs
//   as ex2.approx of (s - m) * log2(e) (rel. error ~2^-22, far inside one
//   bf16 rounding of the output).
// - O += P V with P kept to f32 precision. The reference's P.V runs in
//   f32. P is split in registers into hi = bf16(p) and lo = bf16(p - hi),
//   and two register-A wgmmas add hi.V and lo.V (B = V from shared memory:
//   [keys][d] is MN-major for B, taken with the transpose bit). P keeps
//   ~16 mantissa bits and every bf16 x bf16 product is exact in f32, so
//   the output stays within one bf16 rounding of the plain version; a P
//   rounded once to bf16 would not. The accumulator layout of S equals the
//   A-fragment layout of P, so P never leaves the registers. l sums the
//   f32 probabilities.
// - Overlap. A tile's softmax (about ten CUDA-core instructions a score,
//   with the hi/lo split) runs on other units than its products. A
//   warpgroup issues tile j's Q K^T
//   together with tile j-1's P.V, and the two warpgroups take turns to
//   issue (two named barriers), so one's products run while the other's
//   softmax does. No wgmma sits in a conditional path (the first tile is
//   peeled off): ptxas would serialize them.
// - Head dim 256 (gemma-2). The Q tile is 64 KB and a K or V stage of 64
//   keys 32 KB, so the ring is two stages deep (Tile<256>: 193 KB of the
//   227 KB a block may use). K and V get barriers of their own (SPLIT):
//   they are read a tile apart (tile j's K with tile j-1's V), so a K
//   stage is free once its S product is done, a tile before its V, and
//   the producer asks for K(j) then V(j-1), the order the consumers read
//   them: K(j) has a whole tile's products and softmax to land, where one
//   barrier for both would leave it the softmax alone. (The three-stage
//   rings of d 64 and 128 keep one barrier a stage: there a load has more
//   than a tile's products to land, and the split ring timed 1-3 % slower
//   at d 64 without the cap.) A consumer thread holds O (128 f32),
//   S (BK / 2) and P's two halves (BK / 4 each) at once: 192 registers at
//   BK = 64, of the 240 it takes. P.V takes one m64n256k16 register-A
//   wgmma per 16 keys and half of P (its A fragment read once for all 256
//   columns; two m64n128k16 on O's halves would read it twice and issue
//   twice as many instructions).
// - Softcap and query offset. The cap is a template flag (CAP): the
//   capless instances keep their float arithmetic. The offset is taken at
//   run time (its integer adds time level with the offset-free kernel at
//   chip_smoke.py's (a), (b) and (d)). With the cap, a scaled score
//   becomes cap * tanhf(s / cap) in f32 (the accurate tanhf: tanh.approx.f32's
//   ~2^-11 relative error, times a cap of 50, would cost the bf16
//   tolerance), before the mask, so a padding key stays -inf. The offset
//   shifts the positions of the tile range, the edge test and the mask;
//   the window skip needs Sq + q_offset <= Sk (every row's diagonal key is
//   real).
// - Epilogue. acc / max(l, 1e-30), rounded once to bf16, written into the
//   warpgroup's own (now unused) Q rows in the swizzled layout, then one
//   TMA store per 64 columns; TMA drops rows >= Sq.
// Later work (ROADMAP): a third consumer warpgroup (more warps to hide
// the softmax's latency), a persistent grid, GQA-aware K/V reads.
#include "common.cuh"
#include "sm90.cuh"

#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int BQ = 128;         // q rows per block
constexpr int WG_ROWS = 64;     // q rows per consumer warpgroup
constexpr int CONSUMERS = 2;    // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
// registers a thread: the producer warpgroup gives back what the consumers
// take (launch bounds give 168 each: 384 * 168 = 128 * 24 + 256 * 240)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int LAUNCH_REGS = 168;
static_assert(THREADS * LAUNCH_REGS ==
                  128 * PRODUCER_REGS + 128 * CONSUMERS * CONSUMER_REGS,
              "the register split must add up to the launch allocation");
constexpr int EPI_BAR = 1;      // named barriers 1, 2: each warpgroup's epilogue
constexpr int SCHED_BAR = 3;    // 3, 4: whose turn it is to issue products
constexpr int SW = 64;          // bf16 columns per 128-byte swizzled row
constexpr int ROW_BYTES = 128;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use

template <int D>
struct Tile {
  // keys per K/V tile, the depth of the ring, and whether K and V have
  // barriers of their own (split) or one a stage for both (joint)
  static constexpr int BK = D == 64 ? 128 : 64;
  static constexpr int STAGES = D == 256 ? 2 : 3;
  static constexpr bool SPLIT = D == 256;
  static constexpr int CB = D / SW;              // 64-column blocks
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;    // K or V, one stage
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  // barriers (Q; full and empty a stage, twice if split), then 1024 bytes
  // of slack to align the base for the swizzle
  static constexpr int SMEM =
      BAR_OFF + 8 * (1 + (SPLIT ? 4 : 2) * STAGES) + 1024;
  static_assert(STAGES >= 2, "tile j's K and tile j-1's V are held at once");
  static_assert(SMEM <= SMEM_MAX, "the tile does not fit a block");
};

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

#define ACC8(d, i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32(d) ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
#define ACC64(d) ACC32(d), ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
#define ACC128(d)                                                        \
  ACC64(d), ACC8(d, 64), ACC8(d, 72), ACC8(d, 80), ACC8(d, 88),          \
      ACC8(d, 96), ACC8(d, 104), ACC8(d, 112), ACC8(d, 120)
#define REGS32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define REGS64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63}"
#define REGS128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, " \
  "%122, %123, %124, %125, %126, %127}"

// D[64 x N] (+)= A[64 x 16] B[16 x N]; A and B from shared memory, both
// K-major; scale_d = 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}"
      : ACC64(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x N] += A[64 x 16] B[16 x N]; A from registers (four bf16x2 per
// thread), B from shared memory MN-major (the transpose bit set).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
      : ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " REGS128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}"
      : ACC128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo_col, float hi_col) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The online softmax of one 64 x BK tile of scores. s: the raw products
// in the wgmma accumulator layout (element i: row r0 + 8 * ((i >> 1) & 1),
// key k0 + 8 * (i / 4) + c0 + (i & 1); r0 the absolute position, row +
// q_offset). Scales (then caps: cap * tanh(s * scale / cap), with
// scale_cap = scale / cap), masks (on edge tiles),
// updates the carry (m, l), rescales o by alpha, and leaves P split into
// bf16 hi and lo halves in the A-fragment layout of the P.V product: key
// step kk holds elements 8kk..8kk+7, register j the pair 8kk + 2j, +1.
template <int D, int BK, bool CAP>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BK / 2], float (&o)[D / 2], float (&m)[2], float (&l)[2],
    uint32_t (&phi)[BK / 16][4], uint32_t (&plo)[BK / 16][4], bool edge,
    int k0, int r0, int c0, int sk, int causal, int window, float scale,
    float cap, float scale_cap) {
  if constexpr (CAP) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = cap * tanhf(s[i] * scale_cap);
  } else {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] *= scale;
  }
  if (edge) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int qpos = r0 + ((i & 2) ? 8 : 0);
      const int kpos = k0 + (i / 4) * 8 + c0 + (i & 1);
      bool ok = true;
      if (causal) ok = kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      if (!ok) s[i] = NEG_INF;
      if (kpos >= sk) s[i] = -INFINITY;  // padding: not even in l
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int h = (i >> 1) & 1;
    mx[h] = fmaxf(mx[h], s[i]);
  }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = ex2((m[h] - mx[h]) * LOG2E);
    m[h] = mx[h];
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 8 * kk + 2 * j;
      const int h = j & 1;
      const float p0 = ex2((s[i] - m[h]) * LOG2E);
      const float p1 = ex2((s[i + 1] - m[h]) * LOG2E);
      l[h] += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      phi[kk][j] = *reinterpret_cast<const uint32_t*>(&hi);
      plo[kk][j] = pack_bf16x2(p0 - hf.x, p1 - hf.y);
    }
  }
}

// S = Q K^T for one warpgroup's 64 rows over d in steps of 16 (32 bytes
// along the swizzled row; the next 64 columns in the next column block)
template <int D, int BK>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], uint32_t q_addr,
                                        uint32_t k_addr) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t col = (ks % 4) * 32;
    const uint64_t a = desc_sw128(q_addr + (ks / 4) * BQ * ROW_BYTES + col,
                                  16, 8 * ROW_BYTES);
    const uint64_t b = desc_sw128(k_addr + (ks / 4) * BK * ROW_BYTES + col,
                                  16, 8 * ROW_BYTES);
    wgmma_ss<BK>(s, a, b, ks);
  }
}

// O += hi V + lo V over one tile's keys, in steps of 16 keys (2 x 8 rows).
// FLASH_WGMMA_PV_LO=0 drops the lo half (P rounded once to bf16): only
// scripts/flash_pv_split_probe.py builds that, to measure what the split
// buys; the package always builds the split.
#ifndef FLASH_WGMMA_PV_LO
#define FLASH_WGMMA_PV_LO 1
#endif
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&phi)[BK / 16][4],
                                         const uint32_t (&plo)[BK / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t b = desc_sw128(v_addr + kk * 16 * ROW_BYTES,
                                  BK * ROW_BYTES, 8 * ROW_BYTES);
    wgmma_rs<D>(o, phi[kk], b);
    if constexpr (FLASH_WGMMA_PV_LO) wgmma_rs<D>(o, plo[kk], b);
  }
}

// ------------------------------------------------------------------ kernel
template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o, int bh_count,
                   int sq, int sk, int causal, int window, int q_off,
                   float scale, float cap, float scale_cap) {
  using T = Tile<D>;
  constexpr int BK = T::BK, CB = T::CB, STAGES = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern follows address bits 4-9: tiles sit on 1024 bytes
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq_addr = base;                          // [CB][BQ][64]
  const uint32_t sk_addr = base + T::Q_BYTES;             // [STAGES][CB][BK][64]
  const uint32_t sv_addr = sk_addr + STAGES * T::KV_BYTES;
  const uint32_t q_full = base + T::BAR_OFF;
  // each + 8 * stage: K's barriers, and V's (joint rings: K's)
  const uint32_t full_k = q_full + 8, empty_k = full_k + 8 * STAGES;
  const uint32_t full_v = T::SPLIT ? empty_k + 8 * STAGES : full_k;
  const uint32_t empty_v = T::SPLIT ? full_v + 8 * STAGES : empty_k;

  const int nq = (sq + BQ - 1) / BQ;
  const int bh = blockIdx.x % bh_count;
  const int q0 = (nq - 1 - (int)(blockIdx.x / bh_count)) * BQ;
  const int nk = (sk + BK - 1) / BK;
  int kt_begin = 0, kt_end = nk;
  if (causal) {
    // absolute positions: row + q_off (q_off + sq < 2^31, checked)
    const int q_last = min(q0 + BQ, sq) - 1 + q_off;
    kt_end = min(nk, q_last / BK + 1);
    if (window > 0 && sq + q_off <= sk) {
      const long long first_key = (long long)q0 + q_off - window + 1;
      if (first_key > 0) kt_begin = (int)(first_key / BK);
    }
  }

  const int n = kt_end - kt_begin;  // key tiles, from kt_begin
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(empty_k + 8 * s, CONSUMERS);
      if (T::SPLIT) {
        mbar_init(full_v + 8 * s, 1);
        mbar_init(empty_v + 8 * s, CONSUMERS);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ----------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != CONSUMERS * 128) return;
    mbar_expect_tx(q_full, T::Q_BYTES);
    for (int c = 0; c < CB; ++c)
      tma_load_3d(sq_addr + c * BQ * ROW_BYTES, &tm_q, q_full, c * SW, q0,
                  bh);
    // one K or V tile into its stage, on that stage's full barrier
    auto load = [&](uint32_t ring, const CUtensorMap* map, uint32_t full,
                    int stage, int j) {
      for (int c = 0; c < CB; ++c)
        tma_load_3d(ring + stage * T::KV_BYTES + c * BK * ROW_BYTES, map,
                    full + 8 * stage, c * SW, (kt_begin + j) * BK, bh);
    };
    // joint: K and V of tile j together; split: K of tile j, then V of
    // tile j - 1, the order the consumers read them
    int stage = 0, prev = 0;
    uint32_t phase = 0, prev_phase = 0;
    for (int j = 0; j <= n; ++j) {
      if (j < n) {
        mbar_wait(empty_k + 8 * stage, phase ^ 1);  // passes on the first lap
        mbar_expect_tx(full_k + 8 * stage, (T::SPLIT ? 1 : 2) * T::KV_BYTES);
        load(sk_addr, &tm_k, full_k, stage, j);
        if (!T::SPLIT) load(sv_addr, &tm_v, full_k, stage, j);
      }
      if (T::SPLIT && j > 0) {
        mbar_wait(empty_v + 8 * prev, prev_phase ^ 1);
        mbar_expect_tx(full_v + 8 * prev, T::KV_BYTES);
        load(sv_addr, &tm_v, full_v, prev, j - 1);
      }
      prev = stage;
      prev_phase = phase;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int q0w = q0 + wg * WG_ROWS;
  // accumulator element i of a thread: row r0 (+8 if i & 2), column
  // 8 * (i / 4) + c0 + (i & 1)
  const int r_local = warp * 16 + lane / 4;
  const int qa0w = q0w + q_off;  // absolute position of the first row
  const int r0 = qa0w + r_local;
  const int c0 = 2 * (lane % 4);
  const uint32_t qw_addr = sq_addr + wg * WG_ROWS * ROW_BYTES;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  float s[BK / 2];
  uint32_t phi[BK / 16][4], plo[BK / 16][4];

  // Tile j's S = Q K^T goes out with tile j-1's P.V, and the two
  // warpgroups take turns to issue them (named barriers SCHED_BAR + wg):
  // one's products run on the tensor cores while the other's softmax runs
  // on the CUDA cores. Warpgroup 0 goes first; each sync is met by one
  // arrival of the other warpgroup (warpgroup 0 takes warpgroup 1's last
  // one after its loop). Every block has at least one key tile (the
  // diagonal's under a causal mask), so the first tile is peeled off and
  // no wgmma sits in a conditional path: ptxas would serialize them.
  // the key tile's mask is applied only where it can mask something
  auto edge = [&](int k0) {
    return k0 + BK > sk || (causal && k0 + BK - 1 > qa0w) ||
           (window > 0 && (long long)k0 <= (long long)qa0w + WG_ROWS - 1 -
                                                window);
  };

  mbar_wait(q_full, 0);
  if (wg == 1) bar_arrive(SCHED_BAR, 2 * 128);
  mbar_wait(full_k, 0);
  bar_sync(SCHED_BAR + wg, 2 * 128);
  wgmma_fence();
  issue_s<D, BK>(s, qw_addr, sk_addr);
  wgmma_commit();
  bar_arrive(SCHED_BAR + 1 - wg, 2 * 128);
  wgmma_wait_all();
  fence_regs(s);
  if (T::SPLIT) {
    if (t == 0) mbar_arrive(empty_k);  // tile 0's K is done with
  }
  softmax_tile<D, BK, CAP>(s, o, m, l, phi, plo, edge(kt_begin * BK),
                           kt_begin * BK, r0, c0, sk, causal, window, scale,
                           cap, scale_cap);
  int stage = 1, prev = 0;  // the ring position of tile 1, and of tile 0
  uint32_t phase = 0, prev_phase = 0;
  for (int j = 1; j < n; ++j) {
    const int k0 = (kt_begin + j) * BK;
    mbar_wait(full_k + 8 * stage, phase);
    if (T::SPLIT) mbar_wait(full_v + 8 * prev, prev_phase);
    bar_sync(SCHED_BAR + wg, 2 * 128);
    wgmma_fence();
    issue_s<D, BK>(s, qw_addr, sk_addr + stage * T::KV_BYTES);
    issue_pv<D, BK>(o, phi, plo, sv_addr + prev * T::KV_BYTES);
    wgmma_commit();
    bar_arrive(SCHED_BAR + 1 - wg, 2 * 128);
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(o);
    if (t == 0) {
      // tile j-1 is done with (its V was the last read of its stage), and
      // with split rings tile j's K too
      mbar_arrive(empty_v + 8 * prev);
      if (T::SPLIT) mbar_arrive(empty_k + 8 * stage);
    }
    softmax_tile<D, BK, CAP>(s, o, m, l, phi, plo, edge(k0), k0, r0, c0, sk,
                             causal, window, scale, cap, scale_cap);
    prev = stage;
    prev_phase = phase;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (T::SPLIT) mbar_wait(full_v + 8 * prev, prev_phase);
  wgmma_fence();  // the last tile's P.V
  issue_pv<D, BK>(o, phi, plo, sv_addr + prev * T::KV_BYTES);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
  if (wg == 0) bar_sync(SCHED_BAR, 2 * 128);

  // ------------------------------------------------------------- epilogue
  float den[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    den[h] = fmaxf(l[h], 1e-30f);
  }
  // this warpgroup's Q rows are free now: stage the output there, in the
  // swizzled layout the TMA store reads
  uint8_t* generic = smem_raw + (qw_addr - smem_u32(smem_raw));
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int h = (i >> 1) & 1;
    const int r = r_local + 8 * h;
    const int j = i / 4;  // 8-column group
    const int off = (j / 8) * BQ * ROW_BYTES + r * ROW_BYTES +
                    (((j % 8) ^ (r % 8)) * 16) + c0 * 2;
    *reinterpret_cast<uint32_t*>(generic + off) =
        pack_bf16x2(o[i] / den[h], o[i + 1] / den[h]);
  }
  fence_proxy_async();
  bar_sync(EPI_BAR + wg, 128);
  if (t == 0 && q0w < sq) {
    for (int c = 0; c < CB; ++c)
      tma_store_3d(&tm_o, qw_addr + c * BQ * ROW_BYTES, c * SW, q0w, bh);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// ------------------------------------------------------------------- host
// a [bh][rows][d] bf16 tensor, boxes of [1][box_rows][64] with the
// 128-byte swizzle; out-of-bounds elements read as zero
bool tensor_map(CUtensorMap* map, const void* ptr, int bh, int rows, int d,
                int box_rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)SW, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool CAP>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, int causal, int window, int q_off, float cap,
           cudaStream_t s) {
  using T = Tile<D>;
  CUtensorMap mq, mk, mv, mo;
  if (!tensor_map(&mq, q, bh, sq, D, BQ) ||
      !tensor_map(&mk, k, bh, sk, D, T::BK) ||
      !tensor_map(&mv, v, bh, sk, D, T::BK) ||
      !tensor_map(&mo, out, bh, sq, D, WG_ROWS))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_wgmma_kernel<D, CAP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  // setmaxnreg.inc waits for registers that the producer gave back: with
  // fewer than LAUNCH_REGS a thread at launch it would wait forever
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  if (attr.numRegs < LAUNCH_REGS) return (int)cudaErrorInvalidConfiguration;
  const long long blocks = (long long)bh * ((sq + BQ - 1) / BQ);
  const float scale = (float)(1.0 / sqrt((double)D));
  const float scale_cap = CAP ? (float)(1.0 / (sqrt((double)D) * cap)) : 0.f;
  kern<<<(unsigned)blocks, THREADS, T::SMEM, s>>>(
      mq, mk, mv, mo, bh, sq, sk, causal, window, q_off, scale, cap,
      scale_cap);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [bh, sq, d]; k, v: [bh, sk, d]; all contiguous bf16 on 16-byte
// boundaries, d = 64, 128 or 256. window: -1 = none, else >= 1. q_offset >= 0
// with q_offset + sq < 2^31; softcap: 0 = none, else > 0.
PIR_EXPORT int pir_flash_attention_wgmma(const void* q, const void* k,
                                         const void* v, void* out, int bh,
                                         int sq, int sk, int d, int causal,
                                         int window, int q_offset,
                                         float softcap, void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  if (sk <= 0 || window == 0 || window < -1 || q_offset < 0 ||
      q_offset > INT_MAX - sq || !(softcap >= 0.f && softcap < INFINITY))
    return (int)cudaErrorInvalidValue;
  const uintptr_t any = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                        (uintptr_t)out;
  if (any % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PIR_WGMMA_LAUNCH(D, CAP)                                            \
  return launch<D, CAP>(q, k, v, out, bh, sq, sk, causal, window, q_offset, \
                        softcap, s)
  const bool cap = softcap > 0.f;
  if (d == 64) {
    if (cap) PIR_WGMMA_LAUNCH(64, true);
    PIR_WGMMA_LAUNCH(64, false);
  }
  if (d == 128) {
    if (cap) PIR_WGMMA_LAUNCH(128, true);
    PIR_WGMMA_LAUNCH(128, false);
  }
  if (d == 256) {
    if (cap) PIR_WGMMA_LAUNCH(256, true);
    PIR_WGMMA_LAUNCH(256, false);
  }
#undef PIR_WGMMA_LAUNCH
  return (int)cudaErrorInvalidValue;
}
