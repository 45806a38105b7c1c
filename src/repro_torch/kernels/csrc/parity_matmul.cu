// parity_matmul: out = (mask @ planes) mod 2 over 0/1 operands, on
// Hopper's int8 tensor cores.
//   mask [q, n] uint8, planes [n, B] uint8 -> out [q, B] uint8 bits, or
//   the same bits packed LSB first into [q, ceil(B / 32)] 32-bit words
//   (the store's word layout; db/packing.py::pack_bits).
// The bytes are multiplied as they are, as the TPU kernel multiplies its
// bf16 values: the operands hold 0/1.
//
// Replaces the TPU kernel of the reference package's
// kernels/parity_matmul.py (`_kernel`: bf16 operands, fp32 accumulator in
// VMEM scratch across the n grid axis, mod-2 epilogue on the last n step).
//
// Bound: the larger of 2*q*n*B integer operations over the card's int8
// peak and (q*n + n*B + out) bytes over its memory rate. On an H100
// (1979e12 int8 operations/s, 3.35e12 bytes/s) the planes' bytes (one
// byte per record bit) set it below q of about 300, the operations above.
//
// Design:
// - Products. wgmma.m64n256k32.s32.u8.u8: int8 in, int32 accumulators in
//   registers, exact for every n < 2^31 (the reference's fp32 route is
//   exact below 2^24). One block of 3 warpgroups owns a 128 x 256 output
//   tile; warpgroups 0 and 1 each multiply 64 query rows.
// - Layouts. For 8-bit types wgmma has no transpose bit: both operands
//   must be K-major (n contiguous) in shared memory. The mask is, and so
//   are planes stored bit column by bit column ([B, n] storage, handed
//   over as its [n, B] view: the serving path's layout). Those TMA lands
//   straight in the operand ring, whose stages one thread of warpgroup 2
//   keeps full (mbarriers: full, empty).
//   Planes in the TPU kernel's layout ([n, B], B contiguous) are
//   transposed on the way: TMA lands each tile in a load ring, and the
//   four warps of warpgroup 2 move it into the operand ring with 4 x 4
//   byte transposes (__byte_perm), both in the 128-byte swizzle; a lane's
//   4 x 4 blocks are picked so that a warp's loads and stores each touch
//   32 distinct banks. The load ring is refilled as soon as the
//   transposers are done with a stage, so loads run ahead of the
//   products. The transposition, not the loads or the products, sets the
//   pace of that layout at large q; the consumers' 128 accumulators a
//   thread leave no registers for a second warpgroup of transposers.
// - Split-K by XOR. The parity of a sum is the XOR of the parities of its
//   parts, so when the output has too few tiles to fill the card the
//   launcher cuts n into `split` ranges, one block each, chosen from the
//   shape to fill whole waves of the SMs. With split > 1 the launcher
//   zeroes the output (cudaMemsetAsync, same stream) and each block XORs
//   its bits into 32-bit words with atomicXor: four 0/1 bytes or 32 packed
//   bits a word, no carries, and the same bits whatever the order.
// - Epilogue. The low bit of each accumulator. A quad of lanes holds 8
//   adjacent columns of a row; in the packed form four such n8 chunks make
//   a word, combined by shuffles within the quad.
// - Edges. TMA zero-fills rows >= q, columns >= B and n beyond the end.
//   TMA needs 16-byte row strides: the wrapper hands over a padded copy
//   of an operand whose rows are not (never the serving path's shapes).
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BM = 128;           // query rows per block
constexpr int BN = 256;           // bit columns per block (wgmma N)
constexpr int BK = 128;           // n per stage: one 128-byte swizzled row
constexpr int THREADS = 384;      // 2 consumer warpgroups, 1 loading
constexpr int CONSUMERS = 256;
constexpr int TRANSPOSERS = 128;  // warpgroup 2, for [n, B] planes
constexpr int A_BYTES = BM * BK;  // mask tile, K-major
constexpr int B_BYTES = BN * BK;  // planes tile: K-major, or as in memory
constexpr int OPERAND_BYTES = A_BYTES + B_BYTES;

// Shared memory: [load ring][operand ring][barriers]. K-major planes need
// no load ring; [n, B] planes land in one (mask tile, planes tile).
template <bool KMAJOR>
struct Ring {
  static constexpr int LOAD_STAGES = KMAJOR ? 0 : 2;
  static constexpr int STAGES = KMAJOR ? 4 : 2;  // of the operand ring
  static constexpr int OPERAND_OFF = LOAD_STAGES * OPERAND_BYTES;
  static constexpr int BAR_OFF = OPERAND_OFF + STAGES * OPERAND_BYTES;
  // barriers (full, empty per operand stage; loaded per load stage),
  // then slack to align the base on 1024 bytes for the swizzle
  static constexpr int SMEM = BAR_OFF + 8 * (LOAD_STAGES + 2 * STAGES) + 1024;
  static_assert(SMEM <= 232448, "one block must fit the SM's shared memory");
};
constexpr int TRANSPOSE_BAR = 1;  // named barrier of the transposers

// Staging [BK k][BN columns] (two TMA boxes of 128 columns, each
// 128-byte swizzled: byte (k, c) of a box at k * 128 + (((c / 16) ^ k) %
// 8) * 16 + c % 16) -> the K-major operand [BN columns][BK k], swizzled
// the same way with the roles of k and c exchanged. The work is 2 x 32 x
// 32 blocks of 4 k x 4 columns; warp w takes 16 of them in each of 16
// steps m, one a lane. A lane's block is (k word kb = 4 kh + kl, column
// word cw = 4 ch + cl) with cl, kl its lane bits 0-1 and 2-3 and kh, ch
// chosen so that a warp's four loads (rows 4 kb + i) and four stores
// (columns 4 cw + j) each hit 32 distinct banks. In those offsets kh and
// ch sit in fields of their own or under an XOR, so step m is the lane's
// step-0 offset XOR a constant.
struct TransposeLane {
  uint32_t ld[4];  // staging offset of row 4 kb + i, word cw, at m = 0
  uint32_t st[4];  // operand offset of column 4 cw + j, word kb, at m = 0
};

__device__ __forceinline__ TransposeLane transpose_lane(int warp, int lane) {
  const uint32_t cl = lane & 3, kl = (lane >> 2) & 3, hi = lane >> 4;
  const uint32_t half = warp >> 1;  // which 128 columns
  const uint32_t kh = (cl >> 1) | (hi << 1);
  const uint32_t ch = ((kl >> 1) | (hi << 1)) ^ ((warp & 1) << 2);
  TransposeLane o;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t row = 4 * kl + i;  // of 16 rows; kh picks the 16
    o.ld[i] = (half << 14) | (kh << 11) | (row << 7) |
              ((ch ^ (row & 7)) << 4) | (cl << 2);
    const uint32_t col = 4 * cl + i;  // of 16 columns; ch picks the 16
    o.st[i] = (half << 14) | (ch << 11) | (col << 7) |
              ((kh ^ (col & 7)) << 4) | (kl << 2);
  }
  return o;
}

// The lane's 16 steps over one staged tile, eight at a time: the eight
// steps' loads first (32 words in flight), then their transposes and
// stores. Step m moves k by 16 * (m % 8) and the column block by 16 *
// (m / 8) of the lane's step-0 block, an XOR of constants on its offsets.
__device__ __forceinline__ void transpose_tile(const uint8_t* staging,
                                               uint8_t* operand,
                                               const TransposeLane& tl) {
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    uint32_t r[8][4];
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[m][i] = *reinterpret_cast<const uint32_t*>(
            staging + (tl.ld[i] ^ (m << 11) ^ (g << 4)));
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const uint32_t t0 = __byte_perm(r[m][0], r[m][1], 0x5140);
      const uint32_t t1 = __byte_perm(r[m][0], r[m][1], 0x7362);
      const uint32_t t2 = __byte_perm(r[m][2], r[m][3], 0x5140);
      const uint32_t t3 = __byte_perm(r[m][2], r[m][3], 0x7362);
      const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410),
                               __byte_perm(t0, t2, 0x7632),
                               __byte_perm(t1, t3, 0x5410),
                               __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(
            operand + (tl.st[j] ^ (g << 11) ^ (m << 4))) = col[j];
    }
  }
}

#define R8(d, i)                                                         \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),            \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define R32(d, i) R8(d, i), R8(d, i + 8), R8(d, i + 16), R8(d, i + 24)
#define R128(d) R32(d, 0), R32(d, 32), R32(d, 64), R32(d, 96)
// operands %<i>0 .. %<i>9
#define OPS10(i)                                                          \
  "%" #i "0, %" #i "1, %" #i "2, %" #i "3, %" #i "4, %" #i "5, %" #i "6, " \
  "%" #i "7, %" #i "8, %" #i "9, "
// operands %0 .. %127
#define OPS128                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, " OPS10(1) OPS10(2) OPS10(3)  \
      OPS10(4) OPS10(5) OPS10(6) OPS10(7) OPS10(8) OPS10(9) OPS10(10)      \
          OPS10(11) "%120, %121, %122, %123, %124, %125, %126, %127}"

// D[64 x 256] += A[64 x 32] B[32 x 256], u8 x u8 -> s32, both operands
// K-major in shared memory
__device__ __forceinline__ void wgmma_u8(uint32_t (&d)[128], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.u8 " OPS128
      ", %128, %129, p;\n}"
      : R128(d)
      : "l"(a), "l"(b), "r"(1));
}

// KMAJOR: tm_planes maps the planes' [B, n] storage, else their [n, B].
template <bool PACKED, bool KMAJOR>
__global__ void __launch_bounds__(THREADS, 1)
parity_kernel(const __grid_constant__ CUtensorMap tm_mask,
              const __grid_constant__ CUtensorMap tm_planes, void* out,
              int q, int b, long long ld_out, int tiles_m, int tiles_n,
              int split, int k_tiles) {
  using L = Ring<KMAJOR>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t full = base + L::BAR_OFF;   // + 8 * stage, each barrier
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t loaded = empty + 8 * STAGES;
  auto op_a = [](int s) { return L::OPERAND_OFF + s * OPERAND_BYTES; };
  auto op_b = [](int s) {
    return L::OPERAND_OFF + s * OPERAND_BYTES + A_BYTES;
  };
  auto load_a = [](int s) { return s * OPERAND_BYTES; };
  auto staging = [](int s) { return s * OPERAND_BYTES + A_BYTES; };

  // block -> (row tile, column tile, split): row tiles fastest, so blocks
  // that read the same planes tile run together; splits slowest, so the
  // blocks in flight share a few mask ranges in L2
  const int tm = blockIdx.x % tiles_m;
  const int tn = (blockIdx.x / tiles_m) % tiles_n;
  const int sp = blockIdx.x / (tiles_m * tiles_n);
  const int kt0 = (int)((long long)sp * k_tiles / split);
  const int nk = (int)((long long)(sp + 1) * k_tiles / split) - kt0;
  const int row0 = tm * BM, col0 = tn * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, KMAJOR ? 1 : TRANSPOSERS);
      mbar_init(empty + 8 * s, CONSUMERS);  // every consumer thread
    }
    for (int s = 0; s < L::LOAD_STAGES; ++s) mbar_init(loaded + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  if (wg == 2) {
    const int tt = threadIdx.x - CONSUMERS;
    if constexpr (KMAJOR) {
      // --------------------------------------------------------- producer
      if (tt != 0) return;
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES, k0 = (kt0 + j) * BK;
        mbar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);  // lap 0 passes
        mbar_expect_tx(full + 8 * s, OPERAND_BYTES);
        tma_load_2d(base + op_a(s), &tm_mask, full + 8 * s, k0, row0);
        tma_load_2d(base + op_b(s), &tm_planes, full + 8 * s, k0, col0);
      }
    } else {
      // ---------------------------------------- loads and transposition
      // thread 256 issues the TMA loads of n tile kt0 + j into load stage
      // j % LOAD_STAGES and refills a stage once all the transposers are
      // done with it
      constexpr int LS = L::LOAD_STAGES;
      auto load = [&](int j) {
        const int s = j % LS, k0 = (kt0 + j) * BK;
        mbar_expect_tx(loaded + 8 * s, OPERAND_BYTES);
        tma_load_2d(base + load_a(s), &tm_mask, loaded + 8 * s, k0, row0);
        tma_load_2d(base + staging(s), &tm_planes, loaded + 8 * s, col0,
                    k0);
        tma_load_2d(base + staging(s) + BK * 128, &tm_planes,
                    loaded + 8 * s, col0 + 128, k0);
      };
      if (tt == 0)
        for (int j = 0; j < LS && j < nk; ++j) load(j);
      const TransposeLane tl = transpose_lane(warp, lane);
      for (int j = 0; j < nk; ++j) {
        const int ls = j % LS, s = j % STAGES;
        mbar_wait(loaded + 8 * ls, (j / LS) & 1);
        mbar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);  // lap 0 passes
        // the mask tile as it is, the planes tile transposed
        const uint4* a = reinterpret_cast<const uint4*>(gbase + load_a(ls));
        uint4* a_op = reinterpret_cast<uint4*>(gbase + op_a(s));
        constexpr int AV = A_BYTES / 16 / TRANSPOSERS;  // 16-byte words each
        uint4 x[AV];
#pragma unroll
        for (int k = 0; k < AV; ++k) x[k] = a[tt + k * TRANSPOSERS];
#pragma unroll
        for (int k = 0; k < AV; ++k) a_op[tt + k * TRANSPOSERS] = x[k];
        transpose_tile(gbase + staging(ls), gbase + op_b(s), tl);
        fence_proxy_async();  // the writes above feed wgmma (async proxy)
        mbar_arrive(full + 8 * s);
        bar_sync(TRANSPOSE_BAR, TRANSPOSERS);  // load stage ls is read
        if (tt == 0 && j + LS < nk) load(j + LS);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  uint32_t acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0u;
  for (int j = 0; j < nk; ++j) {
    const int s = j % STAGES;
    mbar_wait(full + 8 * s, (j / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      const uint64_t da = desc_sw128(
          base + op_a(s) + wg * 64 * 128 + ks * 32, 16, 8 * 128);
      const uint64_t db = desc_sw128(base + op_b(s) + ks * 32, 16, 8 * 128);
      wgmma_u8(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty + 8 * s);
  }

  // ------------------------------------------------------------- epilogue
  // element i of a thread: row r (+8 if i & 2), column 8 * (i / 4) +
  // 2 * (lane % 4) + (i & 1) of the tile
  const int r = row0 + wg * 64 + warp * 16 + lane / 4;
  const int quad = lane & 3;
  if constexpr (PACKED) {
    uint32_t* o = static_cast<uint32_t*>(out);
#pragma unroll
    for (int wj = 0; wj < BN / 32; ++wj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v = 0;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v |= (acc[4 * (4 * wj + jj) + 2 * h + e] & 1u)
                 << (8 * jj + 2 * quad + e);
        v |= __shfl_xor_sync(0xffffffffu, v, 1);
        v |= __shfl_xor_sync(0xffffffffu, v, 2);
        const int row = r + 8 * h, word = col0 / 32 + wj;
        if (quad == ((2 * wj + h) & 3) && row < q && word < ld_out) {
          uint32_t* p = o + row * ld_out + word;
          if (split == 1) *p = v;
          else if (v) atomicXor(p, v);
        }
      }
    }
  } else {
    uint8_t* o = static_cast<uint8_t*>(out);
#pragma unroll
    for (int jc = 0; jc < BN / 8; ++jc) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * jc + 2 * h;
        const uint32_t mine = (acc[i] & 1u) | ((acc[i + 1] & 1u) << 8);
        const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
        const int row = r + 8 * h, col = col0 + 8 * jc + 2 * quad;
        // the even lane of a pair writes its four columns as one word
        if ((quad & 1) == 0 && row < q && col < b) {
          uint32_t* p = reinterpret_cast<uint32_t*>(o + row * ld_out + col);
          const uint32_t v = mine | (other << 16);
          if (split == 1) *p = v;
          else if (v) atomicXor(p, v);
        }
      }
    }
  }
}

// a [rows][cols] uint8 matrix with a row stride of `ld` bytes, boxes of
// box_rows x 128 with the 128-byte swizzle; out-of-bounds bytes read as
// zero
bool tensor_map(CUtensorMap* map, const void* ptr, long long rows,
                long long cols, long long ld, int box_rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The number of n ranges: the fewest that come within 1 % of the least
// time in whole waves of `sms` blocks, (waves of tiles * split) / split.
int choose_split(long long tiles, int k_tiles, int sms) {
  int best = 1;
  double best_cost = (double)((tiles + sms - 1) / sms);
  // s = sms / gcd(tiles, sms) <= sms already fills whole waves
  for (int s = 2; s <= k_tiles && s <= sms; ++s) {
    const double cost = (double)((tiles * s + sms - 1) / sms) / s;
    if (cost < 0.99 * best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

template <bool PACKED, bool KMAJOR>
int launch(const CUtensorMap& tm_mask, const CUtensorMap& tm_planes,
           void* out, int q, int b, long long ld_out, int tiles_m,
           int tiles_n, int split, int k_tiles, int dev, cudaStream_t st) {
  constexpr int SMEM = Ring<KMAJOR>::SMEM;
  auto kern = parity_kernel<PACKED, KMAJOR>;
  static bool smem_raised[64] = {};  // per device, once
  if (!smem_raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_raised[dev] = true;
  }
  kern<<<(unsigned)((long long)tiles_m * tiles_n * split), THREADS, SMEM,
         st>>>(tm_mask, tm_planes, out, q, b, ld_out, tiles_m, tiles_n,
               split, k_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// mask: [q, n] with a row stride of ld_mask bytes. planes: k_major ? their
// [b, n] storage : [n, b], with a row stride of ld_planes bytes. Both
// uint8, 16-byte aligned, strides multiples of 16. out: packed ? [q,
// ld_out] 32-bit words (ld_out = ceil(b / 32)) : [q, ld_out] bytes (ld_out
// >= b, a multiple of 4), 4-byte aligned.
PIR_EXPORT int pir_parity_matmul(const void* mask, long long ld_mask,
                                 const void* planes, long long ld_planes,
                                 void* out, long long ld_out, int q, int n,
                                 int b, int packed, int k_major,
                                 void* stream) {
  if (q <= 0 || b <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t out_bytes = (size_t)q * ld_out * (packed ? 4 : 1);
  if (n <= 0) return (int)cudaMemsetAsync(out, 0, out_bytes, st);
  if (((uintptr_t)mask | (uintptr_t)planes) % 16 != 0 || ld_mask % 16 != 0 ||
      ld_planes % 16 != 0 || (uintptr_t)out % 4 != 0 ||
      (!packed && ld_out % 4 != 0))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap tm_mask, tm_planes;
  const bool mapped =
      tensor_map(&tm_mask, mask, q, n, ld_mask, BM) &&
      (k_major ? tensor_map(&tm_planes, planes, b, n, ld_planes, BN)
               : tensor_map(&tm_planes, planes, n, b, ld_planes, BK));
  if (!mapped) return (int)cudaErrorInvalidValue;
  static int sms_of[64] = {};  // per device, once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles_m = pir_ceil_div(q, BM), tiles_n = pir_ceil_div(b, BN);
  const int k_tiles = pir_ceil_div(n, BK);
  const long long tiles = (long long)tiles_m * tiles_n;
  const int split = choose_split(tiles, k_tiles, sms_of[dev]);
  if (tiles * split >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (split > 1) {
    err = cudaMemsetAsync(out, 0, out_bytes, st);
    if (err != cudaSuccess) return (int)err;
  }
  auto go = packed ? (k_major ? &launch<true, true> : &launch<true, false>)
                   : (k_major ? &launch<false, true> : &launch<false, false>);
  return go(tm_mask, tm_planes, out, q, b, ld_out, tiles_m, tiles_n, split,
            k_tiles, dev, st);
}
