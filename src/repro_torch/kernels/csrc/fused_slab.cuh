// The [n, BW] db slab on chip and the index walk over it: the kernel shared
// by fused_gather_fold.cu (one index row per query) and
// fused_multi_gather_fold.cu (k_max index rows per request, dead rows
// answering zero).
//
// A launch is a grid of thread-block clusters, (C, tiles, groups), with
// clusters of C <= 8 CTAs along x. A cluster owns one word tile of BW words
// for one group of index rows and stages that tile's slab once for all of
// them; each of its CTAs holds the whole slab in shared memory and walks
// its own share of the rows (whole requests in the multi kernel). The host
// (kernels/fused.py::fused_schedule) picks C, the groups, the rows a CTA
// owns, how many warps walk one row, and the staging path:
//
//   TMA   the CTAs' single threads issue the slab's 2-D boxes (256 rows at
//         most; a second map carries the ragged last box) between them,
//         each multicast to every CTA of the cluster: the slab leaves L2
//         once per cluster and lands asynchronously, completing on each
//         CTA's mbarrier. Taken where a tile row is 64 bytes or more (the
//         TMA unit moves short rows slowly), the store is 16-byte aligned
//         with W % 4 == 0, and 8 bytes beside the slab hold the barrier.
//   COPY  C == 1: the CTA copies the slab with cp.async (16 B a copy where
//         aligned; a row's 16-byte chunks swizzled, so that 32 lanes that
//         read 32 rows hit all 8 groups of banks), then a CTA barrier. No
//         mbarrier, so it also takes a slab that fills the opt-in limit to
//         the byte (n 7264 x 8 words = 232 448 B), W % 4 != 0 and an
//         unaligned store.
//
// The walk: 16 warps a CTA (the slab leaves room for one CTA an SM). A warp
// takes one index row (or 1/wpq of it, the other warps of its slot taking
// the rest) and loads its ids 32 at a time, one a lane, with one coalesced
// load, four chunks ahead of the ones it folds. A lane XORs the row its id
// names (ids < 0 or >= n skipped, a duplicate cancels) into 8 or 16
// registers, one word each, with 16-byte loads where BW % 4 == 0; four
// chunks are folded together without a branch, so their loads overlap. A
// tile wider than 16 words takes LR lanes a row, its ids handed round by
// shuffles. The lanes then fold by a transpose of shuffles that leaves each
// word of the row with one lane; with wpq == 1 the warp stores its row's
// words, otherwise the slot's warps combine through a [16][BW] scratch over
// the slab once every warp is done with it (the schedule keeps such a CTA
// to one round of rows). Each output word is written once, by the CTA that
// owns its row: no atomics, no zeroing.
#pragma once
#include "common.cuh"
#include "sm90.cuh"

namespace pir_slab {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int BOX_ROWS = 256;    // a TMA box is at most 256 rows
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr unsigned FULL = 0xffffffffu;

enum Staging { TMA = 0, COPY = 1 };

struct Args {
  const uint32_t* db;
  const int32_t* idx;
  const int32_t* offsets;  // multi: [requests + 1]; flat: unused
  uint32_t* out;
  int n, w, m;
  int rows;          // index rows: q, or requests * k_max
  int k_max;         // 1 for the flat kernel
  int bw;            // word-tile width, the slab's row stride
  int rows_per_cta;  // index rows one CTA owns (whole requests)
  int wpq;           // warps walking one index row: a power of two <= 16
  int staging;
  int vec4;          // 16-byte copies: db aligned, W and BW multiples of 4
  // COPY: the slab's 16-byte chunks are swizzled, chunk c of row r stored
  // at c ^ ((r >> swz_shift) & swz_mask), so that the rows 32 lanes read at
  // once spread over the 8 groups of 4 banks (0: not swizzled)
  int swz_shift, swz_mask;
};

// The flip of row r's chunks, as a word offset (the chunk swizzle).
__device__ __forceinline__ int swizzle(const Args& a, int r) {
  return ((r >> a.swz_shift) & a.swz_mask) << 2;
}

// COPY staging: db[:, tile_lo : tile_lo + bw_eff] into slab ([n][bw]) by
// cp.async, 16 B a copy where vec4, then a barrier of the CTA.
__device__ __forceinline__ void copy_slab(uint32_t* slab, const Args& a,
                                          int tile_lo, int bw_eff) {
  const int per = a.vec4 ? bw_eff / 4 : bw_eff;  // copies a row
  const int total = a.n * per;
  for (int e = threadIdx.x; e < total; e += THREADS) {
    const int r = e / per, c = (e - r * per) * (a.vec4 ? 4 : 1);
    const uint32_t dst =
        smem_u32(slab + (size_t)r * a.bw + (c ^ swizzle(a, r)));
    const uint32_t* src = a.db + (size_t)r * a.w + tile_lo + c;
    if (a.vec4)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                   "l"(src));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
                   "l"(src));
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
}

// TMA staging: this CTA's share of the slab's boxes, each multicast to the
// cluster's C CTAs. Box i covers rows [i*256, i*256 + 256); the last, if
// ragged, comes through `tail`, whose box is n % 256 rows.
__device__ __forceinline__ void issue_boxes(const CUtensorMap* body,
                                            const CUtensorMap* tail,
                                            uint32_t slab, uint32_t bar,
                                            const Args& a, int tile_lo,
                                            int rank, int csize) {
  const int body_rows = min(BOX_ROWS, a.n);
  const int full = a.n / body_rows;
  const int boxes = full + (a.n % body_rows ? 1 : 0);
  const uint16_t everyone = (uint16_t)((1u << csize) - 1u);
  for (int i = rank; i < boxes; i += csize) {
    const int row0 = i * body_rows;
    tma_load_2d_multicast(slab + (uint32_t)row0 * a.bw * 4u,
                          i < full ? body : tail, bar, tile_lo, row0,
                          everyone);
  }
}

// The walk's lanes. A lane folds WPL words of a row (8 for a tile of up to
// 8 words, else 16), LR lanes a row (the next power of two >= BW / WPL, 1
// for the tiles of the serving shapes), 32 / LR rows a step. With LR == 1
// a lane folds the row of its own id, with no shuffle.
struct Lanes {
  int lr, tx, ty, c0;  // lanes a row; this lane's place; its first word
};

// acc[i] ^= row r's word c0 + i for i < WPL, the words at or past bw_eff
// dropped (cols: a bit a word), and the whole row dropped when r is not in
// [0, n) (it reads row 0 instead: no branch). VEC reads 16 B at a time (the
// slab's rows are 16-byte aligned when BW % 4 == 0).
template <int WPL, bool VEC>
__device__ __forceinline__ void fold_row(uint32_t (&acc)[WPL], int32_t r,
                                         const uint32_t* slab, const Args& a,
                                         int c0, uint32_t cols) {
  const bool ok = (unsigned)r < (unsigned)a.n;
  const int row = ok ? r : 0;
  const uint32_t* p = slab + (size_t)row * a.bw;
  if constexpr (VEC) {
    // words of a chunk at or past bw_eff fold junk into acc words that are
    // never stored; acc ^ (q & keep) is one LOP3 a word
    const uint32_t keep = ok ? ~0u : 0u;
    const int flip = swizzle(a, row);
#pragma unroll
    for (int i = 0; i < WPL; i += 4) {
      if (!(cols >> i & 1u)) continue;  // the same for every id: no branch
      const uint4 q = *reinterpret_cast<const uint4*>(p + ((c0 + i) ^ flip));
      acc[i] ^= q.x & keep;
      acc[i + 1] ^= q.y & keep;
      acc[i + 2] ^= q.z & keep;
      acc[i + 3] ^= q.w & keep;
    }
  } else {
#pragma unroll
    for (int i = 0; i < WPL; ++i) {  // BW % 4 != 0: never swizzled
      const uint32_t x = cols >> i & 1u ? p[c0 + i] : 0u;
      acc[i] ^= ok ? x : 0u;
    }
  }
}

// acc ^= the rows of this warp's share of one index row (chunks part,
// part + wpq, ... of 32 ids, one id a lane), PREFETCH chunks of ids in
// flight and folded together without a branch (ids past the row's end read
// as -1), so that their loads overlap.
template <int WPL, bool VEC>
__device__ __forceinline__ void walk(uint32_t (&acc)[WPL],
                                     const int32_t* __restrict__ ids,
                                     int m_row, int part, int wpq,
                                     const Args& a, const uint32_t* slab,
                                     const Lanes& ln, uint32_t cols,
                                     int lane) {
  constexpr int PREFETCH = 4;
  const int chunks = (m_row + 31) >> 5;
  const int mine = chunks > part ? (chunks - part + wpq - 1) / wpq : 0;
  auto load = [&](int j) -> int32_t {  // this lane's id of chunk j
    const int at = (part + j * wpq) * 32 + lane;
    return j < mine && at < m_row ? __ldg(ids + at) : -1;
  };
  int32_t ahead[PREFETCH];
#pragma unroll
  for (int d = 0; d < PREFETCH; ++d) ahead[d] = load(d);
  for (int j = 0; j < mine; j += PREFETCH) {
    int32_t cur[PREFETCH];
#pragma unroll
    for (int d = 0; d < PREFETCH; ++d) {
      cur[d] = ahead[d];
      ahead[d] = load(j + PREFETCH + d);
    }
    if (ln.lr == 1) {  // the same for the whole launch
#pragma unroll
      for (int d = 0; d < PREFETCH; ++d)
        fold_row<WPL, VEC>(acc, cur[d], slab, a, ln.c0, cols);
    } else {
      const int rows_a_step = 32 / ln.lr;
#pragma unroll
      for (int d = 0; d < PREFETCH; ++d)
        for (int k = 0; k < ln.lr; ++k)
          fold_row<WPL, VEC>(
              acc, __shfl_sync(FULL, cur[d], k * rows_a_step + ln.ty), slab,
              a, ln.c0, cols);
    }
  }
}

// Folds acc over the lanes that share lane % lr as a transpose: at each
// step the lanes `off` apart swap halves of what they hold, so a lane's
// words halve (2 * WPL - 2 shuffles in all where a plain fold takes WPL a
// step). After it the lane holds `held` words of its pass, from word `base`
// on, in acc[0 .. held); a lane with a bit of `dup` set holds a copy.
template <int WPL>
__device__ __forceinline__ void fold_lanes(uint32_t (&acc)[WPL], int lr,
                                           int lane, int& base, int& held,
                                           int& dup) {
  base = 0;
  held = WPL;
  dup = 0;
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    const int off = 16 >> r;
    if (off < lr) break;  // the same for the whole launch
    const int h = WPL >> (r + 1);  // words kept: a constant once unrolled
    if (h >= 1) {
      const bool upper = lane & off;
#pragma unroll
      for (int i = 0; i < WPL / 2; ++i) {
        if (i >= h) break;
        const uint32_t send = upper ? acc[i] : acc[i + h];
        const uint32_t keep = upper ? acc[i + h] : acc[i];
        acc[i] = keep ^ __shfl_xor_sync(FULL, send, off);
      }
      if (upper) base += h;
      held = h;
    } else {
      acc[0] ^= __shfl_xor_sync(FULL, acc[0], off);
      dup |= off;
    }
  }
}

template <bool MULTI, int WPL, bool VEC>
__global__ void __launch_bounds__(THREADS)
slab_kernel(const __grid_constant__ CUtensorMap body,
            const __grid_constant__ CUtensorMap tail,
            const __grid_constant__ Args a) {
  extern __shared__ __align__(128) uint32_t smem[];
  const int csize = gridDim.x, rank = blockIdx.x;  // the cluster spans x
  const int tile_lo = blockIdx.y * a.bw;
  const int bw_eff = min(a.bw, a.w - tile_lo);
  const int row_lo = (blockIdx.z * csize + rank) * a.rows_per_cta;
  const int row_hi = min(a.rows, row_lo + a.rows_per_cta);
  uint32_t* slab = smem;
  // wpq > 1: the warps' [WARPS][bw] scratch lies over the slab once the
  // walk is done with it (such a CTA walks one round of rows, one pass)
  uint32_t* scratch = smem;
  const int slab_rows = a.wpq > 1 ? max(a.n, WARPS) : a.n;

  // ------------------------------------------------------------ staging
  if (a.staging == TMA) {
    const uint32_t bar = smem_u32(smem + (size_t)slab_rows * a.bw);
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      fence_mbarrier_init_cluster();
      mbar_expect_tx(bar, (uint32_t)a.n * a.bw * 4u);
    }
    cluster_sync();  // every CTA's barrier is armed before a box lands
    if (threadIdx.x == 0)
      issue_boxes(&body, &tail, smem_u32(slab), bar, a, tile_lo, rank,
                  csize);
    mbar_wait(bar, 0);
  } else {
    copy_slab(slab, a, tile_lo, bw_eff);
  }

  // --------------------------------------------------------------- walk
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  Lanes ln;
  ln.lr = 1;
  while (ln.lr * WPL < bw_eff && ln.lr < 32) ln.lr <<= 1;
  ln.tx = lane & (ln.lr - 1);
  ln.ty = lane / ln.lr;
  const int per_round = WARPS / a.wpq;
  const int slot = wid / a.wpq, part = wid - slot * a.wpq;
  for (int r0 = row_lo; r0 < row_hi; r0 += per_round) {  // uniform
    const int row = r0 + slot;
    int m_row = 0;
    if (row < row_hi) {
      m_row = a.m;
      if constexpr (MULTI) {  // a dead row answers zero, its ids unread
        const int req = row / a.k_max, i = row - req * a.k_max;
        const int count = __ldg(a.offsets + req + 1) - __ldg(a.offsets + req);
        if (i >= min(count, a.k_max)) m_row = 0;
      }
    }
    const int32_t* ids = a.idx + (size_t)row * a.m;
    for (int wbase = 0; wbase < bw_eff; wbase += ln.lr * WPL) {
      ln.c0 = wbase + ln.tx * WPL;
      uint32_t cols = 0;  // the words of the pass this lane holds
#pragma unroll
      for (int i = 0; i < WPL; ++i)
        cols |= (uint32_t)(ln.c0 + i < bw_eff) << i;
      uint32_t acc[WPL];
#pragma unroll
      for (int i = 0; i < WPL; ++i) acc[i] = 0u;
      walk<WPL, VEC>(acc, ids, m_row, part, a.wpq, a, slab, ln, cols, lane);
      int base, held, dup;
      fold_lanes<WPL>(acc, ln.lr, lane, base, held, dup);
      const bool writer = (lane & dup) == 0;  // one lane a word
      if (a.wpq == 1 && row < row_hi && writer) {
        uint32_t* dst = a.out + (size_t)row * a.w + tile_lo + ln.c0 + base;
#pragma unroll
        for (int i = 0; i < WPL; ++i)
          if (i < held && (cols >> (base + i) & 1u)) dst[i] = acc[i];
      }
      if (a.wpq == 1) continue;
      __syncthreads();  // every warp is done with the slab
      if (writer) {
        uint32_t* dst = scratch + wid * a.bw + ln.c0 + base;
#pragma unroll
        for (int i = 0; i < WPL; ++i)
          if (i < held && (cols >> (base + i) & 1u)) dst[i] = acc[i];
      }
      __syncthreads();
      const int span = min(ln.lr * WPL, bw_eff - wbase);
      for (int e = threadIdx.x; e < per_round * span; e += THREADS) {
        const int s = e / span, c = wbase + e - s * span;
        if (r0 + s < row_hi) {
          uint32_t x = 0u;
          for (int p = 0; p < a.wpq; ++p)
            x ^= scratch[(s * a.wpq + p) * a.bw + c];
          a.out[(size_t)(r0 + s) * a.w + tile_lo + c] = x;
        }
      }
      __syncthreads();
    }
  }
  // no CTA leaves while boxes it issued may still land in its peers
  if (csize > 1) cluster_sync();
}

// --------------------------------------------------------------------- host
// db [n, w] u32 as a TMA map of boxes [box_rows][bw]; columns past w read
// as zero (the ragged last word tile).
inline bool slab_map(CUtensorMap* map, const void* db, int n, int w, int bw,
                     int box_rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)w, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)w * 4};
  const cuuint32_t box[2] = {(cuuint32_t)bw, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2,
                const_cast<void*>(db), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The dynamic shared memory of one CTA (fused.py::fused_schedule computes
// the same): the slab, at least WARPS rows of it where the scratch lies
// over it, then the TMA path's mbarrier.
static inline size_t smem_bytes(int n, int bw, int wpq, int staging) {
  return (size_t)(wpq > 1 && n < WARPS ? WARPS : n) * bw * 4 +
         (staging == TMA ? 8 : 0);
}

typedef void (*Kernel)(CUtensorMap, CUtensorMap, Args);

// The instance for a tile of bw words: 8 or 16 words a lane, 16-byte
// loads where the slab's rows are 16-byte aligned.
template <bool MULTI>
Kernel kernel_for(int bw) {
  if (bw % 4 == 0)
    return bw <= 8 ? slab_kernel<MULTI, 8, true> : slab_kernel<MULTI, 16, true>;
  return bw <= 8 ? slab_kernel<MULTI, 8, false> : slab_kernel<MULTI, 16, false>;
}

// The opt-in shared-memory limit, set on each kernel instance once per
// process and device rather than before every launch; *optin gets it.
inline cudaError_t configure(Kernel fn, int* optin) {
  static Kernel seen[8] = {};
  static uint64_t done[8] = {};  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  int slot = 0;
  while (slot < 7 && seen[slot] != nullptr && seen[slot] != fn) ++slot;
  if (seen[slot] == fn && dev < 64 && (done[slot] >> dev & 1u))
    return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *optin);
  if (err == cudaSuccess && dev < 64) {
    seen[slot] = fn;
    done[slot] |= 1ull << dev;
  }
  return err;
}

inline cudaLaunchConfig_t cluster_config(dim3 grid, size_t smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = grid.x;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One launch of the schedule fused.py computed: `csize` CTAs a cluster,
// `groups` clusters a word tile, `rows_per_cta` index rows a CTA, `wpq`
// warps an index row, staging TMA or COPY. Returns a cudaError_t.
template <bool MULTI>
int launch(const void* db, const void* idx, const void* offsets, void* out,
           int n, int w, int rows, int k_max, int m, int bw, int csize,
           int groups, int rows_per_cta, int wpq, int staging,
           cudaStream_t stream) {
  if (n <= 0 || w <= 0 || rows <= 0 || m <= 0 || bw <= 0 || bw > w ||
      csize < 1 || csize > MAX_CLUSTER || groups < 1 || rows_per_cta < 1 ||
      wpq < 1 || wpq > WARPS || (wpq & (wpq - 1)) != 0 ||
      (staging != TMA && staging != COPY) || (staging == COPY && csize > 1) ||
      (long long)groups * csize * rows_per_cta < rows ||
      // the scratch over the slab: one round of rows, one pass of words
      (wpq > 1 && (rows_per_cta > WARPS / wpq || bw > 32 * 16)))
    return (int)cudaErrorInvalidValue;
  const int tiles = pir_ceil_div(w, bw);
  const bool aligned = reinterpret_cast<uintptr_t>(db) % 16 == 0 &&
                       w % 4 == 0 && bw % 4 == 0;
  if (staging == TMA && (!aligned || bw > 256))
    return (int)cudaErrorInvalidValue;
  CUtensorMap body = {}, tail = {};
  if (staging == TMA) {
    const int body_rows = n < BOX_ROWS ? n : BOX_ROWS;
    if (!slab_map(&body, db, n, w, bw, body_rows) ||
        (n % body_rows && !slab_map(&tail, db, n, w, bw, n % body_rows)))
      return (int)cudaErrorInvalidValue;
  }
  // the chunk swizzle where a row holds K = bw / 4 chunks, K a power of two
  // from 2: rows r .. r + 8/K - 1 cover the 8 bank groups once, so row r
  // flips its chunks by (r >> log2(8 / K)) mod K (by r mod 8 from K = 8)
  int swz_shift = 0, swz_mask = 0;
  const int chunks = bw / 4;
  if (staging == COPY && bw % 4 == 0 && chunks >= 2 &&
      (chunks & (chunks - 1)) == 0) {
    swz_mask = (chunks < 8 ? chunks : 8) - 1;
    while ((chunks << swz_shift) < 8) ++swz_shift;
  }
  Args a{(const uint32_t*)db, (const int32_t*)idx, (const int32_t*)offsets,
         (uint32_t*)out, n, w, m, rows, k_max, bw, rows_per_cta, wpq,
         staging, aligned ? 1 : 0, swz_shift, swz_mask};
  const Kernel fn = kernel_for<MULTI>(bw);
  int optin = 0;
  cudaError_t err = configure(fn, &optin);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(n, bw, wpq, staging);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(csize, tiles, groups), smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, fn, body, tail, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `csize` CTAs with `smem` bytes each the card can
// hold at once (cudaOccupancyMaxActiveClusters); 0 = such a cluster never
// fits. Negative: the cudaError_t of the query.
template <bool MULTI>
int active_clusters(int csize, int smem) {
  const Kernel fn = kernel_for<MULTI>(8);
  int optin = 0;
  cudaError_t err = configure(fn, &optin);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(csize, 1, 1), (size_t)smem, nullptr, &attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, fn, &cfg);
  return err == cudaSuccess ? count : -(int)err;
}

}  // namespace pir_slab
