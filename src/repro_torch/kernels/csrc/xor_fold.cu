// xor_fold: out[q, :] = XOR_{i : mask[q, i] != 0} db[i, :]
//
// Replaces the TPU kernel of the reference package's kernels/xor_fold.py
// (`_kernel`, the pl.pallas_call at :79; grid (q-blocks, w-blocks,
// n-blocks) with n innermost).
//
// Two forms, both here; the wrapper picks one by the number of queries
// (xor_fold.py::_form_for, a choice by shape measured on the card). Both
// split the record axis across blocks and combine the partial folds with
// atomicXor into a zeroed output: XOR is associative and commutative, so
// any order gives the same bytes. Ragged edges of q, n and W are
// predicated (zero-filled copies, masked stores), never padded.
//
// 1. The streaming form (pir_xor_fold), for few queries. A block holds QT
//    = 8 queries in registers and streams its row chunk of the store past
//    them: TX lanes over the word tile (16 B a thread where W allows), TY
//    lanes over rows, the block's mask tile staged transposed in shared
//    memory so that one broadcast read serves all 8 queries. Bound: bytes
//    at q 8 (the store, n*W*4 B, over 3.35 TB/s). But the store streams
//    once for every 8 queries, and every (row, query, word) costs one
//    AND+XOR (one LOP3). Compute capability 9.0 issues 64 32-bit logical
//    ops per clock per SM: 132 x 64 x 1.98 GHz = 16.7 T op/s, so the form
//    cannot beat q*n*W / 16.7 T (2.9 ms for 128 queries over the CT store,
//    against 0.46 ms of bytes) whatever it does about the bytes.
//
// 2. The table form (pir_xor_fold_table), for many queries: the Method of
//    Four Russians. A first launch packs the mask to bits, once: it reads
//    the q*n mask bytes with 16-byte loads and writes pm [ceil(n/32), q]
//    uint32 words, word s of query a holding rows 32s..32s+31 (the mask
//    stream is not multiplied: the fold re-reads only these q*n/8 bytes,
//    once per word tile). The fold's block owns a row chunk x a word tile
//    of 32*VEC words x a group of up to 256 queries (nw warps of QW
//    queries; one register accumulator of VEC words per query per lane).
//    Per stage of 32 rows it
//      - lands the stage's rows in shared memory by cp.async, RING - 1
//        stages ahead (each thread copies exactly the words it later reads,
//        so its own wait_group is the only ordering it needs);
//      - builds, for each of the stage's TG = 8 groups of TK = 4 rows, the
//        16 XOR combinations of the group's rows over the word tile
//        (entry e = XOR of the rows whose bit is set in e; entry 0 stays
//        zero), in Gray-code order from one running register;
//      - between two barriers, lets every query XOR one table entry per
//        group into its accumulator, the entry indexed by its 4 mask bits
//        (a warp-uniform index: the warp reads 32 lanes x VEC consecutive
//        words, free of bank conflicts).
//    So a query costs one table read and one XOR per 4 rows and word in
//    place of 4 LOP3s, and a stage's table build (15 entries per group and
//    word) is shared by every query of the block. Bound: shared-memory
//    bandwidth, 128 B per clock per SM (132 x 128 B x 1.98 GHz = 33.5
//    TB/s). The queries read q*n*W bytes of table entries (4 bytes a word
//    per 4 rows): 1.47 ms for 128 queries over the CT store, 0.33 ms at the
//    private BERT4Rec shape (6400 queries over 26 752 x 64 words), beside
//    0.46 and 0.05 ms of device-memory bytes; the build adds 15/4 bytes a
//    row word per query group. k = 4 keeps a stage's eight tables at 32 KB
//    (VEC 2), so a 48 KB block leaves room for four blocks an SM; k = 5 or
//    6 would cut the bytes by about a tenth at 128 queries, and k = 8
//    needs 64 KB for one table and as many build bytes as lookups at 256
//    queries a block.
//    The store is read from device memory once whenever q <= 256 (one
//    query group); beyond, each group re-reads it (from L2 where it fits,
//    as the private BERT4Rec store does). A warp takes QW = 8 or 32
//    queries, the caller's choice (xor_fold.py::_table_width, by q, as
//    measured on the card): at few queries narrow warps put more warps on
//    an SM, whose resident blocks are capped by shared memory.
#include "common.cuh"

namespace {

// ------------------------------------------------------------ streaming form
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

// ---------------------------------------------------------------- table form
constexpr int TK = 4;              // rows per table: the method's k
constexpr int TE = 1 << TK;        // entries per table
constexpr int SROWS = 32;          // rows per stage: one packed mask word
constexpr int TG = SROWS / TK;     // tables per stage
constexpr int RING = 2;            // row stages in shared memory
constexpr int MAX_WARPS = 8;
constexpr int PACK_THREADS = 128;
static_assert(SROWS % TK == 0, "a stage holds whole tables");

__host__ __device__ constexpr int lowest_bit(int i) {
  return (i & 1) ? 0 : 1 + lowest_bit(i >> 1);
}

template <int VEC> struct Words;
template <> struct Words<1> { using T = uint32_t; };
template <> struct Words<2> { using T = uint2; };

__device__ __forceinline__ uint32_t wxor(uint32_t a, uint32_t b) {
  return a ^ b;
}
__device__ __forceinline__ uint2 wxor(uint2 a, uint2 b) {
  return make_uint2(a.x ^ b.x, a.y ^ b.y);
}
__device__ __forceinline__ bool wnz(uint32_t a) { return a != 0u; }
__device__ __forceinline__ bool wnz(uint2 a) { return (a.x | a.y) != 0u; }
__device__ __forceinline__ void wred(uint32_t* p, uint32_t a) {
  atomicXor(p, a);
}
__device__ __forceinline__ void wred(uint32_t* p, uint2 a) {
  // both words in one 64-bit atomic (p is 8-byte aligned: W even)
  atomicXor(reinterpret_cast<unsigned long long*>(p),
            (static_cast<unsigned long long>(a.y) << 32) | a.x);
}

// bit b of the result is set iff byte b of v is non-zero
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t v) {
  uint32_t t = (((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) >> 7 & 0x01010101u;
  return (t * 0x00204081u) >> 21 & 0xfu;  // gathers bits 0, 8, 16, 24
}

__device__ __forceinline__ uint32_t nonzero_bytes(uint4 v) {
  return nonzero_bytes(v.x) | nonzero_bytes(v.y) << 4 |
         nonzero_bytes(v.z) << 8 | nonzero_bytes(v.w) << 12;
}

// pm[s * q + a], bit j = (mask[a, 32 s + j] != 0); rows past n give 0.
// Threads run along queries, so the words are stored coalesced; each
// thread reads its 32 mask bytes as two 16-byte loads where the rows
// allow it.
__global__ void __launch_bounds__(PACK_THREADS)
xor_fold_pack_kernel(const uint8_t* __restrict__ mask,
                     uint32_t* __restrict__ pm, int n, int q, int n32,
                     int vec16) {
  const int a = blockIdx.x * PACK_THREADS + threadIdx.x;
  if (a >= q) return;
  const uint8_t* row = mask + (long long)a * n;
  for (int s = blockIdx.y; s < n32; s += gridDim.y) {
    const int r0 = s * SROWS;
    uint32_t bits = 0u;
    if (vec16 && r0 + SROWS <= n) {
      const uint4* p = reinterpret_cast<const uint4*>(row + r0);
      bits = nonzero_bytes(p[0]) | nonzero_bytes(p[1]) << 16;
    } else {
      for (int j = 0; j < SROWS && r0 + j < n; ++j)
        bits |= static_cast<uint32_t>(row[r0 + j] != 0) << j;
    }
    pm[(long long)s * q + a] = bits;
  }
}

// cp.async of one lane's VEC words; a copy of 0 source bytes zero-fills
template <int VEC>
__device__ __forceinline__ void copy_words(void* dst, const uint32_t* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const uint32_t bytes = ok ? 4 * VEC : 0;
  if constexpr (VEC == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory: tables [TG][TE][32] then rows [RING][SROWS][32],
// in units of one lane's VEC words.
template <int VEC>
constexpr size_t table_smem() {
  return (size_t)(TG * TE + RING * SROWS) * 32 * VEC *
         sizeof(uint32_t);
}

template <int VEC, int QW>
__global__ void __launch_bounds__(MAX_WARPS * 32)
xor_fold_table_kernel(const uint32_t* __restrict__ db,
                      const uint32_t* __restrict__ pm,
                      uint32_t* __restrict__ out, int n, int w, int q,
                      int n32, int stages_per_chunk) {
  using V = typename Words<VEC>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* tab = reinterpret_cast<V*>(smem_raw);
  V* rows = tab + TG * TE * 32;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int wcol = (blockIdx.y * 32 + lane) * VEC;
  const bool w_ok = wcol < w;  // VEC 2 implies w even: both words or none
  const int qa0 = (blockIdx.z * nw + warp) * QW;  // this warp's queries
  const int s_begin = blockIdx.x * stages_per_chunk;
  const int s_end = min(s_begin + stages_per_chunk, n32);

  for (int i = threadIdx.x; i < TG * 32; i += blockDim.x)
    tab[(i >> 5) * TE * 32 + (i & 31)] = V{};  // entry 0 of every table

  // a thread copies, and later reads, the words of its lane in the rows of
  // groups warp, warp + nw, ... of a stage
  auto issue = [&](int s, int slot) {
    for (int g = warp; g < TG; g += nw) {
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const int r = s * SROWS + g * TK + j;
        const bool ok = w_ok && r < n;
        copy_words<VEC>(&rows[(slot * SROWS + g * TK + j) * 32 + lane],
                        ok ? db + (long long)r * w + wcol : db, ok);
      }
    }
  };

  V acc[QW];
#pragma unroll
  for (int a = 0; a < QW; ++a) acc[a] = V{};
  // lane a < QW holds query qa0 + a's mask word of the current stage
  const bool q_ok = lane < QW && qa0 + lane < q;
  const uint32_t* pmq = pm + qa0 + lane;
  uint32_t mcur =
      q_ok && s_begin < s_end ? pmq[(long long)s_begin * q] : 0u;

#pragma unroll
  for (int i = 0; i < RING - 1; ++i) {
    if (s_begin + i < s_end) issue(s_begin + i, i);
    copy_commit();
  }
  for (int s = s_begin, it = 0; s < s_end; ++s, ++it) {
    if (s + RING - 1 < s_end) issue(s + RING - 1, (it + RING - 1) % RING);
    copy_commit();
    const uint32_t mnext =
        q_ok && s + 1 < s_end ? pmq[(long long)(s + 1) * q] : 0u;
    copy_wait<RING - 1>();  // this thread's rows of stage s have landed

    // build: entry e of a group's table = XOR of the rows set in e, in
    // Gray-code order (entry i ^ (i >> 1) differs from the one before it
    // by row ctz(i)), one running register
    const int slot = it % RING;
    __syncthreads();  // every query is done with stage s - 1's tables
    for (int g = warp; g < TG; g += nw) {
      const V* r = rows + (slot * SROWS + g * TK) * 32 + lane;
      V rj[TK];
#pragma unroll
      for (int j = 0; j < TK; ++j) rj[j] = r[j * 32];
      V* t = tab + g * TE * 32 + lane;
      V cur = V{};
#pragma unroll
      for (int i = 1; i < TE; ++i) {
        cur = wxor(cur, rj[lowest_bit(i)]);
        t[(i ^ (i >> 1)) * 32] = cur;
      }
    }
    __syncthreads();  // the tables of stage s are complete

    const V* tb = tab + lane;
#pragma unroll
    for (int a = 0; a < QW; ++a) {
      const uint32_t m = __shfl_sync(0xffffffffu, mcur, a);
#pragma unroll
      for (int g = 0; g < TG; ++g) {
        const uint32_t e = (m >> (TK * g)) & (TE - 1);
        acc[a] = wxor(acc[a], tb[(g * TE + e) * 32]);
      }
    }
    mcur = mnext;
  }

  if (w_ok) {
#pragma unroll
    for (int a = 0; a < QW; ++a)
      if (qa0 + a < q && wnz(acc[a]))
        wred(out + (long long)(qa0 + a) * w + wcol, acc[a]);
  }
}

template <int VEC, int QW>
cudaError_t launch_table(const uint32_t* db, const uint32_t* pm,
                         uint32_t* out, int n, int w, int q, int n32, int nw,
                         cudaStream_t s) {
  auto* k = xor_fold_table_kernel<VEC, QW>;
  const size_t smem = table_smem<VEC>();
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  static int sms_of[64] = {};  // per device, once
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, nw * 32,
                                                    smem);
  if (e != cudaSuccess) return e;
  const int w_tiles = pir_ceil_div(w, 32 * VEC);
  const int q_groups = pir_ceil_div(q, nw * QW);
  if (w_tiles > 65535 || q_groups > 65535) return cudaErrorInvalidValue;
  // about two waves of blocks, split along the rows; every chunk whole
  // stages, and no more chunks than stages
  const long long want = 2LL * sms_of[dev] * (per_sm > 0 ? per_sm : 1);
  const long long units = (long long)w_tiles * q_groups;
  long long chunks = (want + units - 1) / units;
  if (chunks > n32) chunks = n32;
  const int per = pir_ceil_div(n32, chunks);
  dim3 grid(pir_ceil_div(n32, per), w_tiles, q_groups);
  k<<<grid, nw * 32, smem, s>>>(db, pm, out, n, w, q, n32, per);
  return cudaGetLastError();
}

}  // namespace

// The streaming form. out must be zeroed by the caller. Returns
// cudaGetLastError().
PIR_EXPORT int pir_xor_fold(const void* db, const void* mask, void* out,
                            int n, int w, int q, void* stream) {
  if (n <= 0 || w <= 0 || q <= 0) return 0;
  const bool vec4 = (w % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(db) % 16 == 0);
  const int vec = vec4 ? 4 : 1;
  const int w_tiles = pir_ceil_div(w, TX * vec);
  const int q_tiles = pir_ceil_div(q, QT);
  if (w_tiles > 65535 || q_tiles > 65535) return (int)cudaErrorInvalidValue;
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

// The table form: packs the mask into pm (ceil(n/32) * q uint32 words of
// scratch), then folds by table lookup with qw (8 or 32) queries a warp.
// out must be zeroed by the caller. Returns cudaGetLastError().
PIR_EXPORT int pir_xor_fold_table(const void* db, const void* mask, void* pm,
                                  void* out, int n, int w, int q, int qw,
                                  void* stream) {
  if (qw != 8 && qw != 32) return (int)cudaErrorInvalidValue;
  if (n <= 0 || w <= 0 || q <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n32 = pir_ceil_div(n, SROWS);
  const int vec16 =
      n % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  dim3 pgrid(pir_ceil_div(q, PACK_THREADS), n32 < 65535 ? n32 : 65535);
  xor_fold_pack_kernel<<<pgrid, PACK_THREADS, 0, s>>>(
      (const uint8_t*)mask, (uint32_t*)pm, n, q, n32, vec16);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const bool vec2 = w % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(db) % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 8 == 0;
  int nw = 1;  // warps a block, up to 8 sharing a stage's tables
  while (nw < MAX_WARPS && nw * qw < q) nw *= 2;
  const uint32_t* d = (const uint32_t*)db;
  const uint32_t* p = (const uint32_t*)pm;
  uint32_t* o = (uint32_t*)out;
  if (qw == 32)
    e = vec2 ? launch_table<2, 32>(d, p, o, n, w, q, n32, nw, s)
             : launch_table<1, 32>(d, p, o, n, w, q, n32, nw, s);
  else
    e = vec2 ? launch_table<2, 8>(d, p, o, n, w, q, n32, nw, s)
             : launch_table<1, 8>(d, p, o, n, w, q, n32, nw, s);
  return (int)e;
}
