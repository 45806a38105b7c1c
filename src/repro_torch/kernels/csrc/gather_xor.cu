// gather_xor: out[q, :] = XOR_{j : idx[q, j] >= 0} db[idx[q, j], :]
//
// Replaces the TPU kernel of the reference package's kernels/gather_xor.py
// (`_kernel`: scalar-prefetched indices drive one row DMA per grid step).
//
// Bound: bytes. Only the selected rows are touched; the least time is the
// distinct live rows x W*4 bytes + the index bytes + the output, over the
// memory rate. At Sparse-PIR's density most rows are selected by several
// queries of a batch (1 - 0.75^8 = 90 % of the rows by at least one of 8),
// so a walk per query, which reads a row once for every query that lists
// it, moves 2-8x those bytes.
//
// Design: a block owns a row range and a word tile, for a group of up to
// QG queries together, and reads each selected row of its range once.
//  1. A prep pass reads every index list once. It flags a list that is not
//     ascending (as uint32, so trailing -1 padding counts as ascending) and,
//     for an ascending list, writes where each row range starts in it: the
//     lower bounds the range blocks need, with no search.
//  2. A range block XORs bit a into sel[row - r0] for every occurrence of
//     a row in query a's segment (shared-memory atomicXor, so a row listed
//     twice cancels, as the fold demands). sel[r] is then the set of
//     queries that fold row r an odd number of times.
//  3. The rows some query selects are compacted into a list in order (a
//     block scan). A group of 8, 16 or 32 queries is NG sets of 8; teams
//     of NG warps (one per set) walk the list a stage of NG x UNROLL rows
//     at a time. Each warp copies UNROLL rows of a stage into its own
//     shared-memory ring with cp.async (16 B per lane where W and block_w
//     allow; STAGES - 1 stages in flight). For each of its 8 queries it
//     then XORs the stage rows that query selects (a ballot over the
//     rows' sets) into that query's register accumulators: the work is one
//     shared-memory read and XOR per (row, query) member, not a test of
//     every query on every row. A tile is read once from device memory;
//     teams sync by named barriers, and a team of one warp (q <= 8) not
//     at all.
//  4. The TY warps' partial folds meet in shared memory and are combined
//     with those of the other row ranges by atomicXor into a zeroed output
//     (bit-exact in any order: XOR is associative and commutative).
// A flagged list (shuffled ids, -1 inside the row) is left out of the
// range blocks and walked instead by the launch's walk blocks: each takes
// a chunk of every flagged list of its group, TY warps fetching rows in
// turn, as a per-query gather does. Nothing goes back to the host: an
// ascending batch costs the walk blocks a flag read each. A launch with
// no ranges (the wrapper's choice for a single query, which shares no
// row) walks every list and needs no prep pass. Ids outside [0, n) are
// skipped (outside the contract; never read).
//
// grid_order: ranges_on_x = 1 ("qwm") puts the row ranges (then the walk
// chunks) on blockIdx.x and the word tiles on blockIdx.y, so neighbouring
// blocks stream neighbouring rows of one tile; 0 ("wqm") swaps them, so
// neighbouring blocks read the tiles of one row range. Query groups are
// on blockIdx.z. Every order and block_w gives identical bits.
#include "common.cuh"

namespace {

// PIR_GATHER_FOLD=0 builds the range blocks without their per-query XORs
// (rows are still staged): a diagnostic of scripts/gather_xor_fold_probe.py.
#ifndef PIR_GATHER_FOLD
#define PIR_GATHER_FOLD 1
#endif

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int STAGES = 4;  // a warp's cp.async ring: STAGES - 1 in flight
constexpr int UNROLL = 2;  // rows a warp copies a stage
constexpr int PREP_THREADS = 256;

// Boundary k of the row ranges is x_k = min(k * rows, n), k = 0..ranges;
// the last boundary k with x_k <= v.
__device__ __forceinline__ long long last_boundary(uint32_t v, int n,
                                                   int rows, int ranges) {
  return v >= (uint32_t)n ? ranges : v / (uint32_t)rows;
}

// flag[b] = 1 where idx[b, :] is not ascending (as uint32); off[b, k] =
// the first j with (uint32)idx[b, j] >= x_k (the list's lower bound of
// x_k), written exactly once per k when the list is ascending.
__global__ void gather_prep_kernel(const int32_t* __restrict__ idx,
                                   int32_t* __restrict__ flag,
                                   int32_t* __restrict__ off, int n, int m,
                                   int rows, int ranges) {
  const int b = blockIdx.y;
  const long long j = (long long)blockIdx.x * PREP_THREADS + threadIdx.x;
  if (j >= m) return;
  const int32_t* row = idx + (long long)b * m;
  int32_t* o = off + (long long)b * (ranges + 1);
  const uint32_t v = (uint32_t)__ldg(row + j);
  long long k0 = 0;
  if (j > 0) {
    const uint32_t p = (uint32_t)__ldg(row + j - 1);
    if (p > v) flag[b] = 1;
    k0 = last_boundary(p, n, rows, ranges) + 1;
  }
  const long long k1 = last_boundary(v, n, rows, ranges);
  for (long long k = k0; k <= k1; ++k) o[k] = (int32_t)j;
  if (j == m - 1)
    for (long long k = k1 + 1; k <= ranges; ++k) o[k] = m;
}

// XOR the TY warps' partial folds of one query's word pass together and
// into out (the caller syncs around it).
template <int VEC>
__device__ __forceinline__ void emit_pass(uint32_t (&sred)[TY][TX * VEC],
                                          const uint32_t (&acc)[VEC],
                                          uint32_t* __restrict__ out_row,
                                          int wbase, int tile_hi) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  __syncthreads();
#pragma unroll
  for (int v = 0; v < VEC; ++v) sred[ty][tx * VEC + v] = acc[v];
  __syncthreads();
  for (int c = ty * TX + tx; c < TX * VEC; c += TX * TY) {
    uint32_t r = 0u;
#pragma unroll
    for (int y = 0; y < TY; ++y) r ^= sred[y][c];
    const int wc = wbase + c;
    if (r != 0u && wc < tile_hi) atomicXor(out_row + wc, r);
  }
}

template <int VEC>
__device__ __forceinline__ void load_words(const uint32_t* p,
                                           uint32_t (&val)[VEC]) {
  if constexpr (VEC == 4) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    val[0] = t.x; val[1] = t.y; val[2] = t.z; val[3] = t.w;
  } else {
    val[0] = __ldg(p);
  }
}

// exclusive prefix sum of v over the block; *total gets the block's sum
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[TY];
  const int lane = threadIdx.x, warp = threadIdx.y;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int y = 0; y < TY; ++y) {
    const int s = warp_sums[y];
    before += y < warp ? s : 0;
    sum += s;
  }
  *total = sum;
  return before + x - v;
}

// cp.async: a 16-byte (VEC 4) or 4-byte copy into shared memory that
// lands while the thread goes on; wait_group<N> leaves N groups in flight
template <int VEC>
__device__ __forceinline__ void copy_words(uint32_t* dst, const uint32_t* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// barrier of the nw warps of team tm (named barriers 1..; 0 is
// __syncthreads')
__device__ __forceinline__ void team_sync(int tm, int nw) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(tm + 1), "r"(nw * 32));
}

template <int NG, int VEC>
__global__ void __launch_bounds__(TX * TY)
gather_xor_kernel(const uint32_t* __restrict__ db,
                  const int32_t* __restrict__ idx,
                  const int32_t* __restrict__ flag,
                  const int32_t* __restrict__ off,
                  uint32_t* __restrict__ out, int n, int w, int q, int m,
                  int block_w, int rows, int ranges, int walk_per,
                  int ranges_on_x) {
  // dynamic: each team's ring of STAGES x NG x UNROLL row tiles;
  // [rows] uint32, the query set of each row; [rows] uint16, the range's
  // live rows (offsets from r0) in order
  extern __shared__ __align__(16) uint32_t ring[];
  uint32_t* sel = ring + TY * STAGES * UNROLL * TX * VEC;
  __shared__ uint32_t sred[TY][TX * VEC];
  constexpr int QG = 8 * NG;  // queries of the block's group

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int slot = ranges_on_x ? blockIdx.x : blockIdx.y;
  const int jt = ranges_on_x ? blockIdx.y : blockIdx.x;
  const int q0 = blockIdx.z * QG;
  const int qn = min(QG, q - q0);
  const int tile_lo = jt * block_w;
  const int tile_hi = min(w, tile_lo + block_w);

  if (slot >= ranges) {
    // ---- walk: a chunk of every flagged list of the group
    const long long j_begin = (long long)(slot - ranges) * walk_per;
    const int j_end = (int)min((long long)m, j_begin + walk_per);
    for (int a = 0; a < qn; ++a) {
      const int b = q0 + a;
      if (ranges > 0 && __ldg(flag + b) == 0) continue;  // block-uniform
      const int32_t* my_idx = idx + (long long)b * m;
      for (int wbase = tile_lo; wbase < tile_hi; wbase += TX * VEC) {
        const int w0 = wbase + tx * VEC;
        const bool w_ok = w0 < tile_hi;  // VEC==4: tile bounds 4-aligned
        uint32_t acc[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = 0u;
        if (w_ok) {
#pragma unroll 4
          for (int j = (int)j_begin + ty; j < j_end; j += TY) {
            const int32_t row = __ldg(my_idx + j);
            if (row >= 0 && row < n) {
              uint32_t val[VEC];
              load_words<VEC>(db + (long long)row * w + w0, val);
#pragma unroll
              for (int v = 0; v < VEC; ++v) acc[v] ^= val[v];
            }
          }
        }
        emit_pass<VEC>(sred, acc, out + (long long)b * w, wbase, tile_hi);
      }
    }
    return;
  }

  // ---- range: rows [r0, r0 + rn), each read once for the whole group
  const int r0 = slot * rows;
  const int rn = min(rows, n - r0);
  uint16_t* live = reinterpret_cast<uint16_t*>(sel + rows);
  for (int i = tid; i < rn; i += TX * TY) sel[i] = 0u;
  __syncthreads();
  for (int a = 0; a < qn; ++a) {
    const int b = q0 + a;
    if (__ldg(flag + b) != 0) continue;
    const int32_t* o = off + (long long)b * (ranges + 1);
    const int j1 = __ldg(o + slot + 1);
    const int32_t* my_idx = idx + (long long)b * m;
    for (int j = __ldg(o + slot) + tid; j < j1; j += TX * TY) {
      const uint32_t r = (uint32_t)__ldg(my_idx + j) - (uint32_t)r0;
      if (r < (uint32_t)rn) atomicXor(sel + r, 1u << a);
    }
  }
  __syncthreads();
  // the rows some query folds, in order: live[0, count)
  const int per = (rn + TX * TY - 1) / (TX * TY);
  const int lo = min(rn, tid * per), hi = min(rn, lo + per);
  int mine = 0;
  for (int r = lo; r < hi; ++r) mine += sel[r] != 0u;
  int count;
  int at = block_exclusive_scan(mine, &count);
  for (int r = lo; r < hi; ++r)
    if (sel[r] != 0u) live[at++] = (uint16_t)r;
  __syncthreads();

  // Teams of NG warps walk the list, team tm taking stages tm, tm + T, ...
  // of NG * UNROLL rows. Member k copies UNROLL rows of a stage into its
  // ring (each lane its own words) and folds all the stage's rows for
  // query set k; a team of one warp needs no barrier, since each lane
  // reads back only what it copied.
  constexpr int T = TY / NG;
  constexpr int SROWS = NG * UNROLL;
  const int tm = ty / NG, k = ty % NG;
  const int team_stages = (count + SROWS - 1) / SROWS;
  const int my_stages = team_stages > tm ? (team_stages - tm + T - 1) / T : 0;
  // the team's ring: STAGES stages of its SROWS rows, row i of a stage
  // copied by member i / UNROLL
  uint32_t (*team_ring)[SROWS][TX * VEC] =
      reinterpret_cast<uint32_t (*)[SROWS][TX * VEC]>(ring) + tm * STAGES;
  for (int wbase = tile_lo; wbase < tile_hi; wbase += TX * VEC) {
    const int w0 = wbase + tx * VEC;
    const bool w_ok = w0 < tile_hi;
    uint32_t acc[8][VEC];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[a][v] = 0u;

    auto issue = [&](int st) {
      if (st < my_stages) {
        const int base = ((st * T + tm) * NG + k) * UNROLL;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (base + u < count && w_ok)
            copy_words<VEC>(
                &team_ring[st % STAGES][k * UNROLL + u][tx * VEC],
                db + (long long)(r0 + live[base + u]) * w + w0);
      }
      copy_commit();
    };
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) issue(st);
    for (int st = 0; st < my_stages; ++st) {
      copy_wait<STAGES - 2>();  // stage st has landed (this thread's part)
      if constexpr (NG > 1) team_sync(tm, NG);
      issue(st + STAGES - 1);  // into the slot stage st - 1 used
      // lane i < SROWS holds the stage's row i's set of this warp's 8
      // queries; a ballot per query turns it into the stage rows that
      // query folds, so the work is one 16-byte read and XOR per member
#if PIR_GATHER_FOLD
      const int base = (st * T + tm) * SROWS;
      uint32_t mine = 0u;
      if (tx < SROWS && base + tx < count)
        mine = (sel[live[base + tx]] >> (8 * k)) & 0xFFu;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        uint32_t rows_a = __ballot_sync(0xffffffffu, (mine >> a) & 1u);
        while (rows_a != 0u) {  // warp-uniform
          const int i = __ffs(rows_a) - 1;
          rows_a &= rows_a - 1u;
          const uint32_t* src = &team_ring[st % STAGES][i][tx * VEC];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[a][v] ^= src[v];
        }
      }
#endif
    }
    copy_wait<0>();
    // the teams' folds of each query meet in sred, query by query
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      __syncthreads();
#pragma unroll
      for (int v = 0; v < VEC; ++v) sred[ty][tx * VEC + v] = acc[a][v];
      __syncthreads();
      for (int c = tid; c < NG * TX * VEC; c += TX * TY) {
        const int kk = c / (TX * VEC), cc = c % (TX * VEC);
        const int qa = kk * 8 + a;
        uint32_t r = 0u;
#pragma unroll
        for (int y = 0; y < T; ++y) r ^= sred[y * NG + kk][cc];
        if (r != 0u && qa < qn && wbase + cc < tile_hi)
          atomicXor(out + (long long)(q0 + qa) * w + wbase + cc, r);
      }
    }
    __syncthreads();  // before the next pass reuses the ring
  }
}

template <int NG, int VEC>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t s,
                   const uint32_t* db, const int32_t* idx,
                   const int32_t* flag, const int32_t* off, uint32_t* out,
                   int n, int w, int q, int m, int block_w, int rows,
                   int ranges, int walk_per, int ranges_on_x) {
  auto* k = gather_xor_kernel<NG, VEC>;
  if (smem > 16 * 1024) {  // beside the static ring: opt in above 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  k<<<grid, dim3(TX, TY), smem, s>>>(db, idx, flag, off, out, n, w, q, m,
                                     block_w, rows, ranges, walk_per,
                                     ranges_on_x);
  return cudaGetLastError();
}

}  // namespace

// out [q, w] and scratch [q + q * (ranges + 1)] int32 (the flags, then the
// range offsets) must be zeroed by the caller. The schedule (rows per
// range, ranges = ceil(n / rows), walk chunks of walk_per ids) comes from
// the wrapper; ranges_on_x = 1 is grid_order "qwm", 0 is "wqm".
PIR_EXPORT int pir_gather_xor(const void* db, const void* idx, void* out,
                              void* scratch, int n, int w, int q, int m,
                              int block_w, int rows, int ranges,
                              int walk_chunks, int walk_per, int ranges_on_x,
                              void* stream) {
  if (n <= 0 || w <= 0 || q <= 0 || m <= 0 || block_w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* flag = static_cast<int32_t*>(scratch);
  int32_t* off = flag + q;
  cudaError_t e = cudaSuccess;
  if (ranges > 0) {  // else every list is walked
    gather_prep_kernel<<<dim3(pir_ceil_div(m, PREP_THREADS), q),
                         PREP_THREADS, 0, s>>>((const int32_t*)idx, flag, off,
                                               n, m, rows, ranges);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }

  const bool vec4 = (w % 4 == 0) && (block_w % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(db) % 16 == 0);
  const int w_tiles = pir_ceil_div(w, block_w);
  const int slots = ranges + walk_chunks;
  // a block takes 8, 16 or 32 queries (NG groups of 8)
  const int ng = q <= 8 ? 1 : (q <= 16 ? 2 : 4);
  const int groups = pir_ceil_div(q, 8 * ng);
  dim3 grid(ranges_on_x ? slots : w_tiles, ranges_on_x ? w_tiles : slots,
            groups);
  const size_t smem =
      ranges == 0 ? 0
                  : (size_t)TY * STAGES * UNROLL * TX * (vec4 ? 4 : 1) *
                            sizeof(uint32_t) +
                        (size_t)rows * (sizeof(uint32_t) + sizeof(uint16_t));
  const uint32_t* d = (const uint32_t*)db;
  const int32_t* ix = (const int32_t*)idx;
  uint32_t* o = (uint32_t*)out;
#define PIR_GATHER_LAUNCH(NG_, VEC_)                                         \
  launch<NG_, VEC_>(grid, smem, s, d, ix, flag, off, o, n, w, q, m, block_w, \
                    rows, ranges, walk_per, ranges_on_x)
  if (ng == 1)
    e = vec4 ? PIR_GATHER_LAUNCH(1, 4) : PIR_GATHER_LAUNCH(1, 1);
  else if (ng == 2)
    e = vec4 ? PIR_GATHER_LAUNCH(2, 4) : PIR_GATHER_LAUNCH(2, 1);
  else
    e = vec4 ? PIR_GATHER_LAUNCH(4, 4) : PIR_GATHER_LAUNCH(4, 1);
#undef PIR_GATHER_LAUNCH
  return (int)e;
}
