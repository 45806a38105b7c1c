// indices_from_mask: [q, n] request mask -> [q, m] int32 ids of its nonzero
// columns, ascending, the lowest m of a heavier row, the rest -1.
//
// No TPU kernel: the reference package computes it with a stable argsort
// (kernels/gather_xor.py::indices_from_mask) in front of its gather. Here
// it is the first half of every sparse answer, so it is a kernel too.
//
// Bound: bytes. The mask is read, the ids written; the least time is
// q*n + q*m*4 bytes over the memory rate.
//
// Design: a stream compaction per row, tiled along n so that a batch of 8
// rows still fills the card (TILE = 8192 columns a block, 32 a thread):
//  1. count: each thread turns its 32 mask bytes into a 32-bit set of
//     nonzero columns (16-byte loads where the row lies on 16 bytes, byte
//     loads elsewhere) and the block sums the popcounts per tile;
//  2. scan: one block per row turns the tile counts into exclusive
//     offsets and the row's weight;
//  3. write: each block rebuilds its sets, scans them across the block,
//     puts every id at its rank in shared memory, and copies the tile's
//     ranks to the row with coalesced stores, dropping ranks >= m (so a
//     heavier row keeps its lowest m ids); then it fills its share of the
//     row's tail [weight, m) with -1.
// The kernel reads bytes as they are: uint8 (any nonzero value selects)
// and bool both lie one byte a column.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER = 32;                 // columns per thread
constexpr int TILE = THREADS * PER;     // columns per block
constexpr int SCAN_THREADS = 1024;

// the nonzero bytes of a word as 4 bits (bit i = byte i)
__device__ __forceinline__ uint32_t nonzero_nibble(uint32_t x) {
  const uint32_t t = __vsetne4(x, 0u);  // 0x01 in each nonzero byte
  return (t | (t >> 7) | (t >> 14) | (t >> 21)) & 0xFu;
}

// bit i of the result = (row[col0 + i] != 0), for the columns < n
__device__ __forceinline__ uint32_t column_set(const uint8_t* __restrict__ row,
                                               long long col0, int n,
                                               bool aligned) {
  uint32_t bits = 0u;
  if (aligned && col0 + PER <= n) {
    const uint4* p = reinterpret_cast<const uint4*>(row + col0);
    const uint4 a = __ldg(p), b = __ldg(p + 1);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) bits |= nonzero_nibble(w[k]) << (4 * k);
  } else {
    for (int i = 0; i < PER; ++i) {
      const long long c = col0 + i;
      if (c < n && __ldg(row + c) != 0) bits |= 1u << i;
    }
  }
  return bits;
}

// exclusive prefix sum of v over the block; *total gets the block's sum
template <int NT>
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < NT / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < NT / 32) warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[NT / 32 - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}

__global__ void __launch_bounds__(THREADS)
ifm_count_kernel(const uint8_t* __restrict__ mask, int32_t* __restrict__ cnt,
                 int n, int tiles) {
  const int b = blockIdx.y, t = blockIdx.x;
  const uint8_t* row = mask + (long long)b * n;
  const bool aligned = (reinterpret_cast<uintptr_t>(row) % 16) == 0;
  const uint32_t bits = column_set(
      row, (long long)t * TILE + threadIdx.x * PER, n, aligned);
  int total;
  block_exclusive_scan<THREADS>(__popc(bits), &total);
  if (threadIdx.x == 0) cnt[(long long)b * (tiles + 1) + t] = total;
}

// cnt[b, :tiles] -> exclusive offsets; cnt[b, tiles] = the row's weight
__global__ void __launch_bounds__(SCAN_THREADS)
ifm_scan_kernel(int32_t* __restrict__ cnt, int tiles) {
  int32_t* c = cnt + (long long)blockIdx.x * (tiles + 1);
  int carry = 0;
  for (int base = 0; base < tiles; base += SCAN_THREADS) {
    const int i = base + threadIdx.x;
    const int v = i < tiles ? c[i] : 0;
    int total;
    const int ex = block_exclusive_scan<SCAN_THREADS>(v, &total);
    if (i < tiles) c[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) c[tiles] = carry;
}

__global__ void __launch_bounds__(THREADS)
ifm_write_kernel(const uint8_t* __restrict__ mask,
                 const int32_t* __restrict__ cnt, int32_t* __restrict__ out,
                 int n, int m, int tiles) {
  __shared__ int32_t ids[TILE];  // the tile's ids, in rank order
  const int b = blockIdx.y, t = blockIdx.x;
  const uint8_t* row = mask + (long long)b * n;
  const bool aligned = (reinterpret_cast<uintptr_t>(row) % 16) == 0;
  const long long col0 = (long long)t * TILE + threadIdx.x * PER;
  uint32_t bits = column_set(row, col0, n, aligned);
  const int32_t* c = cnt + (long long)b * (tiles + 1);
  const int tile_base = __ldg(c + t);
  const int weight = __ldg(c + tiles);
  int total;
  int local = block_exclusive_scan<THREADS>(__popc(bits), &total);
  while (bits != 0u) {
    const int i = __ffs(bits) - 1;
    bits &= bits - 1u;
    ids[local++] = (int32_t)(col0 + i);
  }
  __syncthreads();
  // ranks [tile_base, tile_base + total) of the row, cut at m: coalesced
  int32_t* o = out + (long long)b * m;
  const int keep = min(total, m - tile_base);
  for (int i = threadIdx.x; i < keep; i += THREADS) o[tile_base + i] = ids[i];
  // this block's share of the tail [weight, m)
  const long long share = ((long long)m + tiles - 1) / tiles;
  const long long lo = max((long long)weight, (long long)t * share);
  const long long hi = min((long long)m, (long long)(t + 1) * share);
  for (long long p = lo + threadIdx.x; p < hi; p += THREADS) o[p] = -1;
}

}  // namespace

// mask [q, n] bytes (uint8 or bool), out [q, m] int32, scratch [q, tiles+1]
// int32 with tiles = ceil(n / 8192) (needs no zeroing).
PIR_EXPORT int pir_indices_from_mask(const void* mask, void* out,
                                     void* scratch, int q, int n, int m,
                                     void* stream) {
  if (q <= 0 || n <= 0 || m <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = pir_ceil_div(n, TILE);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  int32_t* cnt = static_cast<int32_t*>(scratch);
  const dim3 grid(tiles, q);
  ifm_count_kernel<<<grid, THREADS, 0, s>>>(mk, cnt, n, tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ifm_scan_kernel<<<q, SCAN_THREADS, 0, s>>>(cnt, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ifm_write_kernel<<<grid, THREADS, 0, s>>>(mk, cnt, static_cast<int32_t*>(out),
                                            n, m, tiles);
  return (int)cudaGetLastError();
}
