// scatter_rows: out = db; out[rows[i]] = vals[i] in index order, so the
// last write wins for a row named more than once. Functional: out is a
// fresh buffer, db is only read.
//
// Replaces the TPU kernel of the reference package's kernels/scatter.py
// (`_kernel`: a grid over row blocks of the store, every block folding
// all m updates over its old block with masked selects in index order).
//
// Bound: bytes, and whatever m is, because the contract is functional:
// every row of out is written once and read once, from db (untouched rows)
// or from vals (written rows), so the least time is 2*n * row_bytes + m * 4
// bytes (the row ids) over the memory rate.
//
// Design: two passes instead of the TPU's m-step walk per block. (1) A
// winner table: winner[r] = the largest i with rows[i] == r, by atomicMax
// into an int32 [n] scratch set to -1, so duplicate rows resolve to the
// last write with no sort and no race. (2) One streaming pass in which a
// warp copies a whole row, from vals[winner[r]] or from db[r], in 16-byte
// pieces where the row width and the pointers allow it (else 4 or 1).
// The copy moves bytes only, so the kernel takes rows of any element
// size (int32 packed words on the ingest path, uint8 or float32 bitplanes).
// Row ids outside [0, n) write nothing, as in the reference.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

__global__ void scatter_winner_kernel(const int32_t* __restrict__ rows,
                                      int32_t* __restrict__ winner, int n,
                                      int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m) {
    const int32_t r = __ldg(rows + i);
    if (r >= 0 && r < n) atomicMax(winner + r, i);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
scatter_copy_kernel(const T* __restrict__ db, const T* __restrict__ vals,
                    const int32_t* __restrict__ winner, T* __restrict__ out,
                    int n, int rv) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (THREADS / 32);
  for (long long r = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
       r < n; r += warps) {
    const int win = __ldg(winner + r);
    const T* src = win >= 0 ? vals + (long long)win * rv : db + r * rv;
    T* dst = out + r * rv;
    for (int c0 = 0; c0 < rv; c0 += 32 * UNROLL) {
      T v[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int c = c0 + k * 32 + lane;
        if (c < rv) v[k] = __ldg(src + c);
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int c = c0 + k * 32 + lane;
        if (c < rv) dst[c] = v[k];
      }
    }
  }
}

template <typename T>
void launch_copy(const void* db, const void* vals, const int32_t* winner,
                 void* out, int n, int row_bytes, cudaStream_t s) {
  const long long want = ((long long)n + THREADS / 32 - 1) / (THREADS / 32);
  const int blocks = (int)(want < 65536 ? want : 65536);
  scatter_copy_kernel<T><<<blocks, THREADS, 0, s>>>(
      (const T*)db, (const T*)vals, winner, (T*)out, n,
      row_bytes / (int)sizeof(T));
}

}  // namespace

// db, out: [n, row_bytes] bytes; vals: [m, row_bytes]; rows: [m] int32;
// winner: [n] int32 scratch (overwritten). m may be 0 (a plain copy).
PIR_EXPORT int pir_scatter_rows(const void* db, const void* rows,
                                const void* vals, void* out, void* winner,
                                int n, int m, int row_bytes, void* stream) {
  if (n <= 0 || row_bytes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(winner, 0xff, (size_t)n * sizeof(int32_t),
                                    s);  // every entry -1
  if (err != cudaSuccess) return (int)err;
  if (m > 0) {
    scatter_winner_kernel<<<pir_ceil_div(m, THREADS), THREADS, 0, s>>>(
        (const int32_t*)rows, (int32_t*)winner, n, m);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const uintptr_t addr = reinterpret_cast<uintptr_t>(db) |
                         reinterpret_cast<uintptr_t>(vals) |
                         reinterpret_cast<uintptr_t>(out);
  const int32_t* win = (const int32_t*)winner;
  if (row_bytes % 16 == 0 && addr % 16 == 0)
    launch_copy<uint4>(db, vals, win, out, n, row_bytes, s);
  else if (row_bytes % 4 == 0 && addr % 4 == 0)
    launch_copy<uint32_t>(db, vals, win, out, n, row_bytes, s);
  else
    launch_copy<uint8_t>(db, vals, win, out, n, row_bytes, s);
  return (int)cudaGetLastError();
}
