// Shared helpers for the GF(2) answer kernels (sm_90a, plain C interface).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define PIR_EXPORT extern "C" __attribute__((visibility("default")))

static inline int pir_ceil_div(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

// XOR-reduce a value over the lanes of a warp that share (lane % width).
__device__ __forceinline__ uint32_t pir_warp_xor_rows(uint32_t v, int width) {
  for (int off = 16; off >= width; off >>= 1)
    v ^= __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
