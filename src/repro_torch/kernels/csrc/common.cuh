// Shared helpers for the GF(2) answer kernels (sm_90a, plain C interface).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define PIR_EXPORT extern "C" __attribute__((visibility("default")))

static inline int pir_ceil_div(long long a, long long b) {
  return (int)((a + b - 1) / b);
}
