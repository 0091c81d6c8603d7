// Shared constants for the port's CUDA kernels (plain C interface, no torch headers).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pbt {

// cost sentinel, identical to the JAX package's INF (align/scan.py, align/tbwave.py);
// every sum the kernels form on it stays inside int32
constexpr int INF = 1 << 28;

// edit opcodes (align/types.py)
constexpr int MATCH = 1;
constexpr int INSERT = 2;
constexpr int DELETE = 3;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

}  // namespace pbt
