// Shared constants and the warp-level prefix minimum of the port's banded
// row kernels, K2 (tbwave.cu) and K3 (wavefront.cu) (plain C interface, no
// torch headers).
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

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;
constexpr int kScanId = 1 << 30;  // identity of the prefix minimum, above every u = D - k

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Inclusive prefix minimum of x over the warp's lanes: five shuffle steps.
__device__ __forceinline__ int warp_scan_min(int x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x = min(x, y);
  }
  return x;
}

// The exclusive prefix of an inclusive warp scan: the previous lane's value,
// the identity at lane 0.
__device__ __forceinline__ int warp_exclusive(int incl, int lane) {
  const int excl = __shfl_up_sync(kFull, incl, 1);
  return lane == 0 ? kScanId : excl;
}

// Minimum of the earlier warps' totals tot[0 .. warp - 1], one a lane,
// reduced by a butterfly; every lane gets it.
__device__ __forceinline__ int earlier_warps_min(const int* tot, int warp, int lane) {
  int before = lane < warp ? tot[lane] : kScanId;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    before = min(before, __shfl_xor_sync(kFull, before, off));
  }
  return before;
}

}  // namespace pbt
