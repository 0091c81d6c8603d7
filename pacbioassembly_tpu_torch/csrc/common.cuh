// Shared constants and the block-wide banded row step of the port's CUDA
// kernels (plain C interface, no torch headers).
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

// One pair's band as a block sees it: cell (i, j) sits at lane k = j - i + W
// of a row of S lanes, and only lanes with |k - W| <= md are in the band.
struct Band {
  int W, S, md;
  int lenb;             // DP len_b (columns past it are invalid)
  int lbq;              // raw len_b: b codes past it read as the -1 sentinel
  int LB;               // width of the b row
  const uint8_t* brow;  // the pair's b codes
};

__device__ __forceinline__ bool band_valid(const Band& g, int k, int i) {
  const int j = k + i - g.W;
  return j >= 1 && j <= g.lenb && abs(k - g.W) <= g.md;
}

// the row-0 border cell (i, 0) = i, while i <= md
__device__ __forceinline__ bool band_border(const Band& g, int k, int i) {
  return k + i - g.W == 0 && i <= g.md;
}

// DIAG source of cell (i, k): prev[k] + (b[j-1] != a[i-1]), b past raw len_b = -1
__device__ __forceinline__ int band_diag(const Band& g, const int* prev, int k, int i, int ai) {
  const int src = k + i - g.W - 1;
  const int bj = (src >= 0 && src < g.lbq) ? (int)g.brow[min(src, g.LB - 1)] : -1;
  return prev[k] + (bj != ai ? 1 : 0);
}

// Row i of the banded DP across the block, for rows the pair is active in:
// D = min(diag, up) with the border cell, then the in-row INSERT chain by the
// TPU kernels' min-plus doubling prefix (rr[k] = min(rr[k], rr[k-sh] + sh),
// lanes k < sh reading INF), ping-ponging between buf0 and buf1. The doubling
// keeps even unreachable cells' values (>= INF) equal to the reference's.
// Returns the buffer that holds the scanned row; the other one is free.
// Ends on a barrier: every thread may read the result.
__device__ __forceinline__ int* band_row(const Band& g, const int* prev, int* buf0, int* buf1,
                                         int i, int ai) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int S = g.S;
  for (int k = tid; k < S; k += nt) {
    const bool validj = band_valid(g, k, i);
    const int diag = validj ? band_diag(g, prev, k, i, ai) : INF;
    const int up_src = (k == S - 1) ? INF : prev[k + 1];
    const int up = validj ? up_src + 1 : INF;
    buf0[k] = band_border(g, k, i) ? i : min(diag, up);
  }
  __syncthreads();
  int* src = buf0;
  int* dst = buf1;
  for (int sh = 1; sh < S; sh <<= 1) {
    for (int k = tid; k < S; k += nt) {
      const int shifted = (k < sh) ? INF : src[k - sh];
      dst[k] = min(src[k], shifted + sh);
    }
    __syncthreads();
    int* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

}  // namespace pbt
