// K2: banded-DP parent plane for traceback, one block per pair.
//
// Replaces the Pallas TPU kernel pacbioassembly_tpu/align/tbwave.py::_kernel
// (launched by batch_parents_pallas). Same recurrence and the same packed
// output, bit for bit: out[q, rb, k] holds, in bits [2r, 2r+1], the parent
// of DP cell (row rb*16 + r + 1, band lane k) of pair q, with MATCH > INSERT
// > DELETE on ties (align/banded.py) and 0 outside the band.
//
// Design on Hopper: the TPU kernel walks row blocks as a sequential grid
// axis and carries the row state in VMEM scratch; here the row loop runs
// inside the block and the row state lives in shared memory. Threads span
// the S band lanes (S = round_up(2W+1, 128), several lanes per thread). The
// in-row INSERT chain is the same min-plus doubling scan as the TPU kernel
// (rr[k] = min(rr[k], rr[k-sh] + sh), lanes k < sh reading INF), run
// block-wide over shared memory with ping-pong buffers, so even the values
// of unreachable cells (>= INF) match the reference and the plane compares
// bit for bit. Shared memory: 4 int32 rows of S (prev, two scan buffers, the
// 16-row parent words) = 16*S bytes, 192 KB at the widest band (S = 12,032).
// What bounds it: one barrier per scan step, about log2(S) + 3 barriers per
// DP row; the 32 pairs of a commit launch occupy 32 SMs. A warp-shuffle scan
// and several pairs per block are later work.

#include "common.cuh"

namespace pbt {
namespace {

__global__ void tbwave_kernel(
    const uint8_t* __restrict__ a, int LA,
    const uint8_t* __restrict__ b, int LB,
    const int* __restrict__ lb_raw, const int* __restrict__ md_in,
    const int* __restrict__ lena_in, const int* __restrict__ lenb_in,
    int W, int S, int NRB, int* __restrict__ out) {
  extern __shared__ int smem[];
  int* prev = smem;
  int* buf0 = smem + S;
  int* buf1 = smem + 2 * S;
  int* pw = smem + 3 * S;

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int md = md_in[q];
  const int lena = lena_in[q];
  const int lenb = lenb_in[q];
  const int lbq = lb_raw[q];
  const uint8_t* arow = a + (size_t)q * LA;
  const uint8_t* brow = b + (size_t)q * LB;
  int* outq = out + (size_t)q * NRB * S;

  // row 0 borders: cost(0, j) = j for 0 <= j <= min(len_b, md)
  const int row0_hi = min(lenb, md);
  for (int k = tid; k < S; k += nt) {
    const int j0 = k - W;
    prev[k] = (j0 >= 0 && j0 <= row0_hi) ? j0 : INF;
    pw[k] = 0;
  }
  __syncthreads();

  // rows past len_a are inactive: parents 0 and the row state unchanged,
  // so the loop stops at len_a (the caller zero-fills the plane)
  const int nrows = min(lena, NRB * 16);
  for (int i = 1; i <= nrows; ++i) {
    const int r = (i - 1) & 15;
    const int ai = (i - 1 < LA) ? (int)arow[i - 1] : 0;

    // D = min(diag, up) with the border cell (i, 0) = i
    for (int k = tid; k < S; k += nt) {
      const int j = k + i - W;
      const bool validj = j >= 1 && j <= lenb && abs(k - W) <= md;
      const int src = j - 1;
      const int bj = (src >= 0 && src < lbq) ? (int)brow[min(src, LB - 1)] : -1;
      const int diag = validj ? prev[k] + (bj != ai ? 1 : 0) : INF;
      const int up_src = (k == S - 1) ? INF : prev[k + 1];
      const int up = validj ? up_src + 1 : INF;
      int D = min(diag, up);
      if (j == 0 && i <= md) D = i;
      buf0[k] = D;
    }
    __syncthreads();

    // in-row INSERT chain: min-plus doubling prefix
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

    // cur = scanned value on live cells, INF elsewhere (into the free buffer)
    for (int k = tid; k < S; k += nt) {
      const int j = k + i - W;
      const bool validj = j >= 1 && j <= lenb && abs(k - W) <= md;
      const bool border = j == 0 && i <= md;
      dst[k] = (validj || border) ? src[k] : INF;
    }
    __syncthreads();

    // parents, MATCH > INSERT > DELETE; then the row becomes prev
    for (int k = tid; k < S; k += nt) {
      const int j = k + i - W;
      const bool validj = j >= 1 && j <= lenb && abs(k - W) <= md;
      const bool border = j == 0 && i <= md;
      const int srcb = j - 1;
      const int bj = (srcb >= 0 && srcb < lbq) ? (int)brow[min(srcb, LB - 1)] : -1;
      const int diag = validj ? prev[k] + (bj != ai ? 1 : 0) : INF;
      const int cur = dst[k];
      const int left_plus1 = (k == 0 ? INF : dst[k - 1]) + 1;
      int par = DELETE;
      if (cur == left_plus1) par = INSERT;
      if (cur == diag) par = MATCH;
      if (border) par = DELETE;
      if (!(validj || border)) par = 0;
      int word = pw[k] | (par << (2 * r));
      prev[k] = cur;
      if (r == 15 || i == nrows) {
        outq[(size_t)((i - 1) >> 4) * S + k] = word;
        word = 0;
      }
      pw[k] = word;
    }
    __syncthreads();
  }
}

}  // namespace
}  // namespace pbt

extern "C" int pb_tbwave(const void* a, int LA, const void* b, int LB, const void* lb,
                         const void* md, const void* len_a, const void* len_b, int B,
                         int w_max, int S, int NRB, void* out, void* stream) {
  using namespace pbt;
  if (B <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)4 * S * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      tbwave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = S < 512 ? S : 512;
  tbwave_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), LA, static_cast<const uint8_t*>(b), LB,
      static_cast<const int*>(lb), static_cast<const int*>(md),
      static_cast<const int*>(len_a), static_cast<const int*>(len_b), w_max, S, NRB,
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}
