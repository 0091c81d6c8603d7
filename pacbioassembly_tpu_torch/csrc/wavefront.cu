// K3: row-DP banded screening, one block per pair.
//
// Replaces the Pallas TPU kernel pacbioassembly_tpu/align/wavefront.py::_kernel
// (launched by batch_score_pallas) together with its XLA prologue (per-pair
// geometry, the size check, b with the -1 sentinel past its length) and its
// accept_min epilogue. One launch computes the whole BatchScores contract of
// align/scan.py::batch_score, which is the row DP this kernel runs.
//
// Design on Hopper: the TPU kernel scores 8 pairs per program, one per
// sublane, with the band of the launch's w_max across lanes, and exits when
// all 8 are done. Here one block owns one pair and loops over its rows; the
// row state lives in shared memory. The block works on its pair's own band
// (2*md+1 lanes centered on lane md, md <= w_max) rather than the launch's:
// a launch is sized by its longest candidate, and a short pair in it does
// only its own rows and lanes. Lanes outside a pair's band are INF in both
// layouts and only ever add INF-sized terms, so every finite cell, and so
// every decision, is the same. Each row is common.cuh's band_row (the D step
// and K2's min-plus doubling scan), then the masked row becomes prev. Every
// thread reads the diagonal cell (early failure) and the far-column cell
// (running first argmin) from shared memory, so the row loop's exit is
// uniform: the block stops at its own pair's end (early failure, size
// reject, or len_a). After the last row, a block-wide first-minimum over
// the final row's lanes [md, md + len_b - len_a] gives the short-side goal.
//
// What bounds it: barriers, not bytes or integer operations. A row costs
// about log2(2*md+1) + 2 block barriers for a few integer operations per
// lane, and one pair has one block (up to 512 threads), so a launch of few
// long pairs fills few SMs. Shared memory: 3 int32 rows of 2*md_cap+1 lanes
// (prev and two scan buffers), 144 KB at the locator's widest band
// (W = 6,001); the launch raises the dynamic shared memory limit. Several
// pairs per block and a warp-shuffle scan are later work.

#include <climits>

#include "common.cuh"

namespace pbt {
namespace {

// lexicographic (value, lane) minimum across a warp: the first minimum
__device__ __forceinline__ void warp_first_min(int& v, int& k) {
  for (int off = 16; off > 0; off >>= 1) {
    const int v2 = __shfl_down_sync(0xffffffffu, v, off);
    const int k2 = __shfl_down_sync(0xffffffffu, k, off);
    if (v2 < v || (v2 == v && k2 < k)) {
      v = v2;
      k = k2;
    }
  }
}

__global__ void wavefront_kernel(
    const uint8_t* __restrict__ a, int LA,
    const uint8_t* __restrict__ b, int LB,
    const int* __restrict__ la_in, const int* __restrict__ lb_in,
    const int* __restrict__ early_thr, const int* __restrict__ accept_min,
    const int* __restrict__ band_tab, int tab_len,
    int la_max, int w_max, int maxn, int maxm, int B, int* __restrict__ out) {
  extern __shared__ int smem[];
  __shared__ int red_v[32], red_k[32];

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  // per-pair geometry (seq_aligner.h:92-107)
  const int la = la_in[q];
  const int lb = lb_in[q];
  const bool cond = lb >= la;
  const int min_len = cond ? la : lb;
  const int md = band_tab[clampi(min_len, 0, tab_len)];
  const int len_a = cond ? la : min(la, lb + md);
  const int len_b = cond ? min(lb, la + md) : lb;
  const bool ok_size = (len_a < maxn + maxm) && (md < maxm) && (md <= w_max) &&
                       (len_a <= la_max);

  int accept = 0, cost = INF, matlen_a = 0, matlen_b = 0, diag_cost = -1, rows = 0;

  // an empty side rejects (align/scan.py); such a pair cannot fail early
  if (ok_size && min(len_a, len_b) >= 1) {
    const int S = 2 * md + 1;
    int* prev = smem;
    int* buf0 = smem + S;
    int* buf1 = smem + 2 * S;
    const uint8_t* arow = a + (size_t)q * LA;
    const Band g{md, S, md, len_b, lb, LB, b + (size_t)q * LB};

    // row 0 borders: cost(0, j) = j for 0 <= j <= min(len_b, md)
    const int row0_hi = min(len_b, md);
    for (int k = tid; k < S; k += nt) {
      const int j0 = k - md;
      prev[k] = (j0 >= 0 && j0 <= row0_hi) ? j0 : INF;
    }
    __syncthreads();

    bool failed = false;
    int fail_i = 0;
    int best = INF, best_i = 0;  // far column D(i, len_b), i >= len_b: first minimum
    for (int i = 1; i <= len_a; ++i) {
      const int* src = band_row(g, prev, buf0, buf1, i, (int)arow[i - 1]);
      for (int k = tid; k < S; k += nt) {
        prev[k] = (band_valid(g, k, i) || band_border(g, k, i)) ? src[k] : INF;
      }
      __syncthreads();
      // early failure (seq_aligner.h:185-187): D(i, i) is lane md
      if (i > 10 && i <= len_b && prev[md] > early_thr[min(i, tab_len)]) {
        failed = true;
        fail_i = i;
        break;
      }
      if (i >= len_b) {
        const int kc = len_b - i + md;
        const int v = (kc >= 0 && kc < S) ? prev[kc] : INF;
        if (v < best) {
          best = v;
          best_i = i;
        }
      }
    }

    // reference-equivalent rows (align/scan.py): abort row, else len_a
    rows = failed ? fail_i : len_a;
    if (!failed) {
      int mb;
      if (len_a > len_b) {
        cost = best;
        matlen_a = best_i;
        mb = len_b;
      } else {
        // final row, lanes [md, md + len_b - len_a]: first minimum (goal_cell,
        // seq_aligner.h:191-213)
        const int hi = md + len_b - len_a;
        int v = INT_MAX, kk = INT_MAX;
        for (int k = md + tid; k <= hi; k += nt) {
          if (prev[k] < v) {
            v = prev[k];
            kk = k;
          }
        }
        warp_first_min(v, kk);
        const int warp = tid >> 5, lane = tid & 31;
        if (lane == 0) {
          red_v[warp] = v;
          red_k[warp] = kk;
        }
        __syncthreads();
        if (warp == 0) {
          v = lane < ((nt + 31) >> 5) ? red_v[lane] : INT_MAX;
          kk = lane < ((nt + 31) >> 5) ? red_k[lane] : INT_MAX;
          warp_first_min(v, kk);
        }
        cost = v;
        matlen_a = len_a;
        mb = len_a + (kk - md);
        diag_cost = prev[md];
      }
      if (tid == 0 && mb >= accept_min[clampi(len_b, 0, tab_len)] && cost < INF) {
        accept = 1;
        matlen_b = mb;
      }
    }
  } else if (ok_size) {
    rows = len_a;
  }

  if (tid == 0) {
    if (!accept) {  // rejected pairs' value fields are canonical
      cost = INF;
      matlen_a = 0;
      matlen_b = 0;
      diag_cost = -1;
    }
    out[0 * B + q] = accept;
    out[1 * B + q] = cost;
    out[2 * B + q] = matlen_a;
    out[3 * B + q] = matlen_b;
    out[4 * B + q] = diag_cost;
    out[5 * B + q] = rows;
  }
}

}  // namespace
}  // namespace pbt

extern "C" int pb_wavefront(const void* a, int LA, const void* b, int LB,
                            const void* la, const void* lb, int B,
                            const void* early_thr, const void* accept_min,
                            const void* band_tab, int tab_len, int la_max, int w_max,
                            int maxn, int maxm, void* out, void* stream) {
  using namespace pbt;
  if (B <= 0) return (int)cudaSuccess;
  // lanes per pair: pairs run only when md <= w_max and md < maxm
  const int md_cap = w_max < maxm - 1 ? w_max : maxm - 1;
  const int S = 2 * md_cap + 1;
  const size_t smem = (size_t)3 * S * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = S < 512 ? ((S + 31) / 32) * 32 : 512;
  wavefront_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), LA, static_cast<const uint8_t*>(b), LB,
      static_cast<const int*>(la), static_cast<const int*>(lb),
      static_cast<const int*>(early_thr), static_cast<const int*>(accept_min),
      static_cast<const int*>(band_tab), tab_len, la_max, w_max, maxn, maxm, B,
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}
