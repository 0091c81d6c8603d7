// K3: row-DP banded screening, a warp per pair for narrow bands and a block
// per pair for wide ones.
//
// Replaces the Pallas TPU kernel pacbioassembly_tpu/align/wavefront.py::_kernel
// (launched by batch_score_pallas) together with its XLA prologue (per-pair
// geometry, the size check) and its accept_min epilogue. One launch computes
// the whole BatchScores contract of align/scan.py::batch_score, the row DP
// this kernel runs, bit for bit.
//
// The TPU kernel scores 8 pairs a program, one a sublane, across the launch's
// band, and exits when all 8 are done. Here a pair's rows run in one warp or
// one block over the pair's own band (2*md+1 lanes, lane k holding column
// j = k + i - md of row i); the group stops at its own pair's end (early
// failure, size reject or len_a). Lanes outside a pair's band are INF in
// both layouts and only ever add INF-sized terms, so every decision is the
// same.
//
// What bounds it on Hopper: each row depends on the last, so a pair is a
// chain of up to len_a row steps, and a full-screen launch has 256 pairs.
// Its time is the row step (instructions and their latency), not bytes or
// the card's operation rate. The design keeps the step short, as K2's
// (tbwave.cu) does:
//   * each thread owns L consecutive band lanes with the row in registers; the UP source crosses a thread edge by one shuffle
//     and a warp edge through a one-int-per-warp shared array; the b codes
//     under a thread's lanes sit four to a register and shift one code a
//     row (one shared load a thread), compared four at a time (__vcmpne4);
//   * the in-row INSERT chain cur[k] = min_{k' <= k} D[k'] + (k - k') is a
//     prefix minimum of u = D - k: serial over a thread's lanes, a 5-step
//     shuffle scan over the warp (common.cuh), and the earlier warps'
//     totals after one barrier. Non-live cells are forced to INF; every
//     live cell is finite (reachable along its diagonal from a border), so
//     any exact prefix gives the live values of the reference's scan;
//   * the two cells a row's decisions read, D(i, i) at lane md (early
//     failure) and the far column D(i, len_b) at lane len_b - i + md, go
//     from their owners into shared slots before the row's second barrier,
//     which already publishes each warp's first lane; every thread reads
//     them after it, so the exit is uniform. A slot is next written after
//     the following row's first barrier, past every read. Two barriers a
//     row in all;
//   * when the launch's band fits one warp of 4 lanes a thread (2*md_cap
//     + 1 <= 128), a warp holds a pair and a block packs kWarpPairs pairs:
//     no block barrier in the row loop (the cells come by shuffle), and
//     each warp exits on its own pair's end. That is the prefilter's shape
//     (117 lanes). Wider bands take a block per pair at 8 lanes a thread,
//     or 16 where 8 do not fit a block: fewer threads a pair spend fewer
//     instructions a cell on the scan. align/wavefront.py chooses the
//     shape; these three are the only builds.
// After the last row the short-side goal is the first minimum over the
// final row's lanes [md, md + len_b - len_a], from registers. Shared memory
// is the pair's b row (per warp on the warp path); the launcher returns
// the attribute call's error where it exceeds the card's limit, and
// cudaErrorInvalidValue where the band does not fit the build's threads.

#include <climits>

#include "common.cuh"

namespace pbt {
namespace {

constexpr int kWarpPairs = 4;      // pairs (warps) a block on the warp path
constexpr int kBlockThreads = 768;  // the block path's most threads (85 registers a thread)

// pr[idx] by an unrolled select (no local-memory array)
template <int L>
__device__ __forceinline__ int pick(const int (&pr)[L], int idx) {
  int v = INF;
#pragma unroll
  for (int l = 0; l < L; ++l) v = l == idx ? pr[l] : v;
  return v;
}

// lexicographic (value, lane) minimum across a warp, into lane 0: the first minimum
__device__ __forceinline__ void warp_first_min(int& v, int& k) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int v2 = __shfl_down_sync(kFull, v, off);
    const int k2 = __shfl_down_sync(kFull, k, off);
    if (v2 < v || (v2 == v && k2 < k)) {
      v = v2;
      k = k2;
    }
  }
}

template <bool WARP>
__device__ __forceinline__ void group_sync() {
  if (WARP) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

template <int L, bool WARP>
__global__ void __launch_bounds__(WARP ? 32 * kWarpPairs : kBlockThreads) wavefront_kernel(
    const uint8_t* __restrict__ a, int LA,
    const uint8_t* __restrict__ b, int LB, int LBs,
    const int* __restrict__ la_in, const int* __restrict__ lb_in,
    const int* __restrict__ early_thr, const int* __restrict__ accept_min,
    const int* __restrict__ band_tab, int tab_len,
    int la_max, int w_max, int maxn, int maxm, int B, int* __restrict__ out) {
  extern __shared__ int4 smem4[];
  __shared__ int tot[kMaxWarps];        // each warp's prefix minimum of u
  __shared__ int first[kMaxWarps + 1];  // the row at each warp's first lane
  __shared__ int slot[2];               // D(i, i) and D(i, len_b) of the row
  __shared__ int red_v[kMaxWarps], red_k[kMaxWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q = WARP ? blockIdx.x * kWarpPairs + warp : blockIdx.x;
  if (WARP && q >= B) return;  // a whole warp: the warp path has no block barrier
  const int t = WARP ? lane : tid;  // the thread's place in its pair's group
  const int nt = WARP ? 32 : (int)blockDim.x;
  uint8_t* bs = reinterpret_cast<uint8_t*>(smem4) + (WARP ? (size_t)warp * LBs : 0);

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

  // an empty side rejects (align/scan.py); such a pair cannot fail early.
  // The branch is uniform over the pair's group.
  if (ok_size && min(len_a, len_b) >= 1) {
    const int hi = 2 * md;  // the band: lanes 0 .. 2md
    const int k0 = t * L;   // this thread's lanes k0 .. k0 + L - 1
    const bool idle = !WARP && warp * 32 * L > hi;  // the whole warp is past the band
    const uint8_t* arow = a + (size_t)q * LA;
    const uint8_t* brow = b + (size_t)q * LB;
    for (int x = t; x < LB; x += nt) bs[x] = brow[x];
    if (!WARP && tid <= kMaxWarps) first[tid] = INF;  // warps past the band read INF

    // row 0: cost(0, j) = j for 0 <= j <= min(len_b, md)
    const int row0_hi = min(len_b, md);
    int pr[L];  // the row; u = D - k within a row step
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int j0 = k0 + l - md;
      pr[l] = (k0 + l <= hi && j0 >= 0 && j0 <= row0_hi) ? j0 : INF;
    }
    group_sync<WARP>();
    if (!WARP && lane == 0 && !idle) first[warp] = pr[0];
    // b codes under this thread's lanes, four to a word: lane l of row i
    // reads b[k0 + l + i - md - 1] (clamped to the row), lane l + 1's code of
    // row i - 1, so each row shifts one code in
    const int bmax = LB - 1;
    unsigned bw[L / 4];
#pragma unroll
    for (int w = 0; w < L / 4; ++w) {
      bw[w] = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        bw[w] |= (unsigned)bs[clampi(k0 + 4 * w + c - md, 0, bmax)] << (8 * c);
      }
    }
    group_sync<WARP>();

    bool failed = false;
    int fail_i = 0;
    int best = INF, best_i = 0;  // far column D(i, len_b), i >= len_b: first minimum
    int d_ii = INF;              // D(i, i) of the last row
    int ai = (int)arow[0];       // a's code and the failure threshold of the row,
    int thr = early_thr[min(1, tab_len)];  // loaded one row ahead
    for (int i = 1; i <= len_a; ++i) {
      // live lanes of this row: j = k + i - md in [1, len_b], plus the
      // border lane k = md - i while i <= md
      const int vlo = max(0, md + 1 - i);
      const int vhi = min(hi, md + len_b - i);
      const int kbord = i <= md ? md - i : -1;
      const int kc = len_b - i + md;         // the far column's lane
      const bool col = i >= len_b && kc >= 0;
      const int ai_next = (int)arow[min(i, LA - 1)];  // a past its row reads its last code, as the scan does
      const int thr_next = early_thr[min(i + 1, tab_len)];
      const unsigned b_next = bs[clampi(k0 + L - 1 + i - md, 0, bmax)];
      int c_far = INF;
      int excl = kScanId;
      unsigned live = ~0u;  // bit l: lane l is live
      // all of the thread's lanes live (the border lane md - i lies left of vlo)
      const bool inner = k0 >= vlo && k0 + L - 1 <= vhi;
      if (!idle) {
        // UP source of the last lane: the next thread's first lane
        int nxt = __shfl_down_sync(kFull, pr[0], 1);
        if (lane == 31) nxt = WARP ? INF : first[warp + 1];
        unsigned mw[L / 4];  // mismatch bytes (0xff) of the four codes in each word
#pragma unroll
        for (int w = 0; w < L / 4; ++w) mw[w] = __vcmpne4(bw[w], (unsigned)ai * 0x01010101u);

        // D = min(DIAG, UP); lanes past the live run are INF and the border
        // cell is i, a fix-up only threads at the run's edges take
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const int mm = (int)((mw[l >> 2] >> (8 * (l & 3))) & 1u);
          pr[l] = min(pr[l] + mm, (l + 1 < L ? pr[l + 1] : nxt) + 1);
        }
        if (!inner) {
          live = 0;
#pragma unroll
          for (int l = 0; l < L; ++l) {
            const int k = k0 + l;
            const bool valid = k >= vlo && k <= vhi;
            pr[l] = k == kbord ? i : (valid ? pr[l] : INF);
            live |= (valid || k == kbord) ? 1u << l : 0u;
          }
        }
        // u = D - k in place of the row
        int tmin = kScanId;
#pragma unroll
        for (int l = 0; l < L; ++l) {
          pr[l] -= k0 + l;
          tmin = min(tmin, pr[l]);
        }
        const int x = warp_scan_min(tmin, lane);
        excl = warp_exclusive(x, lane);
        if (!WARP && lane == 31) tot[warp] = x;
      }
      if (!WARP) __syncthreads();
      if (!idle) {
        // the running minimum entering this thread's first lane
        int run = WARP ? excl : min(excl, earlier_warps_min(tot, warp, lane));
#pragma unroll
        for (int l = 0; l < L; ++l) {
          run = min(run, pr[l]);
          pr[l] = k0 + l + run;
        }
        if (!inner) {
#pragma unroll
          for (int l = 0; l < L; ++l) pr[l] = ((live >> l) & 1u) ? pr[l] : INF;
        }
        const int kcc = clampi(kc, 0, hi);
        if (WARP) {
          d_ii = __shfl_sync(kFull, pick(pr, md & (L - 1)), md / L);
          c_far = __shfl_sync(kFull, pick(pr, kcc & (L - 1)), kcc / L);
        } else {
          if (lane == 0) first[warp] = pr[0];
          if (t == md / L) slot[0] = pick(pr, md & (L - 1));
          if (col && t == kcc / L) slot[1] = pick(pr, kcc & (L - 1));
        }
      }
#pragma unroll
      for (int w = 0; w < L / 4; ++w) {
        bw[w] = (bw[w] >> 8) | (w + 1 < L / 4 ? bw[w + 1] << 24 : b_next << 24);
      }
      if (!WARP) {
        __syncthreads();
        d_ii = slot[0];
        c_far = slot[1];
      }
      // early failure (seq_aligner.h:185-187) on D(i, i)
      if (i > 10 && i <= len_b && d_ii > thr) {
        failed = true;
        fail_i = i;
        break;
      }
      if (col && c_far < best) {
        best = c_far;
        best_i = i;
      }
      ai = ai_next;
      thr = thr_next;
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
        const int ghi = md + len_b - len_a;
        int v = INT_MAX, kk = INT_MAX;
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const int k = k0 + l;
          if (k >= md && k <= ghi && pr[l] < v) {
            v = pr[l];
            kk = k;
          }
        }
        warp_first_min(v, kk);
        if (!WARP) {
          if (lane == 0) {
            red_v[warp] = v;
            red_k[warp] = kk;
          }
          __syncthreads();
          if (warp == 0) {
            const int nw = (nt + 31) >> 5;
            v = lane < nw ? red_v[lane] : INT_MAX;
            kk = lane < nw ? red_k[lane] : INT_MAX;
            warp_first_min(v, kk);
          }
        }
        cost = v;
        matlen_a = len_a;
        mb = len_a + (kk - md);
        diag_cost = d_ii;
      }
      if (t == 0 && mb >= accept_min[clampi(len_b, 0, tab_len)] && cost < INF) {
        accept = 1;
        matlen_b = mb;
      }
    }
  } else if (ok_size) {
    rows = len_a;
  }

  if (t == 0) {
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

struct Args {
  const uint8_t* a;
  int LA;
  const uint8_t* b;
  int LB;
  const int *la, *lb, *early_thr, *accept_min, *band_tab;
  int tab_len, la_max, w_max, maxn, maxm, B;
  int* out;
};

template <int L, bool WARP>
cudaError_t launch(const Args& g, int S, cudaStream_t stream) {
  const int LBs = (g.LB + 15) & ~15;
  int grid, threads;
  size_t smem;
  if (WARP) {
    if (S > 32 * L) return cudaErrorInvalidValue;
    grid = (g.B + kWarpPairs - 1) / kWarpPairs;
    threads = 32 * kWarpPairs;
    smem = (size_t)kWarpPairs * LBs;
  } else {
    threads = ((S + L - 1) / L + 31) / 32 * 32;
    if (threads > kBlockThreads) return cudaErrorInvalidValue;
    grid = g.B;
    smem = (size_t)LBs;
  }
  cudaError_t err = cudaFuncSetAttribute(
      wavefront_kernel<L, WARP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  wavefront_kernel<L, WARP><<<grid, threads, smem, stream>>>(
      g.a, g.LA, g.b, g.LB, LBs, g.la, g.lb, g.early_thr, g.accept_min, g.band_tab, g.tab_len,
      g.la_max, g.w_max, g.maxn, g.maxm, g.B, g.out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pbt

// warp: 1 = a warp per pair (lanes 4), 0 = a block per pair (lanes 8 or
// 16): band lanes per thread. align/wavefront.py::launch_shape chooses.
extern "C" int pb_wavefront(const void* a, int LA, const void* b, int LB,
                            const void* la, const void* lb, int B,
                            const void* early_thr, const void* accept_min,
                            const void* band_tab, int tab_len, int la_max, int w_max,
                            int maxn, int maxm, int warp, int lanes, void* out, void* stream) {
  using namespace pbt;
  if (B <= 0) return (int)cudaSuccess;
  const Args g{static_cast<const uint8_t*>(a), LA, static_cast<const uint8_t*>(b), LB,
               static_cast<const int*>(la), static_cast<const int*>(lb),
               static_cast<const int*>(early_thr), static_cast<const int*>(accept_min),
               static_cast<const int*>(band_tab), tab_len, la_max, w_max, maxn, maxm, B,
               static_cast<int*>(out)};
  // lanes per pair: pairs run only when md <= w_max and md < maxm
  const int md_cap = w_max < maxm - 1 ? w_max : maxm - 1;
  const int S = 2 * (md_cap > 0 ? md_cap : 0) + 1;
  auto st = static_cast<cudaStream_t>(stream);
  switch (lanes * 2 + (warp ? 1 : 0)) {
    case 9: return (int)launch<4, true>(g, S, st);
    case 16: return (int)launch<8, false>(g, S, st);
    case 32: return (int)launch<16, false>(g, S, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
