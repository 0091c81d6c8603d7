// K2: banded-DP parent plane for traceback, one block per pair.
//
// Replaces the Pallas TPU kernel pacbioassembly_tpu/align/tbwave.py::_kernel
// (launched by batch_parents_pallas). Same recurrence and the same packed
// output, bit for bit: out[q, rb, k] holds, in bits [2r, 2r+1], the parent
// of DP cell (row rb*16 + r + 1, band lane k) of pair q, with MATCH > INSERT
// > DELETE on ties (align/banded.py) and 0 outside the band. The kernel
// writes every word of its pair's plane, zeros included, so the caller
// allocates it uninitialised.
//
// What bounds it on Hopper: each DP row depends on the last, so a pair is a
// chain of len_a row steps, and a commit launch has only 32 pairs (32 SMs).
// The time is one row step on one SM, not bytes or the card's operation
// rate: the step's instructions over the SM's four schedulers, plus the
// latency of its shuffles and two barriers. The design keeps that step
// short:
//   * a block computes only its pair's band, lanes |k - W| <= md (clipped to
//     the plane's S lanes); warps that hold no band lane only join barriers;
//   * each thread owns L consecutive lanes and keeps their row in registers;
//     the DIAG/UP sources cross a thread edge by one shuffle and a warp edge
//     through a one-int-per-warp shared array; the b codes under its lanes
//     sit four to a register and shift by one code a row (one shared load a
//     thread), compared four at a time (__vcmpne4); the lane work has no
//     branch;
//   * the in-row INSERT chain cur[k] = min_{j<=k} D[j] + (k - j) is a prefix
//     minimum of u = D - k: serial over the thread's lanes, a 5-step shuffle
//     scan over the warp, and each warp's total through shared memory, read
//     by every later warp after one barrier. Two barriers a row in all (the
//     second publishes each warp's first lane for the next row's UP source);
//   * the parents of 16 rows build up in a register per lane and leave
//     through a shared row as one coalesced 16-byte-vector store of S lanes.
// Every live cell (in band, 1 <= j <= len_b, or the row-0 border) has a
// finite cost, reachable along its diagonal from a border, and non-live
// cells are forced to INF before the parents are chosen; so any exact prefix
// gives the live values of the TPU kernel's doubling scan, and the parent
// tests (cur == diag, cur == left + 1) reduce to equalities of the running
// minimum: MATCH iff DIAG is the lane's own D and the running minimum is the
// lane's own u; INSERT iff the left lane is live and the minimum did not move.

#include "common.cuh"

namespace pbt {
namespace {

// threads a block of L lanes per thread may have (registers: pr and pw are
// 2L of them)
constexpr int max_threads(int L) { return L <= 8 ? 1024 : 768; }

template <int L>
__global__ void __launch_bounds__(max_threads(L)) tbwave_kernel(
    const uint8_t* __restrict__ a, int LA,
    const uint8_t* __restrict__ b, int LB,
    const int* __restrict__ md_in, const int* __restrict__ lena_in,
    const int* __restrict__ lenb_in, int W, int S, int NRB, int* __restrict__ out) {
  extern __shared__ int4 smem4[];
  int* stage = reinterpret_cast<int*>(smem4);              // S lanes of packed parents
  uint8_t* bs = reinterpret_cast<uint8_t*>(stage + S);     // the pair's b codes
  __shared__ int tot[kMaxWarps];        // each warp's prefix minimum of u
  __shared__ int first[kMaxWarps + 1];  // prev at each warp's first lane

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int md = md_in[q];
  const int lena = lena_in[q];
  const int lenb = lenb_in[q];
  const uint8_t* arow = a + (size_t)q * LA;
  const uint8_t* brow = b + (size_t)q * LB;
  int4* outq = reinterpret_cast<int4*>(out + (size_t)q * NRB * S);
  const int S4 = S >> 2;  // S is a multiple of 128

  // the band, clipped to the plane; this thread's lanes k0 .. k0 + L - 1
  const int lo = max(0, W - md);
  const int hi = min(S - 1, W + md);
  const int k0 = lo + tid * L;
  const bool idle = lo + warp * 32 * L > hi;  // the whole warp is past the band

  for (int k = tid; k < S; k += blockDim.x) stage[k] = 0;
  for (int t = tid; t < LB; t += blockDim.x) bs[t] = brow[t];
  if (tid <= kMaxWarps) first[tid] = INF;  // warps past the band read INF

  // row 0: cost(0, j) = j for 0 <= j <= min(len_b, md)
  const int row0_hi = min(lenb, md);
  int pr[L];  // prev row, then u = D - k within a row step
  unsigned pw[L];  // packed parents of the current 16-row block
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int j0 = k0 + l - W;
    pr[l] = (k0 + l <= hi && j0 >= 0 && j0 <= row0_hi) ? j0 : INF;
    pw[l] = 0;
  }
  __syncthreads();
  if (lane == 0 && !idle) first[warp] = pr[0];
  __syncthreads();

  // rows past len_a have zero parents: the loop stops at len_a and the
  // remaining row blocks are zero-filled below
  const int nrows = min(lena, NRB * 16);
  int ai = LA > 0 ? (int)arow[0] : 0;  // a's code of this row, loaded one row ahead
  // b codes under this thread's lanes, four to a word: lane l of row i
  // reads b[k0 + l + i - W - 1] (clamped to the row), which is lane l + 1's
  // code of row i - 1, so each row shifts one code in
  const int bmax = LB - 1;
  unsigned bw[L / 4];
#pragma unroll
  for (int w = 0; w < L / 4; ++w) {
    bw[w] = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      bw[w] |= (unsigned)bs[clampi(k0 + 4 * w + c - W, 0, bmax)] << (8 * c);
    }
  }
  for (int i = 1; i <= nrows; ++i) {
    const int r = (i - 1) & 15;
    const bool flush = r == 15 || i == nrows;
    // live lanes of this row: j = k + i - W in [1, len_b] within the band,
    // plus the border lane k = W - i while i <= md
    const int vlo = max(lo, W + 1 - i);
    const int vhi = min(hi, W + lenb - i);
    const int kbord = i <= md ? W - i : -1;
    int excl = kScanId;
    unsigned deq = 0;  // bit l: DIAG is lane l's D (a MATCH if cur == D)
    unsigned vm = 0;   // bit l: lane l has 1 <= j <= len_b in the band
    const int ai_next = i < LA ? (int)arow[i] : 0;
    const unsigned b_next = bs[clampi(k0 + L - 1 + i - W, 0, bmax)];
    if (!idle) {
      // UP source of the last lane: the next thread's first lane
      int nxt = __shfl_down_sync(kFull, pr[0], 1);
      if (lane == 31) nxt = first[warp + 1];

      // mismatch bytes (0xff) of the four codes in each word
      unsigned mw[L / 4];
#pragma unroll
      for (int w = 0; w < L / 4; ++w) mw[w] = __vcmpne4(bw[w], (unsigned)ai * 0x01010101u);

      // D = min(DIAG, UP), the border cell = i; u = D - k in place of prev
      int tmin = kScanId;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int k = k0 + l;
        const bool valid = k >= vlo && k <= vhi;
        const int mm = (int)((mw[l >> 2] >> (8 * (l & 3))) & 1u);
        const int diag = valid ? pr[l] + mm : INF;
        const int up = valid ? (l + 1 < L ? pr[l + 1] : nxt) + 1 : INF;
        int D = min(diag, up);
        D = k == kbord ? i : D;
        vm |= valid ? 1u << l : 0u;
        deq |= (valid && diag == D) ? 1u << l : 0u;
        pr[l] = D - k;
        tmin = min(tmin, pr[l]);
      }
      // warp scan of the threads' minima; lane 31 holds the warp's
      const int x = warp_scan_min(tmin, lane);
      excl = warp_exclusive(x, lane);
      if (lane == 31) tot[warp] = x;
    }
    __syncthreads();

    if (!idle) {
      // the running minimum entering this thread's first lane: the earlier
      // warps' totals
      int run = min(excl, earlier_warps_min(tot, warp, lane));
      const int kl = k0 - 1;  // the left neighbour of the first lane
      bool left_live = kl >= lo && ((kl >= vlo && kl <= vhi) || kl == kbord);
      int left_run = run;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int k = k0 + l;
        const int u = pr[l];
        run = min(run, u);
        const bool border = k == kbord;
        const bool live = ((vm >> l) & 1u) || border;
        const bool match = ((deq >> l) & 1u) && run == u;
        const bool insert = left_live && run == left_run;
        int par = match ? MATCH : (insert ? INSERT : DELETE);
        par = border ? DELETE : par;
        par = live ? par : 0;
        pr[l] = live ? k + run : INF;
        pw[l] |= (unsigned)par << (2 * r);
        left_live = live;
        left_run = run;
      }
      if (lane == 0) first[warp] = pr[0];
      if (flush) {
#pragma unroll
        for (int l = 0; l < L; ++l) {
          if (k0 + l <= hi) stage[k0 + l] = (int)pw[l];
          pw[l] = 0;
        }
      }
    }
    ai = ai_next;
#pragma unroll
    for (int w = 0; w < L / 4; ++w) {
      bw[w] = (bw[w] >> 8) | (w + 1 < L / 4 ? bw[w + 1] << 24 : b_next << 24);
    }
    __syncthreads();
    if (flush) {
      int4* dst = outq + (size_t)((i - 1) >> 4) * S4;
      for (int v = tid; v < S4; v += blockDim.x) dst[v] = smem4[v];
    }
  }

  // row blocks past the pair's last row
  const int4 zero = make_int4(0, 0, 0, 0);
  for (size_t v = (size_t)((nrows + 15) >> 4) * S4 + tid; v < (size_t)NRB * S4;
       v += blockDim.x) {
    outq[v] = zero;
  }
}

template <int L>
cudaError_t launch_l(const uint8_t* a, int LA, const uint8_t* b, int LB, const int* md,
                     const int* len_a, const int* len_b, int B, int W, int S, int NRB, int* out,
                     cudaStream_t stream) {
  const int threads = ((S + L - 1) / L + 31) / 32 * 32;
  if (threads > max_threads(L)) return cudaErrorInvalidValue;
  const size_t smem = (size_t)S * sizeof(int) + (((size_t)LB + 15) & ~(size_t)15);
  cudaError_t err = cudaFuncSetAttribute(
      tbwave_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  tbwave_kernel<L><<<B, threads, smem, stream>>>(a, LA, b, LB, md, len_a, len_b, W, S, NRB,
                                                  out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pbt

// lanes: lanes per thread (4, 8 or 16), 0 = the kernel's choice for S
extern "C" int pb_tbwave(const void* a, int LA, const void* b, int LB,
                         const void* md, const void* len_a, const void* len_b, int B,
                         int w_max, int S, int NRB, int lanes, void* out, void* stream) {
  using namespace pbt;
  if (B <= 0) return (int)cudaSuccess;
  if (lanes == 0) lanes = S <= 4 * 1024 ? 4 : (S <= 8 * 1024 ? 8 : 16);
  auto* A = static_cast<const uint8_t*>(a);
  auto* Bm = static_cast<const uint8_t*>(b);
  auto* MD = static_cast<const int*>(md);
  auto* LAd = static_cast<const int*>(len_a);
  auto* LBd = static_cast<const int*>(len_b);
  auto* O = static_cast<int*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 4: return (int)launch_l<4>(A, LA, Bm, LB, MD, LAd, LBd, B, w_max, S, NRB, O, st);
    case 8: return (int)launch_l<8>(A, LA, Bm, LB, MD, LAd, LBd, B, w_max, S, NRB, O, st);
    case 16: return (int)launch_l<16>(A, LA, Bm, LB, MD, LAd, LBd, B, w_max, S, NRB, O, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
