// K1: banded Myers/Hyyro bit-parallel screening, one thread per pair.
//
// Replaces the Pallas TPU kernel pacbioassembly_tpu/align/bitwave.py::_kernel
// (launched by _call_kernel, wrapped by batch_score_bitpallas) together with
// its XLA prologue (_prep: geometry, transpose, PEQ) and epilogue (_post:
// far-row goal, un-transpose, acceptance). One launch computes the whole
// BatchScores contract of align/scan.py::batch_score.
//
// Algorithm (derivation: pacbioassembly_tpu/align/bitparallel.py): the band
// of S = 2*md+1 cells is a bit vector, bit p = row j - i + md of column i.
// Pairs are transposed so that the column sequence is the shorter one
// (edit distance and the band are symmetric); the far-row goal then comes
// from the final column's vertical deltas, and the original far-column goal
// is that far row read back in the original orientation.
//
// Design on Hopper: one thread owns one pair. Its stripe is NW 64-bit words
// (VP, VN) in thread-local memory; the Myers addition's cross-word carry is
// a ripple inside the thread's word loop, so the whole column is one pass
// over the words, low to high, with the shifts' carries in registers. The
// per-letter match vectors (PEQ) of the row sequence are built once per pair
// into a global scratch row and read back as 64-bit windows at the column's
// bit offset. What bounds it: the sequential dependency of each column on
// the last (latency of the local-memory word loop), not bytes or FLOPs; the
// batch dimension supplies the parallelism (65,536 prefilter pairs, up to
// 4,096 full-screen pairs per launch). Warp-cooperative words and ballot
// carries are later work.
//
// All shifts are on uint64_t; no shift reaches the word width (r == 0 is
// special-cased in peq_window). Thresholds arrive as int32 tables computed in
// float64 on the host; there is no floating point on the device.

#include "common.cuh"

namespace pbt {
namespace {

// bits [s, s + 64) of the bit vector P (PW words), zero outside [0, 64*PW)
__device__ __forceinline__ uint64_t peq_window(const uint64_t* __restrict__ P, int PW, int s) {
  const int q = s >> 6;  // floor division for negative s too
  const int r = s & 63;
  const uint64_t lo = (q >= 0 && q < PW) ? P[q] : 0ull;
  if (r == 0) return lo;
  const uint64_t hi = (q + 1 >= 0 && q + 1 < PW) ? P[q + 1] : 0ull;
  return (lo >> r) | (hi << (64 - r));
}

template <int NW>
__global__ void bitwave_kernel(
    const uint8_t* __restrict__ a, int LA,
    const uint8_t* __restrict__ b, int LB,
    const int* __restrict__ la_in, const int* __restrict__ lb_in, int B,
    const int* __restrict__ early_thr, const int* __restrict__ accept_min,
    const int* __restrict__ band_tab, int tab_len,
    int la_max, int w_max, int maxn, int maxm,
    uint64_t* __restrict__ peq, int PW,
    int* __restrict__ out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B) return;

  // per-pair geometry (seq_aligner.h:92-107), original orientation
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

  if (ok_size) {
    // transpose normalization: the kernel always runs n <= m
    const bool swap = len_a > len_b;
    const int n = min(len_a, len_b);
    const int m = max(len_a, len_b);
    const uint8_t* arow = a + (size_t)q * LA;
    const uint8_t* brow = b + (size_t)q * LB;
    const uint8_t* ka = swap ? brow : arow;  // column sequence, n codes
    const uint8_t* kb = swap ? arow : brow;  // row sequence, m codes
    // reads past a row's width clamp to its last code, as align/scan.py's clip
    const int ka_last = (swap ? LB : LA) - 1;
    const int kb_last = (swap ? LA : LB) - 1;

    // PEQ: bit t of letter c = (kb[t] == c) for t < m
    uint64_t* pq = peq + (size_t)q * 4 * PW;
    for (int w = 0; w < PW; ++w) {
      uint64_t e0 = 0, e1 = 0, e2 = 0, e3 = 0;
      const int t0 = w * 64;
      const int t1 = min(t0 + 64, m);
      for (int t = t0; t < t1; ++t) {
        const uint64_t bit = 1ull << (t - t0);
        switch (kb[min(t, kb_last)] & 3) {
          case 0: e0 |= bit; break;
          case 1: e1 |= bit; break;
          case 2: e2 |= bit; break;
          default: e3 |= bit; break;
        }
      }
      pq[0 * PW + w] = e0;
      pq[1 * PW + w] = e1;
      pq[2 * PW + w] = e2;
      pq[3 * PW + w] = e3;
    }

    const int S = 2 * md + 1;
    const int nw = (S + 63) >> 6;
    const int topw = (S - 1) >> 6;
    const uint64_t topbit = 1ull << ((S - 1) & 63);
    const uint64_t lastmask = (S & 63) == 0 ? ~0ull : ((1ull << (S & 63)) - 1ull);
    const int cw_h = (md - 1) >> 6, cb_h = (md - 1) & 63;  // center bit of Ph/Mh
    const int cw_v = md >> 6, cb_v = md & 63;              // center bit of VP/VN

    uint64_t VP[NW], VN[NW];
    for (int w = 0; w < nw; ++w) {
      VP[w] = (w == nw - 1) ? lastmask : ~0ull;  // column 0: every delta is +1
      VN[w] = 0ull;
    }

    int Sc = 0;  // D(i, i)
    bool failed = false;
    int fail_i = 0;
    for (int i = 1; i <= n; ++i) {
      const uint64_t* P = pq + (size_t)(ka[min(i - 1, ka_last)] & 3) * PW;
      const int t0 = i - md - 1;  // kb index of stripe bit 0
      const int p0 = md - i;      // border row j = 0 (while i <= md)
      uint64_t carry = 0ull, ph_top = 0ull, mh_top = 0ull;
      uint64_t vp_next = VP[0], vn_next = VN[0];
      int dh = 0, dv = 0;
      for (int w = 0; w < nw; ++w) {
        const uint64_t vp = vp_next, vn = vn_next;
        vp_next = (w + 1 < nw) ? VP[w + 1] : 0ull;
        vn_next = (w + 1 < nw) ? VN[w + 1] : 0ull;
        const uint64_t mask = (w == nw - 1) ? lastmask : ~0ull;

        // previous column re-aligned one stripe up; the entering row pretends VP=1
        uint64_t VPp = (vp >> 1) | (vp_next << 63);
        if (w == topw) VPp |= topbit;
        VPp &= mask;
        const uint64_t VNp = ((vn >> 1) | (vn_next << 63)) & mask;
        const uint64_t PM = peq_window(P, PW, t0 + 64 * w) & mask;

        // Myers addition with the carry rippling across words
        const uint64_t X = PM & VPp;
        const uint64_t s1 = X + VPp;
        const uint64_t c1 = s1 < X ? 1ull : 0ull;
        const uint64_t sum = s1 + carry;
        const uint64_t c2 = sum < s1 ? 1ull : 0ull;
        carry = c1 | c2;

        const uint64_t Xh = ((sum & mask) ^ VPp) | PM;
        uint64_t Ph = (VNp | ~(Xh | VPp)) & mask;
        uint64_t Mh = VPp & Xh;
        if (p0 >= 0 && (p0 >> 6) == w) {  // border row: horizontal delta +1
          const uint64_t bb = 1ull << (p0 & 63);
          Ph |= bb;
          Mh &= ~bb;
        }
        const uint64_t Phs = ((Ph << 1) | ph_top) & mask;
        const uint64_t Mhs = ((Mh << 1) | mh_top) & mask;
        ph_top = Ph >> 63;
        mh_top = Mh >> 63;
        const uint64_t Xv = PM | VNp;
        const uint64_t VPn = (Mhs | ~(Xv | Phs)) & mask;
        const uint64_t VNn = Phs & Xv;

        if (w == cw_h) dh = (int)((Ph >> cb_h) & 1ull) - (int)((Mh >> cb_h) & 1ull);
        if (w == cw_v) dv = (int)((VPn >> cb_v) & 1ull) - (int)((VNn >> cb_v) & 1ull);
        VP[w] = VPn;
        VN[w] = VNn;
      }
      Sc += dh + dv;
      // early failure (seq_aligner.h:185-187); i <= n <= m always holds here
      if (i > 10 && Sc > early_thr[i]) {
        failed = true;
        fail_i = i;
        break;
      }
    }

    if (!failed && n >= 1) {
      // far-row goal: D(n, j) for j in [n, m], first minimum wins
      int val = Sc, best = Sc, best_j = n;
      for (int j = n + 1; j <= m; ++j) {
        const int pp = j - n + md;
        val += (int)((VP[pp >> 6] >> (pp & 63)) & 1ull) -
               (int)((VN[pp >> 6] >> (pp & 63)) & 1ull);
        if (val < best) {
          best = val;
          best_j = j;
        }
      }
      const int ma = swap ? best_j : n;
      const int mb = swap ? n : best_j;
      if (mb >= accept_min[clampi(len_b, 0, tab_len)] && best < INF) {
        accept = 1;
        cost = best;
        matlen_a = ma;
        matlen_b = mb;
        diag_cost = swap ? -1 : Sc;
      }
    }
    // reference-equivalent rows (align/scan.py): abort row, else len_a
    rows = failed ? fail_i : len_a;
  }

  out[0 * B + q] = accept;
  out[1 * B + q] = cost;
  out[2 * B + q] = matlen_a;
  out[3 * B + q] = matlen_b;
  out[4 * B + q] = diag_cost;
  out[5 * B + q] = rows;
}

template <int NW>
cudaError_t launch_nw(const uint8_t* a, int LA, const uint8_t* b, int LB,
                      const int* la, const int* lb, int B,
                      const int* early_thr, const int* accept_min, const int* band_tab,
                      int tab_len, int la_max, int w_max, int maxn, int maxm,
                      uint64_t* peq, int PW, int* out, cudaStream_t stream) {
  constexpr int kThreads = 64;
  const int grid = (B + kThreads - 1) / kThreads;
  bitwave_kernel<NW><<<grid, kThreads, 0, stream>>>(
      a, LA, b, LB, la, lb, B, early_thr, accept_min, band_tab, tab_len, la_max,
      w_max, maxn, maxm, peq, PW, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pbt

extern "C" int pb_bitwave(const void* a, int LA, const void* b, int LB,
                          const void* la, const void* lb, int B,
                          const void* early_thr, const void* accept_min,
                          const void* band_tab, int tab_len, int la_max, int w_max,
                          int maxn, int maxm, void* peq, int PW, void* out,
                          void* stream) {
  using namespace pbt;
  if (B <= 0) return (int)cudaSuccess;
  // words per stripe: pairs run only when md <= w_max and md < maxm
  const int md_cap = w_max < maxm - 1 ? w_max : maxm - 1;
  const int words = (2 * md_cap + 1 + 63) / 64;
  auto* A = static_cast<const uint8_t*>(a);
  auto* Bm = static_cast<const uint8_t*>(b);
  auto* LAv = static_cast<const int*>(la);
  auto* LBv = static_cast<const int*>(lb);
  auto* ET = static_cast<const int*>(early_thr);
  auto* AM = static_cast<const int*>(accept_min);
  auto* BT = static_cast<const int*>(band_tab);
  auto* PQ = static_cast<uint64_t*>(peq);
  auto* O = static_cast<int*>(out);
  auto st = static_cast<cudaStream_t>(stream);
#define PB_NW(N)                                                                      \
  if (words <= N)                                                                     \
    return (int)launch_nw<N>(A, LA, Bm, LB, LAv, LBv, B, ET, AM, BT, tab_len, la_max, \
                             w_max, maxn, maxm, PQ, PW, O, st);
  PB_NW(2)
  PB_NW(4)
  PB_NW(8)
  PB_NW(16)
  PB_NW(32)
  PB_NW(64)
  PB_NW(128)
  PB_NW(192)
#undef PB_NW
  return (int)cudaErrorInvalidValue;  // band wider than 192 words: never valid (md < maxm)
}

extern "C" const char* pb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
