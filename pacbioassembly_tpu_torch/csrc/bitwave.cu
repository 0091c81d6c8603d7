// K1: banded Myers/Hyyro bit-parallel screening, one thread or one warp per pair.
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
// What bounds it on Hopper: each column depends on the last, so a pair is a
// chain of min(len_a, len_b) column steps; bytes and operations are far
// below the card's rates. A launch lasts as long as its longest chain. Two
// paths, chosen by the wrapper from the launch's words per stripe:
//
// Narrow stripes (the prefilter: 2 words, 32,768 pairs a launch): one thread
// per pair (bitwave_kernel, built for 2 words). Its stripe is NW 64-bit words
// (VP, VN) in thread-local memory; the Myers addition's cross-word carry ripples inside
// the thread's word loop. The PEQ (per-letter match vectors of the row
// sequence) is built by the thread into a global scratch row and read back
// as 64-bit windows at the column's bit offset. The batch supplies the
// parallelism.
//
// Wide stripes (the full screen: 20-77 words, 256 pairs a launch; locate up
// to 188 words): one warp per pair (bitwave_warp_kernel), which shortens the
// chain of each column to a few shuffle latencies:
//   * lane x owns words [x*WPL, (x+1)*WPL) of VP/VN in registers (WPL a
//     template parameter, every index into them compile-time);
//   * the one-bit shifts of VP/VN (right) and Ph/Mh (left) cross word edges
//     in registers and lane edges by one 32-bit shuffle each;
//   * the Myers addition's carry across words is a carry-lookahead: each lane
//     forms generate (carry out with carry in 0) and propagate (all its words
//     all ones) over its words, two ballots take them across the warp, and
//     the 32-bit sum g + (g | p) gives every lane its carry in as bit x of
//     (g + (g | p)) ^ p: Myers' own in-word trick, one level up;
//   * the lanes owning the centre bits broadcast dh and dv by shuffle, so
//     every lane holds the same score and the early-failure exit is uniform;
//     the test of a column runs after the next column's step, and the PEQ
//     words of a column are loaded a column ahead, so neither sits on the
//     chain;
//   * the warp builds the PEQ by ballots over 32 coalesced codes at a time,
//     into shared memory (4 x PW x 8 bytes a warp), or into the global
//     scratch where that does not fit;
//   * the far-row goal is the first minimum of the running sum of (VP - VN)
//     bits over j in [n, m]: per-lane popcounts, a warp prefix sum, a scan of
//     each lane's own bits, then a warp argmin with ties to the lowest j.
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

constexpr int kWarpsPerBlock = 4;
constexpr size_t kSmemLimit = 232448;  // bytes of shared memory one Hopper block may use

// One warp per pair: the same BatchScores as bitwave_kernel (see the note at
// the top). The PEQ is built in dynamic shared memory (4 * PW words a warp)
// when SMEM, else in the global scratch `peq_g`.
template <int WPL, bool SMEM>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) bitwave_warp_kernel(
    const uint8_t* __restrict__ a, int LA,
    const uint8_t* __restrict__ b, int LB,
    const int* __restrict__ la_in, const int* __restrict__ lb_in, int B,
    const int* __restrict__ early_thr, const int* __restrict__ accept_min,
    const int* __restrict__ band_tab, int tab_len,
    int la_max, int w_max, int maxn, int maxm,
    uint64_t* __restrict__ peq_g, int PW,
    int* __restrict__ out) {
  extern __shared__ uint64_t peq_s[];
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int q = blockIdx.x * (blockDim.x >> 5) + wib;
  if (q >= B) return;  // the whole warp; the kernel has no block barrier

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

    // PEQ: bit t of letter c = (kb[t] == c) for t < m, by ballots over
    // 32 coalesced codes
    uint64_t* pq = SMEM ? peq_s + (size_t)wib * 4 * PW : peq_g + (size_t)q * 4 * PW;
    for (int w = 0; w < PW; ++w) {
      const int t = 64 * w + lane;
      const int c_lo = t < m ? (kb[min(t, kb_last)] & 3) : 4;
      const int c_hi = t + 32 < m ? (kb[min(t + 32, kb_last)] & 3) : 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned lo = __ballot_sync(FULL, c_lo == c);
        const unsigned hi = __ballot_sync(FULL, c_hi == c);
        if (lane == c) pq[c * PW + w] = (uint64_t)lo | ((uint64_t)hi << 32);
      }
    }
    __syncwarp();

    const int S = 2 * md + 1;
    const int nw = (S + 63) >> 6;
    const int topw = (S - 1) >> 6;
    const uint64_t topbit = 1ull << ((S - 1) & 63);
    const uint64_t lastmask = (S & 63) == 0 ? ~0ull : ((1ull << (S & 63)) - 1ull);
    const int cw_h = (md - 1) >> 6, cb_h = (md - 1) & 63;  // center bit of Ph/Mh
    const int cw_v = md >> 6, cb_v = md & 63;              // center bit of VP/VN
    const int lane_h = cw_h / WPL, u_h = cw_h - lane_h * WPL;
    const int lane_v = cw_v / WPL, u_v = cw_v - lane_v * WPL;
    const int w0 = lane * WPL;  // this lane's first word

    uint64_t VP[WPL], VN[WPL], mask[WPL];
#pragma unroll
    for (int u = 0; u < WPL; ++u) {
      const int w = w0 + u;
      mask[u] = w < nw - 1 ? ~0ull : (w == nw - 1 ? lastmask : 0ull);
      VP[u] = mask[u];  // column 0: every delta is +1
      VN[u] = 0ull;
    }

    // Each column's PEQ words are loaded one column ahead, and its early-
    // failure test runs after the next column's step (a column computed past
    // a failure changes no output), so neither the loads nor the dh/dv
    // shuffles sit on the column-to-column chain.
    uint64_t Pw[WPL + 1];
    auto load_peq = [&](int i) {  // PEQ words under column i's stripe
      const uint64_t* P = pq + (size_t)(ka[clampi(i - 1, 0, ka_last)] & 3) * PW;
      const int qw = ((i - md - 1) >> 6) + w0;
#pragma unroll
      for (int u = 0; u <= WPL; ++u) {
        const int idx = qw + u;
        Pw[u] = (idx >= 0 && idx < PW) ? P[idx] : 0ull;
      }
    };
    load_peq(1);

    int Sc = 0;  // D(i, i) of the last column tested
    int dh_s = 0, dv_s = 0;  // the deltas of the column not yet tested
    bool failed = false;
    int fail_i = 0;
    for (int i = 1; i <= n; ++i) {
      const int t0 = i - md - 1;  // kb index of stripe bit 0
      const int p0 = md - i;      // border row j = 0 (while i <= md)
      const int rb = t0 & 63;
      uint64_t PM[WPL];
#pragma unroll
      for (int u = 0; u < WPL; ++u) {
        PM[u] = (rb == 0 ? Pw[u] : (Pw[u] >> rb) | (Pw[u + 1] << (64 - rb))) & mask[u];
      }
      load_peq(i + 1);

      // bit 0 of the next lane's first VP and VN words
      unsigned nb = __shfl_down_sync(
          FULL, (unsigned)(VP[0] & 1ull) | ((unsigned)(VN[0] & 1ull) << 1), 1);
      if (lane == 31) nb = 0;

      // previous column re-aligned one stripe up (the entering row pretends
      // VP=1); X + VPp per word, with its generate and propagate bits
      uint64_t VPp[WPL], VNp[WPL], s1[WPL];
      unsigned gen = 0, prop = 0;
#pragma unroll
      for (int u = 0; u < WPL; ++u) {
        const uint64_t vp_next = u + 1 < WPL ? VP[u + 1] : (uint64_t)(nb & 1u);
        const uint64_t vn_next = u + 1 < WPL ? VN[u + 1] : (uint64_t)((nb >> 1) & 1u);
        uint64_t vpp = (VP[u] >> 1) | (vp_next << 63);
        if (w0 + u == topw) vpp |= topbit;
        VPp[u] = vpp & mask[u];
        VNp[u] = ((VN[u] >> 1) | (vn_next << 63)) & mask[u];
        const uint64_t X = PM[u] & VPp[u];
        s1[u] = X + VPp[u];
        gen |= (s1[u] < X ? 1u : 0u) << u;
        prop |= (s1[u] == ~0ull ? 1u : 0u) << u;
      }
      // carry-lookahead across the warp: lane generate / propagate, two
      // ballots, and every lane's carry in from one 32-bit addition
      unsigned lane_gen = 0;
#pragma unroll
      for (int u = 0; u < WPL; ++u) lane_gen = ((gen >> u) & 1u) | (((prop >> u) & 1u) & lane_gen);
      const unsigned gb = __ballot_sync(FULL, lane_gen != 0);
      const unsigned pb = __ballot_sync(FULL, prop == (1u << WPL) - 1u);
      unsigned carry = (((gb + (gb | pb)) ^ pb) >> lane) & 1u;

      uint64_t Ph[WPL], Mh[WPL];
      int dh_l = 0;
#pragma unroll
      for (int u = 0; u < WPL; ++u) {
        const uint64_t sum = s1[u] + carry;
        carry = ((gen >> u) & 1u) | (((prop >> u) & 1u) & carry);
        const uint64_t Xh = ((sum & mask[u]) ^ VPp[u]) | PM[u];
        uint64_t ph = (VNp[u] | ~(Xh | VPp[u])) & mask[u];
        uint64_t mh = VPp[u] & Xh;
        if (p0 >= 0 && (p0 >> 6) == w0 + u) {  // border row: horizontal delta +1
          const uint64_t bb = 1ull << (p0 & 63);
          ph |= bb;
          mh &= ~bb;
        }
        Ph[u] = ph;
        Mh[u] = mh;
        if (u == u_h) dh_l = (int)((ph >> cb_h) & 1ull) - (int)((mh >> cb_h) & 1ull);
      }
      // top bits of the previous lane's last Ph and Mh words
      unsigned tb = __shfl_up_sync(
          FULL, (unsigned)(Ph[WPL - 1] >> 63) | ((unsigned)(Mh[WPL - 1] >> 63) << 1), 1);
      if (lane == 0) tb = 0;
      int dv_l = 0;
#pragma unroll
      for (int u = 0; u < WPL; ++u) {
        const uint64_t ph_in = u > 0 ? Ph[u - 1] >> 63 : (uint64_t)(tb & 1u);
        const uint64_t mh_in = u > 0 ? Mh[u - 1] >> 63 : (uint64_t)((tb >> 1) & 1u);
        const uint64_t Phs = ((Ph[u] << 1) | ph_in) & mask[u];
        const uint64_t Mhs = ((Mh[u] << 1) | mh_in) & mask[u];
        const uint64_t Xv = PM[u] | VNp[u];
        const uint64_t VPn = (Mhs | ~(Xv | Phs)) & mask[u];
        const uint64_t VNn = Phs & Xv;
        if (u == u_v) dv_l = (int)((VPn >> cb_v) & 1ull) - (int)((VNn >> cb_v) & 1ull);
        VP[u] = VPn;
        VN[u] = VNn;
      }
      // early failure of column i - 1 (seq_aligner.h:185-187); uniform
      // across the warp
      Sc += dh_s + dv_s;
      if (i > 11 && Sc > early_thr[i - 1]) {
        failed = true;
        fail_i = i - 1;
        break;
      }
      dh_s = __shfl_sync(FULL, dh_l, lane_h);
      dv_s = __shfl_sync(FULL, dv_l, lane_v);
    }
    if (!failed) {  // the last column's test
      Sc += dh_s + dv_s;
      if (n > 10 && Sc > early_thr[n]) {
        failed = true;
        fail_i = n;
      }
    }

    if (!failed && n >= 1) {
      // far-row goal: D(n, j) for j in [n, m] is Sc plus the (VP - VN) bits
      // md+1 .. j-n+md; first minimum wins
      const int b_lo = md + 1, b_hi = md + (m - n);
      int delta = 0;
#pragma unroll
      for (int u = 0; u < WPL; ++u) {
        const int base = (w0 + u) * 64;
        const int lo_b = max(b_lo - base, 0), hi_b = min(b_hi - base, 63);
        if (lo_b <= hi_b) {
          const uint64_t rm = (hi_b == 63 ? ~0ull : ((1ull << (hi_b + 1)) - 1ull)) &
                              ~((1ull << lo_b) - 1ull);
          delta += __popcll(VP[u] & rm) - __popcll(VN[u] & rm);
        }
      }
      int incl = delta;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += y;
      }
      // (cost << 32 | j): the minimum is the first minimum (costs are >= 0)
      uint64_t best = lane == 0 ? ((uint64_t)Sc << 32) | (uint32_t)n : ~0ull;
      int val = Sc + incl - delta;
#pragma unroll
      for (int u = 0; u < WPL; ++u) {
        const int base = (w0 + u) * 64;
        const int lo_b = max(b_lo - base, 0), hi_b = min(b_hi - base, 63);
        for (int t = lo_b; t <= hi_b; ++t) {
          val += (int)((VP[u] >> t) & 1ull) - (int)((VN[u] >> t) & 1ull);
          const uint64_t key = ((uint64_t)val << 32) | (uint32_t)(n + base + t - md);
          best = key < best ? key : best;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const uint64_t o = __shfl_xor_sync(FULL, best, off);
        best = o < best ? o : best;
      }
      const int best_val = (int)(best >> 32);
      const int best_j = (int)(best & 0xffffffffull);
      const int ma = swap ? best_j : n;
      const int mb = swap ? n : best_j;
      if (mb >= accept_min[clampi(len_b, 0, tab_len)] && best_val < INF) {
        accept = 1;
        cost = best_val;
        matlen_a = ma;
        matlen_b = mb;
        diag_cost = swap ? -1 : Sc;
      }
    }
    // reference-equivalent rows (align/scan.py): abort row, else len_a
    rows = failed ? fail_i : len_a;
  }

  if (lane == 0) {
    out[0 * B + q] = accept;
    out[1 * B + q] = cost;
    out[2 * B + q] = matlen_a;
    out[3 * B + q] = matlen_b;
    out[4 * B + q] = diag_cost;
    out[5 * B + q] = rows;
  }
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

template <int WPL>
cudaError_t launch_warp(const uint8_t* a, int LA, const uint8_t* b, int LB,
                        const int* la, const int* lb, int B,
                        const int* early_thr, const int* accept_min, const int* band_tab,
                        int tab_len, int la_max, int w_max, int maxn, int maxm,
                        uint64_t* peq, int PW, int* out, cudaStream_t stream) {
  if (peq != nullptr) {  // the PEQ in the global scratch
    const int grid = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
    bitwave_warp_kernel<WPL, false><<<grid, 32 * kWarpsPerBlock, 0, stream>>>(
        a, LA, b, LB, la, lb, B, early_thr, accept_min, band_tab, tab_len, la_max,
        w_max, maxn, maxm, peq, PW, out);
    return cudaGetLastError();
  }
  // the PEQ in shared memory: as many warps a block as fit
  const size_t per_warp = (size_t)4 * PW * sizeof(uint64_t);
  int warps = kWarpsPerBlock;
  while (warps > 1 && warps * per_warp > kSmemLimit) warps >>= 1;
  const size_t smem = warps * per_warp;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      bitwave_warp_kernel<WPL, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + warps - 1) / warps;
  bitwave_warp_kernel<WPL, true><<<grid, 32 * warps, smem, stream>>>(
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
                          int maxn, int maxm, void* peq, int PW, int path,
                          void* out, void* stream) {
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
  // path 2: one warp per pair, ceil(words / 32) words a lane; path 1: one
  // thread per pair
  if (path == 2) {
#define PB_WPL(N)                                                                       \
  if (words <= 32 * N)                                                                  \
    return (int)launch_warp<N>(A, LA, Bm, LB, LAv, LBv, B, ET, AM, BT, tab_len, la_max, \
                               w_max, maxn, maxm, PQ, PW, O, st);
    PB_WPL(1)
    PB_WPL(2)
    PB_WPL(3)
    PB_WPL(4)
    PB_WPL(5)
    PB_WPL(6)
#undef PB_WPL
    return (int)cudaErrorInvalidValue;  // band wider than 192 words: never valid (md < maxm)
  }
  // wider stripes take the warp path
  if (path != 1 || PQ == nullptr || words > 2) return (int)cudaErrorInvalidValue;
  return (int)launch_nw<2>(A, LA, Bm, LB, LAv, LBv, B, ET, AM, BT, tab_len, la_max, w_max,
                           maxn, maxm, PQ, PW, O, st);
}

extern "C" const char* pb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
