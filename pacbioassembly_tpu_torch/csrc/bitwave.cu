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
// paths, chosen by the wrapper from the launch's words per stripe (and for
// the thread path, whether a block's rows fit in shared memory):
//
// Narrow stripes (the prefilter: 2 words, up to 32,768 pairs a launch): one
// thread per pair (bitwave_kernel, built for 2 words). A pair is a chain of
// up to 128 column steps of a few dozen 64-bit integer operations each. With
// one warp to a scheduler (a few thousand pairs a launch) the chain's
// latency bounds the launch; with two or more, the schedulers' issue rate.
// So every memory access and every branch stays off the chain, and a column
// costs as few instructions as it can. The design:
//   * the stripe is four named 64-bit registers (VP, VN: two words each),
//     the Myers addition's carry passes from the low word to the high one
//     in registers, and the far-row goal shifts the two words into one
//     rather than indexing a word at run time: no local memory;
//   * the PEQ is a sliding window in registers, no scratch: each letter
//     keeps the 128 bits [t0, t0 + 128) of its match vector over the row
//     sequence (t0 = i - md - 1 at column i); a column picks its letter's
//     window by selects, then every window shifts right by one and takes
//     the row code at t0 + 128 into its top bit;
//   * a block is one warp of 32 consecutive pairs: their a rows and b rows
//     are each one contiguous span, copied whole by cp.async with the three
//     threshold tables (every word in flight at once), then laid out in
//     shared memory at a pitch of an odd number of 32-bit words (so lanes
//     reading one column of their rows fall on distinct banks); the
//     column's code and the row code the windows take are read from there
//     one column ahead, and the early-failure test of a column runs after
//     the next column's step, so neither a load nor the test is on the
//     chain;
//   * column 1's windows come from the row's first 128 codes, four codes a
//     32-bit load split into their two bit planes.

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
// All shifts are on uint64_t; no shift reaches the word width. Thresholds
// arrive as int32 tables computed in float64 on the host; there is no
// floating point on the device.

#include "common.cuh"

namespace pbt {
namespace {

constexpr size_t kSmemLimit = 232448;  // bytes of shared memory one Hopper block may use
constexpr int kMaxThreadPairs = 128;   // pairs (threads) a thread-path block may hold

// Shared-memory pitch of a staged row of L codes: an odd number of 32-bit
// words, so that the 32 lanes of a warp reading one column hit 32 banks.
__host__ __device__ __forceinline__ int row_pitch(int L) { return 4 * (((L + 3) >> 2) | 1); }

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Bytes of the flat copy of a block's rows of L codes: whole 16-byte words
// from the one holding the span's first byte, and one word to spare.
__host__ __device__ __forceinline__ size_t flat_bytes(int L, int pairs) {
  return 16 * (((size_t)pairs * L + 15) / 16 + 2);
}

constexpr int kRowPad = 128;  // bytes past the last staged row the first windows may read

// A thread-path block's shared memory, byte offsets: the three threshold
// tables (tab_len + 1 int32 each) at 0, the pitched a rows and b rows, a pad,
// then the flat copies of the a and b spans.
struct ThreadStage {
  size_t rows_a, rows_b, flat_a, flat_b, total;
};

__host__ __device__ __forceinline__ ThreadStage thread_stage(int LA, int LB, int tab_len,
                                                             int pairs) {
  ThreadStage st;
  st.rows_a = align16((size_t)12 * (tab_len + 1));
  st.rows_b = st.rows_a + (size_t)pairs * row_pitch(LA);
  st.flat_a = align16(st.rows_b + (size_t)pairs * row_pitch(LB) + kRowPad);
  st.flat_b = st.flat_a + flat_bytes(LA, pairs);
  st.total = st.flat_b + flat_bytes(LB, pairs);
  return st;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Rows q0 .. q0 + rows - 1 of a (B, L) code matrix are one contiguous span:
// start copying it, as the 16-byte words that hold it, into `flat` (cp.async,
// every word in flight at once; a word holding any byte of the span lies in
// the same 16-byte granule of its allocation). Returns the span's offset in
// `flat`.
__device__ __forceinline__ int copy_span(const uint8_t* __restrict__ g, int L, int q0, int rows,
                                         uint8_t* flat) {
  const uint8_t* span = g + (size_t)q0 * L;
  const int lead = (int)(reinterpret_cast<uintptr_t>(span) & 15);
  const uint8_t* base = span - lead;
  const int nwords = (lead + rows * L + 15) >> 4;
  for (int w = threadIdx.x; w < nwords; w += blockDim.x) cp_async16(flat + 16 * w, base + 16 * w);
  return lead;
}

constexpr int kPitchBatch = 8;  // words a thread loads before it stores any (pitch_rows)

// The copied span's rows into shared memory at `pitch` bytes a row, a 32-bit
// word at a time (a funnel shift of the two words that hold it; a row's last
// word may carry bytes past the row into its padding), kPitchBatch words a
// thread loaded before any is stored.
__device__ __forceinline__ void pitch_rows(const uint8_t* flat, int lead, int L, int rows,
                                           uint8_t* s, int pitch) {
  if (L <= 0) return;
  const int wpr = (L + 3) >> 2;  // 32-bit words a row
  const int n = rows * wpr;
  const uint32_t* f = reinterpret_cast<const uint32_t*>(flat);
  // row and word of this thread's first item, and the step to its next
  int r = threadIdx.x / wpr, k = threadIdx.x - r * wpr;
  const int dr = blockDim.x / wpr, dk = blockDim.x - dr * wpr;
  for (int x0 = threadIdx.x; x0 < n; x0 += kPitchBatch * blockDim.x) {
    uint32_t lo[kPitchBatch], hi[kPitchBatch];
    int sh[kPitchBatch], at[kPitchBatch];
#pragma unroll
    for (int u = 0; u < kPitchBatch; ++u) {
      const bool live = x0 + u * (int)blockDim.x < n;
      const int o = lead + r * L + 4 * k;  // the word's first byte in `flat`
      lo[u] = live ? f[o >> 2] : 0u;
      hi[u] = live ? f[(o >> 2) + 1] : 0u;
      sh[u] = 8 * (o & 3);
      at[u] = live ? r * pitch + 4 * k : -1;
      k += dk;
      r += dr;
      if (k >= wpr) {
        k -= wpr;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kPitchBatch; ++u) {
      if (at[u] >= 0) {
        *reinterpret_cast<uint32_t*>(s + at[u]) = __funnelshift_r(lo[u], hi[u], sh[u]);
      }
    }
  }
}

// 128 bits as two 64-bit words
struct Bits128 {
  uint64_t lo, hi;
};

// bits [0, k) for 0 <= k <= 128
__device__ __forceinline__ Bits128 low_bits(int k) {
  return {k >= 64 ? ~0ull : (1ull << (k & 63)) - 1ull,
          k >= 128 ? ~0ull : (k <= 64 ? 0ull : (1ull << (k & 63)) - 1ull)};
}

// the window of the letter `c` (0..3) by selects
__device__ __forceinline__ uint64_t pick(int c, uint64_t x0, uint64_t x1, uint64_t x2,
                                         uint64_t x3) {
  return (c & 2) ? ((c & 1) ? x3 : x2) : ((c & 1) ? x1 : x0);
}

// A letter's window: shift right by one, the code at its new top bit in.
__device__ __forceinline__ void slide(Bits128& w, bool in) {
  w.lo = (w.lo >> 1) | (w.hi << 63);
  w.hi = (w.hi >> 1) | (in ? 1ull << 63 : 0ull);
}

// Column 1's window of a letter from its vector over the row's codes
// t < 128: the codes read from the row (`keep`), the last code repeated past
// the row's width (`tail`), shifted up by md (0..63): bit p = t + md, those
// past 127 dropped.
__device__ __forceinline__ void first_window(Bits128& w, Bits128 keep, Bits128 tail, int md) {
  const uint64_t lo = (w.lo & keep.lo) | tail.lo, hi = (w.hi & keep.hi) | tail.hi;
  w.hi = (hi << md) | ((lo >> 1) >> (63 - md));
  w.lo = lo << md;
}

// bit 0 of each byte of x (the others zero) gathered into bits 0..3
__device__ __forceinline__ uint64_t nibble(uint32_t x) {
  return (uint64_t)((x * 0x10204080u) >> 28);
}

// One thread per pair, stripes of at most 2 words (md <= 63); one block
// holds blockDim.x consecutive pairs. See the note at the top.
__global__ void __launch_bounds__(kMaxThreadPairs) bitwave_kernel(
    const uint8_t* __restrict__ a, int LA,
    const uint8_t* __restrict__ b, int LB,
    const int* __restrict__ la_in, const int* __restrict__ lb_in, int B,
    const int* __restrict__ early_thr, const int* __restrict__ accept_min,
    const int* __restrict__ band_tab, int tab_len,
    int la_max, int w_max, int maxn, int maxm,
    int* __restrict__ out) {
  extern __shared__ int4 staged[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(staged);
  const ThreadStage st = thread_stage(LA, LB, tab_len, blockDim.x);
  const int T = tab_len + 1;
  int* et = reinterpret_cast<int*>(sm);
  int* am = et + T;
  int* bt = am + T;
  const int pa = row_pitch(LA), pb = row_pitch(LB);
  uint8_t* sa = sm + st.rows_a;
  uint8_t* sb = sm + st.rows_b;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * blockDim.x;
  const int rows = min((int)blockDim.x, B - q0);
  const int lead_a = copy_span(a, LA, q0, rows, sm + st.flat_a);
  const int lead_b = copy_span(b, LB, q0, rows, sm + st.flat_b);
  const int q = q0 + tid;
  const int la = tid < rows ? la_in[q] : 0;
  const int lb = tid < rows ? lb_in[q] : 0;
  for (int k = tid; k < T; k += blockDim.x) {
    cp_async4(et + k, early_thr + k);
    cp_async4(am + k, accept_min + k);
    cp_async4(bt + k, band_tab + k);
  }
  cp_async_wait_all();
  __syncthreads();
  pitch_rows(sm + st.flat_a, lead_a, LA, rows, sa, pa);
  pitch_rows(sm + st.flat_b, lead_b, LB, rows, sb, pb);
  __syncthreads();
  if (tid >= rows) return;

  // per-pair geometry (seq_aligner.h:92-107), original orientation
  const bool cond = lb >= la;
  const int min_len = cond ? la : lb;
  const int md = bt[clampi(min_len, 0, tab_len)];
  const int len_a = cond ? la : min(la, lb + md);
  const int len_b = cond ? min(lb, la + md) : lb;
  const bool ok_size = (len_a < maxn + maxm) && (md < maxm) && (md <= w_max) &&
                       (len_a <= la_max);

  int accept = 0, cost = INF, matlen_a = 0, matlen_b = 0, diag_cost = -1, dp_rows = 0;

  if (ok_size) {
    // transpose normalization: the kernel always runs n <= m
    const bool swap = len_a > len_b;
    const int n = min(len_a, len_b);
    const int m = max(len_a, len_b);
    const uint8_t* ra = sa + tid * pa;
    const uint8_t* rb = sb + tid * pb;
    const uint8_t* ka = swap ? rb : ra;  // column sequence, n codes
    const uint8_t* kb = swap ? ra : rb;  // row sequence, m codes
    // reads past a row's width clamp to its last code, as align/scan.py's clip
    const int ka_last = (swap ? LB : LA) - 1;
    const int kb_last = (swap ? LA : LB) - 1;

    // Column 1's letter windows (t0 = -md): the row's codes t < 128 as letter
    // vectors, t < m only, then shifted up by md
    Bits128 w0{0, 0}, w1{0, 0}, w2{0, 0}, w3{0, 0};
    const int lim = min(min(m, kb_last + 1), 128);  // codes read from the row
    const uint32_t* kw = reinterpret_cast<const uint32_t*>(kb);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      // four codes; words past the row (inside the staged rows or the pad
      // after them) are masked off below
      const uint32_t x = kw[k];
      const uint32_t lo = x & 0x01010101u, hi = (x >> 1) & 0x01010101u;
      const int sh = 4 * (k & 15);
      uint64_t& d0 = k < 16 ? w0.lo : w0.hi;
      uint64_t& d1 = k < 16 ? w1.lo : w1.hi;
      uint64_t& d2 = k < 16 ? w2.lo : w2.hi;
      uint64_t& d3 = k < 16 ? w3.lo : w3.hi;
      d0 |= nibble(~(lo | hi) & 0x01010101u) << sh;
      d1 |= nibble(lo & ~hi) << sh;
      d2 |= nibble(~lo & hi) << sh;
      d3 |= nibble(lo & hi) << sh;
    }
    {
      const Bits128 keep = low_bits(lim);
      // codes past the row's width repeat its last code, up to m
      const Bits128 past = low_bits(min(m, 128)), before = low_bits(min(kb_last + 1, 128));
      const Bits128 tail{past.lo & ~before.lo, past.hi & ~before.hi}, none{0, 0};
      const int c_last = kb[max(kb_last, 0)] & 3;
      first_window(w0, keep, c_last == 0 ? tail : none, md);
      first_window(w1, keep, c_last == 1 ? tail : none, md);
      first_window(w2, keep, c_last == 2 ? tail : none, md);
      first_window(w3, keep, c_last == 3 ? tail : none, md);
    }

    // the stripe, S = 2md + 1 <= 127 bits: word 1 is live when S > 64
    const int S = 2 * md + 1;
    const uint64_t lastmask = (1ull << (S & 63)) - 1ull;  // S is odd: never a multiple of 64
    const uint64_t mask0 = S > 64 ? ~0ull : lastmask;
    const uint64_t mask1 = S > 64 ? lastmask : 0ull;
    const uint64_t top = 1ull << ((S - 1) & 63);
    const uint64_t top0 = S > 64 ? 0ull : top;
    const uint64_t top1 = S > 64 ? top : 0ull;
    const uint64_t hbit = md >= 1 ? 1ull << ((md - 1) & 63) : 0ull;  // centre of Ph/Mh
    const uint64_t vbit = 1ull << md;                                // centre of VP/VN
    uint64_t vp0 = mask0, vp1 = mask1, vn0 = 0ull, vn1 = 0ull;  // column 0: every delta +1
    uint64_t bb = md >= 1 ? 1ull << ((md - 1) & 63) : 0ull;  // border row j = 0 of column 1

    int Sc = 0;       // D(i, i) of the last column tested
    int pending = 0;  // dh + dv of the column not yet tested
    bool failed = false;
    int fail_i = 0;
    // codes read one column ahead: the column's letter and the row code the
    // windows take after it (4: none, past m)
    int c = ka[0] & 3;
    int t_in = 128 - md;
    int c_in = t_in < m ? kb[min(t_in, kb_last)] & 3 : 4;
    for (int i = 1; i <= n; ++i) {
      const uint64_t pm0 = pick(c, w0.lo, w1.lo, w2.lo, w3.lo) & mask0;
      const uint64_t pm1 = pick(c, w0.hi, w1.hi, w2.hi, w3.hi) & mask1;
      slide(w0, c_in == 0);
      slide(w1, c_in == 1);
      slide(w2, c_in == 2);
      slide(w3, c_in == 3);
      c = ka[min(i, ka_last)] & 3;
      ++t_in;
      c_in = t_in < m ? kb[min(t_in, kb_last)] & 3 : 4;
      const int thr = et[i - 1];

      // previous column re-aligned one stripe up; the entering row pretends
      // VP=1 (VP, VN and the top bit lie inside the masks: no mask needed)
      const uint64_t vpp0 = (vp0 >> 1) | (vp1 << 63) | top0;
      const uint64_t vpp1 = (vp1 >> 1) | top1;
      const uint64_t vnp0 = (vn0 >> 1) | (vn1 << 63);
      const uint64_t vnp1 = vn1 >> 1;
      // Myers addition over both words: one 128-bit add, the carry in the
      // adder (its bits past the stripe reach only Xh, and Ph and Mh below
      // are masked or taken with VPp)
      const uint64_t x0 = pm0 & vpp0, x1 = pm1 & vpp1;
      const unsigned __int128 sum = ((((unsigned __int128)x1) << 64) | x0) +
                                    ((((unsigned __int128)vpp1) << 64) | vpp0);
      const uint64_t xh0 = ((uint64_t)sum ^ vpp0) | pm0;
      const uint64_t xh1 = ((uint64_t)(sum >> 64) ^ vpp1) | pm1;
      // horizontal deltas; the border row (while i <= md) is +1
      const uint64_t ph0 = ((vnp0 | ~(xh0 | vpp0)) & mask0) | bb, mh0 = vpp0 & xh0 & ~bb;
      const uint64_t ph1 = (vnp1 | ~(xh1 | vpp1)) & mask1, mh1 = vpp1 & xh1;
      bb >>= 1;
      const uint64_t phs0 = (ph0 << 1) & mask0, mhs0 = (mh0 << 1) & mask0;
      const uint64_t phs1 = ((ph1 << 1) | (ph0 >> 63)) & mask1;
      const uint64_t mhs1 = ((mh1 << 1) | (mh0 >> 63)) & mask1;
      const uint64_t xv0 = pm0 | vnp0, xv1 = pm1 | vnp1;
      vp0 = (mhs0 | ~(xv0 | phs0)) & mask0;
      vn0 = phs0 & xv0;
      vp1 = (mhs1 | ~(xv1 | phs1)) & mask1;
      vn1 = phs1 & xv1;
      // early failure (seq_aligner.h:185-187) of column i - 1, tested after
      // column i's step so that the test is off the chain (a column computed
      // past a failure changes no output); i <= n <= m always holds here
      Sc += pending;
      if (i > 11 && Sc > thr) {
        failed = true;
        fail_i = i - 1;
        break;
      }
      pending = (int)((ph0 & hbit) != 0) - (int)((mh0 & hbit) != 0) + (int)((vp0 & vbit) != 0) -
                (int)((vn0 & vbit) != 0);
    }
    if (!failed) {  // the last column's test
      Sc += pending;
      if (n > 10 && Sc > et[n]) {
        failed = true;
        fail_i = n;
      }
    }

    if (!failed && n >= 1) {
      // far-row goal: D(n, j) for j in [n, m] is Sc plus the (VP - VN) bits
      // md+1 .. j-n+md, all inside bits [md+1, 2md]: the two words shifted
      // right by md + 1 hold them in one; first minimum wins
      const uint64_t dp = (((vp0 >> md) | ((vp1 << 1) << (63 - md))) >> 1) | ((vp1 >> md) << 63);
      const uint64_t dn = (((vn0 >> md) | ((vn1 << 1) << (63 - md))) >> 1) | ((vn1 >> md) << 63);
      int val = Sc, best = Sc, best_j = n;
      for (int k = 0; k < m - n; ++k) {
        val += (int)((dp >> k) & 1ull) - (int)((dn >> k) & 1ull);
        if (val < best) {
          best = val;
          best_j = n + 1 + k;
        }
      }
      const int ma = swap ? best_j : n;
      const int mb = swap ? n : best_j;
      if (mb >= am[clampi(len_b, 0, tab_len)] && best < INF) {
        accept = 1;
        cost = best;
        matlen_a = ma;
        matlen_b = mb;
        diag_cost = swap ? -1 : Sc;
      }
    }
    // reference-equivalent rows (align/scan.py): abort row, else len_a
    dp_rows = failed ? fail_i : len_a;
  }

  out[0 * B + q] = accept;
  out[1 * B + q] = cost;
  out[2 * B + q] = matlen_a;
  out[3 * B + q] = matlen_b;
  out[4 * B + q] = diag_cost;
  out[5 * B + q] = dp_rows;
}

constexpr int kWarpsPerBlock = 4;

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

cudaError_t launch_thread(const uint8_t* a, int LA, const uint8_t* b, int LB,
                          const int* la, const int* lb, int B,
                          const int* early_thr, const int* accept_min, const int* band_tab,
                          int tab_len, int la_max, int w_max, int maxn, int maxm,
                          int pairs, int* out, cudaStream_t stream) {
  if (pairs < 1 || pairs > kMaxThreadPairs) return cudaErrorInvalidValue;
  const size_t smem = thread_stage(LA, LB, tab_len, pairs).total;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bitwave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int grid = (B + pairs - 1) / pairs;
  bitwave_kernel<<<grid, pairs, smem, stream>>>(a, LA, b, LB, la, lb, B, early_thr, accept_min,
                                                band_tab, tab_len, la_max, w_max, maxn, maxm,
                                                out);
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
                          int maxn, int maxm, void* peq, int PW, int path, int pairs,
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
  // path 2: one warp per pair, ceil(words / 32) words a lane, the PEQ in
  // `peq` when given, else in shared memory; path 1: one thread per pair,
  // `pairs` a block, no PEQ scratch
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
  if (path != 1 || PQ != nullptr || words > 2) return (int)cudaErrorInvalidValue;
  return (int)launch_thread(A, LA, Bm, LB, LAv, LBv, B, ET, AM, BT, tab_len, la_max, w_max,
                            maxn, maxm, pairs, O, st);
}

// Bytes of shared memory a thread-path block of `pairs` pairs takes (the
// wrapper sends launches whose rows do not fit to the warp path).
extern "C" long long pb_bitwave_thread_smem(int LA, int LB, int tab_len, int pairs) {
  return (long long)pbt::thread_stage(LA, LB, tab_len, pairs).total;
}

extern "C" const char* pb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
