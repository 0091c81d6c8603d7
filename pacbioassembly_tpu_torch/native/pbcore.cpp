// pbcore — native host core for pacbioassembly_tpu (port's copy).
//
// Provides the sequential-parity banded edit-distance aligner and the
// binary record-file scanner, exposed through a C ABI consumed via ctypes
// (native/pbcore.py). This is a ground-up implementation of the semantics
// documented in SURVEY.md (reference: src/seq_aligner.h, src/spaced_seed.cpp);
// the architecture is different from the reference: a heap-grown flat arena
// instead of a ~1.25 GB statically-sized template matrix, iterative instead
// of recursive traceback, and code arrays (0..3) instead of ASCII text.
//
// Build: native/pbcore.py builds it at first use into
// pacbioassembly_tpu_torch/build/libpbcore.so.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr int32_t kInf = INT32_C(1) << 30;
constexpr uint8_t kParNone = 0;
constexpr uint8_t kParMatch = 1;
constexpr uint8_t kParInsert = 2;
constexpr uint8_t kParDelete = 3;

// Reusable per-thread scratch so repeated align calls do not churn the heap.
struct Arena {
  std::vector<int32_t> row_prev;
  std::vector<int32_t> row_cur;
  std::vector<int32_t> col_costs;
  std::vector<uint8_t> parents;  // (len_a+1) x stripe_width
  std::vector<uint8_t> bpad;     // b copy with SIMD overrun padding
};

thread_local Arena g_arena;

struct BandParams {
  int len_a;
  int len_b;
  int max_dst;
  bool ok;
};

// Band geometry: longer side clamped to shorter + max_dst,
// max_dst = 1 + floor(min_len * ratio).
BandParams band_params(int la, int lb, double ratio, int maxn, int maxm) {
  BandParams p;
  if (lb >= la) {
    p.len_a = la;
    p.max_dst = 1 + static_cast<int>(la * ratio);
    p.len_b = std::min(lb, p.len_a + p.max_dst);
  } else {
    p.len_b = lb;
    p.max_dst = 1 + static_cast<int>(lb * ratio);
    p.len_a = std::min(la, p.len_b + p.max_dst);
  }
  p.ok = !(p.len_a >= maxn + maxm || p.max_dst >= maxm);
  return p;
}

#if defined(__AVX2__)

// Lane-crossing left shift of x by N int32 positions, filling vacated
// low lanes with `inf` (used by the in-vector prefix-min).
template <int N>
static inline __m256i shl_lanes_inf(__m256i x, __m256i inf) {
  const __m256i idx = _mm256_setr_epi32(
      (0 - N) & 7, (1 - N) & 7, (2 - N) & 7, (3 - N) & 7,
      (4 - N) & 7, (5 - N) & 7, (6 - N) & 7, (7 - N) & 7);
  const __m256i lanes = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
  __m256i sh = _mm256_permutevar8x32_epi32(x, idx);
  __m256i low = _mm256_cmpgt_epi32(_mm256_set1_epi32(N), lanes);
  return _mm256_blendv_epi8(sh, inf, low);
}

// Vectorized DP row over the live band window [ks..k_hi] (j >= 1 cells).
//
// Exactly the scalar recurrence, reformulated so the serial in-row
// INSERT chain cost[k] = min(cand[k], cost[k-1]+1) becomes
//   cost[k] = k + min_{k' <= k} (cand[k'] - k')          (expansion)
// i.e. a prefix-min in the t = cand - k domain, where
// cand[k] = min(diag, up) and the chain is seeded with `t_seed` (the
// j == 0 border cell when the window touches column 0, else +inf).
// Parents follow from priority equality checks — cost == diag -> MATCH,
// else cost == cost[k-1]+1 (<=> runm[k] == runm[k-1]) -> INSERT, else
// DELETE — which reproduces the reference's strict-< tie order
// MATCH > INSERT > DELETE (seq_aligner.h:161-173) for every reachable
// cell: cost==diag can only hold when neither alternative was strictly
// smaller, and cost==left+1 when INSERT won or tied DELETE.
static inline void dp_row_avx2(const int32_t* prev, int32_t* cur,
                               uint8_t* par_row, const uint8_t* bpad,
                               int ks, int k_hi, int boff, int a_code,
                               int32_t t_seed) {
  const __m256i vinf = _mm256_set1_epi32(kInf);
  const __m256i vone = _mm256_set1_epi32(1);
  const __m256i vac = _mm256_set1_epi32(a_code);
  const __m256i viota = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
  const __m256i bc7 = _mm256_set1_epi32(7);
  __m256i carry = _mm256_set1_epi32(t_seed);
  const __m256i vM = _mm256_set1_epi32(kParMatch);
  const __m256i vI = _mm256_set1_epi32(kParInsert);
  const __m256i vD = _mm256_set1_epi32(kParDelete);
  for (int k = ks; k <= k_hi; k += 8) {
    __m256i pv = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(prev + k));
    __m256i pu = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(prev + k + 1));
    __m256i bcode = _mm256_cvtepu8_epi32(
        _mm_loadl_epi64(reinterpret_cast<const __m128i*>(bpad + k + boff)));
    __m256i eq = _mm256_cmpeq_epi32(bcode, vac);
    __m256i diag = _mm256_add_epi32(pv, _mm256_andnot_si256(eq, vone));
    __m256i up = _mm256_add_epi32(pu, vone);
    __m256i cand = _mm256_min_epi32(diag, up);
    __m256i kv = _mm256_add_epi32(_mm256_set1_epi32(k), viota);
    __m256i t = _mm256_sub_epi32(cand, kv);
    // in-vector prefix-min, then fold in the running carry
    __m256i p1 = _mm256_min_epi32(t, shl_lanes_inf<1>(t, vinf));
    __m256i p2 = _mm256_min_epi32(p1, shl_lanes_inf<2>(p1, vinf));
    __m256i p4 = _mm256_min_epi32(p2, shl_lanes_inf<4>(p2, vinf));
    __m256i runm = _mm256_min_epi32(p4, carry);
    // runm[k-1] per lane: shifted prefix with the carry in lane 0
    __m256i runp = _mm256_min_epi32(shl_lanes_inf<1>(p4, vinf), carry);
    carry = _mm256_permutevar8x32_epi32(runm, bc7);  // broadcast lane 7
    __m256i cost = _mm256_add_epi32(runm, kv);
    // parents: M if cost==diag, else I if runm==runm[k-1], else D
    __m256i isM = _mm256_cmpeq_epi32(cost, diag);
    __m256i isI = _mm256_cmpeq_epi32(runm, runp);
    __m256i par = _mm256_blendv_epi8(vD, vI, isI);
    par = _mm256_blendv_epi8(par, vM, isM);
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(cur + k), cost);
    // pack 8 x int32 parents -> 8 bytes
    __m128i lo = _mm256_castsi256_si128(par);
    __m128i hi = _mm256_extracti128_si256(par, 1);
    __m128i p16 = _mm_packs_epi32(lo, hi);
    __m128i p8 = _mm_packus_epi16(p16, p16);
    _mm_storel_epi64(reinterpret_cast<__m128i*>(par_row + k), p8);
  }
}
#endif  // __AVX2__

static int pb_align_core(const uint8_t* a, int la, const uint8_t* b, int lb,
                         double ratio, int maxn, int maxm,
                         int32_t* out_meta, uint8_t* out_ops,
                         uint8_t* out_vals, int64_t out_cap, bool use_simd) {
  if (la <= 0 || lb <= 0) return 0;
  const BandParams p = band_params(la, lb, ratio, maxn, maxm);
  if (!p.ok) return 0;
  const int len_a = p.len_a, len_b = p.len_b, max_dst = p.max_dst;
  const int stripe = 2 * max_dst + 1;
  const int pad = 16;  // SIMD overrun headroom on every row buffer

  Arena& ar = g_arena;
  try {
    ar.row_prev.assign(stripe + pad, kInf);
    ar.row_cur.assign(stripe + pad, kInf);
    ar.col_costs.assign(len_a + 1, kInf);
    // parents rows are fully written inside the live window before any
    // traceback read (the walk provably stays in-window), so only row 0
    // needs a defined state; skipping the full clear saves a multi-MB
    // memset per call
    ar.parents.resize(static_cast<size_t>(len_a + 1) * stripe + pad);
    std::fill(ar.parents.begin(), ar.parents.begin() + stripe, kParNone);
#if defined(__AVX2__)
    if (use_simd) {
      ar.bpad.resize(static_cast<size_t>(len_b) + 2 * pad);
      std::memcpy(ar.bpad.data(), b, len_b);
      std::memset(ar.bpad.data() + len_b, 0xFF, 2 * pad);
    }
#endif
  } catch (...) {
    return -2;
  }
  int32_t* prev = ar.row_prev.data();
  int32_t* cur = ar.row_cur.data();
  uint8_t* parents = ar.parents.data();

  // Row 0 borders: cost(0, j) = j, parent INSERT for j >= 1.
  for (int k = max_dst; k < stripe; ++k) {
    const int j = k - max_dst;
    if (j > len_b) break;
    prev[k] = j;
    if (j >= 1) parents[k] = kParInsert;
  }
  if (len_b <= max_dst) ar.col_costs[0] = len_b;

  for (int i = 1; i <= len_a; ++i) {
    uint8_t* par_row = parents + static_cast<size_t>(i) * stripe;
    const int a_code = a[i - 1];
    const int j_lo = std::max(0, i - max_dst);
    const int j_hi = std::min(len_b, i + max_dst);
    const int k_lo = j_lo - i + max_dst;
    const int k_hi = j_hi - i + max_dst;

    // Reset the live window of cur (plus SIMD pad).
    std::fill(cur, cur + stripe + pad, kInf);

#if defined(__AVX2__)
    if (use_simd) {
      int ks = k_lo;
      int32_t t_seed = kInf;
      if (j_lo == 0) {
        // column-0 border cell, then seed the INSERT chain from it
        cur[k_lo] = i;
        par_row[k_lo] = kParDelete;
        t_seed = i - k_lo;
        ks = k_lo + 1;
      }
      if (ks <= k_hi) {
        // b index for stripe k is j-1 = k + (i - max_dst) - 1
        dp_row_avx2(prev, cur, par_row, ar.bpad.data(),
                    ks, k_hi, i - max_dst - 1, a_code, t_seed);
        // overrun cells past k_hi were written with garbage costs; they
        // must read as kInf next row (the pad region is read as prev[k+1])
        for (int k = k_hi + 1; k < std::min(k_hi + 9, stripe + pad); ++k)
          cur[k] = kInf;
      }
    } else
#endif
    {
      int32_t running = kInf;  // best INSERT-chain source so far: cur[k-1]
      for (int k = k_lo, j = j_lo; j <= j_hi; ++k, ++j) {
        int32_t cost;
        uint8_t par;
        if (j == 0) {
          cost = i;  // column-0 border
          par = kParDelete;
        } else {
          const int32_t diag = prev[k] + (b[j - 1] != a_code ? 1 : 0);
          const int32_t up = (k + 1 < stripe) ? prev[k + 1] + 1 : kInf;
          const int32_t left = (running < kInf) ? running + 1 : kInf;
          cost = diag;
          par = kParMatch;
          if (left < cost) { cost = left; par = kParInsert; }
          if (up < cost) { cost = up; par = kParDelete; }
        }
        cur[k] = cost;
        par_row[k] = par;
        running = cost;
      }
    }

    const int k_col = len_b - i + max_dst;
    if (k_col >= 0 && k_col < stripe) ar.col_costs[i] = cur[k_col];

    // Early failure on the main diagonal (skip rows past len_b, where the
    // reference reads stale memory — see SURVEY.md §7).
    if (i > 10 && i <= len_b && cur[max_dst] > i * ratio) return 0;

    std::swap(prev, cur);
  }
  // after the loop `prev` holds row len_a
  const int32_t diag_cost = (len_a <= len_b) ? prev[max_dst] : -1;

  int matlen_a, matlen_b;
  int32_t final_cost;
  if (len_a > len_b) {
    matlen_b = len_b;
    matlen_a = len_b;
    final_cost = ar.col_costs[len_b];
    for (int i = len_b + 1; i <= len_a; ++i) {
      if (ar.col_costs[i] < final_cost) {
        final_cost = ar.col_costs[i];
        matlen_a = i;
      }
    }
  } else {
    matlen_a = len_a;
    matlen_b = len_a;
    final_cost = prev[max_dst];
    for (int j = len_a + 1; j <= len_b; ++j) {
      const int32_t c = prev[j - len_a + max_dst];
      if (c < final_cost) {
        final_cost = c;
        matlen_b = j;
      }
    }
  }
  if (matlen_b < len_b * (1.0 - ratio)) return 0;

  // Iterative traceback; emit reversed, then flip in place.
  int64_t n = 0;
  {
    int i = matlen_a, j = matlen_b;
    for (;;) {
      const uint8_t par = parents[static_cast<size_t>(i) * stripe + (j - i + max_dst)];
      if (par == kParNone) break;
      if (n >= out_cap) return -1;
      if (par == kParMatch) {
        out_ops[n] = kParMatch;
        out_vals[n] = b[j - 1];
        --i; --j;
      } else if (par == kParInsert) {
        out_ops[n] = kParInsert;
        out_vals[n] = b[j - 1];
        --j;
      } else {
        out_ops[n] = kParDelete;
        out_vals[n] = 0;
        --i;
      }
      ++n;
    }
    std::reverse(out_ops, out_ops + n);
    std::reverse(out_vals, out_vals + n);
  }

  out_meta[0] = matlen_a;
  out_meta[1] = matlen_b;
  out_meta[2] = final_cost;
  out_meta[3] = static_cast<int32_t>(n);
  out_meta[4] = diag_cost;
  return 1;
}

}  // namespace

// Banded edit-distance alignment of code arrays a (len la) and b (len lb).
//
// out_meta (int32[5]): {matlen_a, matlen_b, final_cost, nedit, diag_cost}
// where diag_cost is cell (len_a, len_a) of the final row, or -1 when
// len_a > len_b.
// out_ops/out_vals (uint8[out_cap]): edit stream transforming a into b;
// vals carries the b-side code for MATCH/INSERT edits.
//
// Returns: 1 success, 0 alignment rejected, -1 edit buffer too small,
// -2 allocation failure.
//
// Uses the AVX2 row kernel when compiled in (identical outputs — the
// scalar row stays available as pb_align_scalar and is differential-
// fuzzed against the SIMD path by tests/test_aligner.py).
extern "C" int pb_align(const uint8_t* a, int la, const uint8_t* b, int lb,
                        double ratio, int maxn, int maxm,
                        int32_t* out_meta, uint8_t* out_ops,
                        uint8_t* out_vals, int64_t out_cap) {
#if defined(__AVX2__)
  const bool simd = true;
#else
  const bool simd = false;
#endif
  return pb_align_core(a, la, b, lb, ratio, maxn, maxm, out_meta, out_ops,
                       out_vals, out_cap, simd);
}

// Reference scalar row loop (the form differential-tested against
// align/banded.py since r1); kept exported so the SIMD path can be
// fuzzed against it in-process.
extern "C" int pb_align_scalar(const uint8_t* a, int la, const uint8_t* b,
                               int lb, double ratio, int maxn, int maxm,
                               int32_t* out_meta, uint8_t* out_ops,
                               uint8_t* out_vals, int64_t out_cap) {
  return pb_align_core(a, la, b, lb, ratio, maxn, maxm, out_meta, out_ops,
                       out_vals, out_cap, false);
}

// ---------------------------------------------------------------------------
// Quirk-parity aligner: byte-layout emulation of the reference's persistent
// DP matrix.
//
// The reference keeps ONE seq_aligner instance per process whose
// `state mat[MAXN][MAXM]` ({int cost; int parent} pairs) is never cleared
// between alignments (seq_aligner.h:81). Its early-failure test reads
// cost(i, i) for every row i > 10 — including rows i > len_b whose cells
// were never written by the CURRENT alignment, so the value read is
// whatever an EARLIER alignment left at that address (undefined behavior
// that changes which alignments fail). Additionally, for max_dst >= MAXM/2
// the stripe index j-i+max_dst exceeds MAXM and writes alias into the next
// row (seq_aligner.h:104 guards only max_dst >= MAXM).
//
// pb_align_quirk reproduces both by running the DP on a persistent flat
// {cost, parent} array addressed exactly like the reference's 2-D matrix
// (flat index i*MAXM + k, pairs interleaved), freshly-zero on first use
// (operator new of a GB-scale block yields zero pages). Same outputs as
// pb_align plus bit-parity on the UB-dependent decisions for the geometry
// the assembly driver can produce (len_a < MAXN always holds because reads
// are < MAX_READ_LEN).
// ---------------------------------------------------------------------------

namespace {

struct QuirkArena {
  std::vector<int32_t> flat;  // (rows * maxm) {cost, parent} pairs
  int64_t rows = 0;
  int maxm = 0;

  void ensure(int64_t need_rows, int m) {
    if (m != maxm) {
      flat.clear();
      rows = 0;
      maxm = m;
    }
    if (need_rows > rows) {
      flat.resize(static_cast<size_t>(need_rows) * m * 2, 0);
      rows = need_rows;
    }
  }
  int32_t* cell(int64_t i, int64_t k) {
    return flat.data() + (i * maxm + k) * 2;
  }
};

thread_local QuirkArena g_quirk;

}  // namespace

extern "C" int pb_align_quirk(const uint8_t* a, int la, const uint8_t* b, int lb,
                              double ratio, int maxn, int maxm,
                              int32_t* out_meta, uint8_t* out_ops,
                              uint8_t* out_vals, int64_t out_cap) {
  if (la <= 0 || lb <= 0) return 0;
  const BandParams p = band_params(la, lb, ratio, maxn, maxm);
  if (!p.ok) return 0;
  const int len_a = p.len_a, len_b = p.len_b, md = p.max_dst;

  QuirkArena& q = g_quirk;
  // stripe index can reach 2*md, spilling (2*md - maxm)/maxm + 1 rows past
  // row len_a in flat addressing — allocate headroom for the alias region
  q.ensure(static_cast<int64_t>(len_a) + 4 + (2 * md) / maxm, maxm);

  enum { M = 1, I = 2, D = 3 };
  auto get = [&](int64_t i, int64_t j) { return q.cell(i, j - i + md); };

  // init_cell (seq_aligner.h:139-150), written every call
  for (int i = 1; i <= md; ++i) {
    int32_t* c = get(i, 0);
    c[0] = i;
    c[1] = D;
  }
  for (int j = 1; j <= md; ++j) {
    int32_t* c = get(0, j);
    c[0] = j;
    c[1] = I;
  }
  get(0, 0)[0] = 0;
  get(0, 0)[1] = 0;

  // search (seq_aligner.h:151-190) — reads and writes through the
  // persistent flat matrix, early-failure test included verbatim
  bool searched_ok = true;
  for (int i = 1; i <= len_a && searched_ok; ++i) {
    const int ac = a[i - 1];
    const int beg = std::max(1, i - md);
    const int end = std::min(len_b, i + md);
    for (int j = beg; j <= end; ++j) {
      int32_t t;
      int32_t cost = get(i - 1, j - 1)[0] + (b[j - 1] != ac ? 1 : 0);
      int32_t src = M;
      if (i - j < md && (t = get(i, j - 1)[0] + 1) < cost) {
        cost = t;
        src = I;
      }
      if (j - i < md && (t = get(i - 1, j)[0] + 1) < cost) {
        cost = t;
        src = D;
      }
      int32_t* c = get(i, j);
      c[0] = cost;
      c[1] = src;
    }
    if (i > 10 && get(i, i)[0] > i * ratio) {
      searched_ok = false;  // the UB-faithful early failure
    }
  }
  if (!searched_ok) return 0;

  // goal_cell (seq_aligner.h:191-213)
  int matlen_a, matlen_b;
  int32_t final_cost;
  if (len_a > len_b) {
    matlen_a = len_b;
    matlen_b = len_b;
    final_cost = get(len_b, len_b)[0];
    for (int i = len_b + 1; i <= len_a; ++i) {
      if (get(i, len_b)[0] < final_cost) {
        final_cost = get(i, len_b)[0];
        matlen_a = i;
      }
    }
  } else {
    matlen_a = len_a;
    matlen_b = len_a;
    final_cost = get(len_a, len_a)[0];
    for (int j = len_a + 1; j <= len_b; ++j) {
      if (get(len_a, j)[0] < final_cost) {
        final_cost = get(len_a, j)[0];
        matlen_b = j;
      }
    }
  }
  if (matlen_b < len_b * (1.0 - ratio)) return 0;

  const int32_t diag_cost = (len_a <= len_b) ? get(len_a, len_a)[0] : -1;

  // find_path (seq_aligner.h:214-233), iterative
  int64_t n = 0;
  {
    int i = matlen_a, j = matlen_b;
    for (;;) {
      const int32_t par = get(i, j)[1];
      if (par != M && par != I && par != D) break;
      if (n >= out_cap) return -1;
      if (par == M) {
        out_ops[n] = M;
        out_vals[n] = b[j - 1];
        --i; --j;
      } else if (par == I) {
        out_ops[n] = I;
        out_vals[n] = b[j - 1];
        --j;
      } else {
        out_ops[n] = D;
        out_vals[n] = 0;
        --i;
      }
      ++n;
    }
    std::reverse(out_ops, out_ops + n);
    std::reverse(out_vals, out_vals + n);
  }

  out_meta[0] = matlen_a;
  out_meta[1] = matlen_b;
  out_meta[2] = final_cost;
  out_meta[3] = static_cast<int32_t>(n);
  out_meta[4] = diag_cost;
  return 1;
}

// Reset the quirk arena to the fresh-process state (zero matrix).
extern "C" void pb_quirk_reset() {
  g_quirk.flat.clear();
  g_quirk.rows = 0;
  g_quirk.maxm = 0;
}

extern "C" {

// Walk the [u32 len][ceil(len/4) bytes] record chain of a file buffer.
// Returns the record count; fills offsets/lengths up to cap entries.
int64_t pb_scan_records(const uint8_t* buf, int64_t nbytes,
                        int64_t* offsets, int64_t* lengths, int64_t cap) {
  int64_t n = 0;
  int64_t off = 0;
  while (off + 4 <= nbytes) {
    uint32_t ln;
    std::memcpy(&ln, buf + off, 4);
    if (n < cap) {
      offsets[n] = off;
      lengths[n] = ln;
    }
    ++n;
    off += 4 + (static_cast<int64_t>(ln) + 3) / 4;
  }
  return n;
}

// Pack codes (0..3) four-per-byte, first base in bits 7-6.
void pb_pack(const uint8_t* codes, int64_t n, uint8_t* out) {
  int64_t full = n / 4;
  for (int64_t q = 0; q < full; ++q) {
    const uint8_t* c = codes + q * 4;
    out[q] = static_cast<uint8_t>((c[0] << 6) | (c[1] << 4) | (c[2] << 2) | c[3]);
  }
  if (n % 4) {
    uint8_t v = 0;
    for (int64_t t = full * 4, s = 6; t < n; ++t, s -= 2)
      v |= static_cast<uint8_t>(codes[t] << s);
    out[full] = v;
  }
}

// Unpack bytes into n codes.
void pb_unpack(const uint8_t* packed, int64_t n, uint8_t* out) {
  for (int64_t t = 0; t < n; ++t)
    out[t] = (packed[t >> 2] >> ((3 - (t & 3)) << 1)) & 0x3;
}

}  // extern "C"
