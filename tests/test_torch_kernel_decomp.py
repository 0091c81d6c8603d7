"""Numpy models of how the CUDA kernels K2 (csrc/tbwave.cu), K1's warp and
thread paths (csrc/bitwave.cu), K3 (csrc/wavefront.cu) and W
(csrc/walk.cu) split their work across lanes, threads and warps, held
against the port's plain versions, which the other
tests hold equal to the JAX package. They rehearse the kernels' logic where
no card exists; the kernels themselves are held against the same plain
versions on the card (tests/test_torch_gpu.py, chip_smoke.py).

  (a) K2: each thread owns L consecutive band lanes; the in-row INSERT chain
      is a prefix minimum of u = D - k, serial over a thread's lanes, a
      shuffle scan over 32 threads and the warps' totals, with non-live
      cells forced to INF; the parents come from equalities of the running
      minimum. The model gives the plain parent plane bit for bit.
  (b) K1: the ballot carry-lookahead across 32 lanes of words gives the
      ripple's sum and carry-out.
  (c) K1: the word-split Myers column step with that carry, the shuffled
      shifts and dh/dv, and the warp's far-row argmin give
      align/scan.py::batch_score's fields.
  (d) K3 (csrc/wavefront.cu): the row in L-lane runs over the pair's own
      band, the live-cell fix-up only in threads at the live run's edges,
      the prefix minimum of (a), and the early-failure and far-column
      cells read from the slots their owners publish give
      align/scan.py::batch_score's six fields, at L = 4, 8, 16 on the
      block path and on the warp path (a warp per pair); the kernel is
      built at warp 4, block 8 and block 16.
  (e) W (csrc/walk.cu): the walk a word at a time, each step taking the
      run of MATCH parents down its word, through 128-lane tiles of the
      row blocks copied into a ring ahead of the walk and loaded at once
      when the cell leaves its tile, gives
      align/tbwave.py::walk_parents_plain's ops, vals and nedit.
  (f) K1's thread path (bitwave_kernel): a two-word register stripe, a
      sliding 128-bit window per letter in place of the PEQ (column 1's
      from the row's first 128 bytes at its shared-memory pitch, four a
      32-bit word, masked past the row), a column's early-failure test run
      after the next column's step, and the far-row goal from the two
      words shifted into one: every window equals the full PEQ's at every
      column, and the fields equal align/scan.py::batch_score's.
"""

import numpy as np
import pytest
import torch

from pacbioassembly_tpu_torch.align import scan
from pacbioassembly_tpu_torch.align.tbwave import (
    WALK_RING,
    WALK_TILE,
    _geometry,
    batch_parents,
    batch_parents_plain,
    plane_dims,
    walk_parents_plain,
)
from pacbioassembly_tpu_torch.align.wavefront import BUILDS, launch_shape, shapes
from pacbioassembly_tpu_torch.align.types import DELETE, INSERT, MATCH
from pacbioassembly_tpu_torch.config import Constants

from test_scan import make_cases, pack
from test_torch_tbwave import _multi_block_cases
from torch_parity import (
    PREFILTER,
    WALK_W,
    batch_tensors,
    k1_thread_edge_cases,
    overlap_cases,
    random_cases,
    walk_batch,
    walk_edge_cases,
    zero_band_tables,
)

torch.set_num_threads(1)

INF = scan.INF
SCAN_ID = 1 << 30  # the kernels' identity of the prefix minimum
ALL = np.uint64(0xFFFFFFFFFFFFFFFF)
U64 = np.uint64


# ------------------------------------------------------------------ (a) K2


def _warp_scan_min(x):
    """Inclusive prefix minimum over each warp of 32 threads, as five
    __shfl_up_sync steps: x is (threads,), a multiple of 32."""
    x = x.reshape(-1, 32).copy()
    lane = np.arange(32)
    for off in (1, 2, 4, 8, 16):
        y = np.concatenate([x[:, :off], x[:, :-off]], axis=1)  # shfl_up: lanes < off keep theirs
        x = np.where(lane >= off, np.minimum(x, y), x)
    return x


def parents_model(A, las, Bm, lbs, *, la_max, w_max, ratio, rows_max, L):
    """The parent plane as csrc/tbwave.cu computes it, one pair at a time."""
    B, LA = A.shape
    LB = Bm.shape[1]
    W = w_max
    S, NRB = plane_dims(la_max, w_max, rows_max)
    md_t, la_t, lb_t = _geometry(*(torch.from_numpy(x) for x in (las, lbs)), la_max, LA, LB, ratio)
    out = np.full((B, NRB, S), -1, np.int64)  # every word must be written (int32 bits)
    T = -(-S // (32 * L)) * 32  # threads: ceil(S / L), whole warps
    for q in range(B):
        md, lena, lenb = int(md_t[q]), int(la_t[q]), int(lb_t[q])
        lo, hi = max(0, W - md), min(S - 1, W + md)
        k = lo + np.arange(T * L).reshape(T, L)       # thread t owns row t
        warp = np.arange(T) // 32
        idle = lo + np.arange(T // 32) * 32 * L > hi  # warps past the band
        stage = np.zeros(S, np.int64)
        j0 = k - W
        pr = np.where((k <= hi) & (j0 >= 0) & (j0 <= min(lenb, md)), j0, INF)
        pw = np.zeros((T, L), np.int64)
        first = np.full(T // 32 + 1, INF)
        first[: T // 32][~idle] = pr[::32, 0][~idle]
        nrows = min(lena, NRB * 16)
        for i in range(1, nrows + 1):
            r = (i - 1) & 15
            vlo, vhi = max(lo, W + 1 - i), min(hi, W + lenb - i)
            kbord = W - i if i <= md else -1
            ai = int(A[q, i - 1]) if i - 1 < LA else 0
            # UP source of each thread's last lane: shfl_down, or the next warp's first lane
            nxt = np.concatenate([pr[1:, 0], [INF]])
            nxt[31::32] = first[warp[31::32] + 1]
            valid = (k >= vlo) & (k <= vhi)
            src = np.clip(k + i - W - 1, 0, LB - 1)
            diag = np.where(valid, pr + (Bm[q, src].astype(np.int64) != ai), INF)
            up = np.where(valid, np.concatenate([pr[:, 1:], nxt[:, None]], axis=1) + 1, INF)
            D = np.minimum(diag, up)
            D = np.where(k == kbord, i, D)
            deq = valid & (diag == D)
            u = D - k
            x = _warp_scan_min(u.min(axis=1))
            excl = np.concatenate([np.full((x.shape[0], 1), SCAN_ID), x[:, :-1]], axis=1).ravel()
            tot = x[:, 31]
            carry = np.array([min([SCAN_ID, *tot[:w]]) for w in range(T // 32)])
            run = np.minimum(excl, carry[warp])
            kl = k[:, 0] - 1
            left_live = (kl >= lo) & (((kl >= vlo) & (kl <= vhi)) | (kl == kbord))
            left_run = run.copy()
            for l in range(L):
                run = np.minimum(run, u[:, l])
                border = k[:, l] == kbord
                live = valid[:, l] | border
                par = np.full(T, DELETE)
                par = np.where(left_live & (run == left_run), INSERT, par)
                par = np.where(deq[:, l] & (run == u[:, l]), MATCH, par)
                par = np.where(border, DELETE, par)
                par = np.where(live, par, 0)
                pr[:, l] = np.where(live, k[:, l] + run, INF)
                pw[:, l] |= par << (2 * r)
                left_live, left_run = live, run.copy()
            act = np.repeat(~idle, 32)
            first[: T // 32][~idle] = pr[::32, 0][~idle]
            if r == 15 or i == nrows:
                own = (k <= hi) & act[:, None]
                stage[k[own]] = pw[own]
                pw[:] = 0
                out[q, (i - 1) >> 4] = stage
        out[q, (nrows + 15) >> 4 :] = 0
    return out


def _k2_cases():
    """(cases, LA, LB, rows_max): tests/test_torch_tbwave.py's pairs, its
    multi-block pairs, and the edges: a long identical pair (its md is the
    launch's band), len_b < md (an empty b), all-padding pairs (length 0)
    and the engine's pad rows (la = lb = 1); and rows cut at the plane."""
    rng = np.random.default_rng(33)
    a = rng.integers(0, 4, 80).astype(np.uint8)
    edges = [
        (a, a.copy()),
        (a[:50], np.zeros(0, np.uint8)),                  # len_b = 0 < md = 1
        (np.zeros(0, np.uint8), np.zeros(0, np.uint8)),  # padding
        (a[:1], a[:1]),
    ]
    return [
        (make_cases(rng, 24, max_len=60) + edges, 128, 80, None),
        (_multi_block_cases() + edges, 320, 320, None),
        (_multi_block_cases() + edges, 320, 320, 128),
    ]


def _full_band(las, lbs, ratio):
    """w_max = the largest md of the pairs: the launch's band is reached."""
    return int(max(1 + np.floor(min(x, y) * ratio) for x, y in zip(las, lbs)))


@pytest.mark.parametrize("L", [1, 2, 4, 8, 16])  # the kernel's 4, 8, 16 and two degenerate
@pytest.mark.parametrize("case", range(3), ids=["tbwave-fixture", "multi-block", "rows-max"])
def test_k2_lane_warp_block_prefix_gives_the_plain_plane(case, L):
    cases, LA, LB, rows_max = _k2_cases()[case]
    A, las, Bm, lbs = pack(cases, LA, LB)
    W = _full_band(las, lbs, 0.3)
    kw = dict(la_max=LA, w_max=W, ratio=0.3, rows_max=rows_max)
    plain, md, _ = batch_parents_plain(*batch_tensors(A, las, Bm, lbs), **kw)
    assert int(md.max()) == W  # the launch's full band is reached
    model = parents_model(A, las, Bm, lbs, L=L, **kw)
    np.testing.assert_array_equal(model.astype(np.uint32).view(np.int32), plain.numpy())
    assert (plain.numpy() != 0).any()


# ------------------------------------------------------------- (b) K1 carry


def lookahead_carries(gen, prop):
    """Carry into each of 32 lanes from their generate / propagate bits, as
    the kernel forms it: bit x of (g + (g | p)) ^ p over two ballots."""
    g = sum(int(v) << x for x, v in enumerate(gen))
    p = sum(int(v) << x for x, v in enumerate(prop))
    t = ((g + (g | p)) & 0xFFFFFFFF) ^ p
    return np.array([(t >> x) & 1 for x in range(32)], np.uint64), (g + (g | p)) >> 32


def lookahead_add(x, y):
    """(32, WPL) words + words with the kernel's carry-lookahead; returns
    (sum words, carry out of the last word)."""
    with np.errstate(over="ignore"):
        s1 = x + y
    gen, prop = s1 < x, s1 == ALL
    wpl = x.shape[1]
    lane_gen = np.zeros(32, bool)
    for u in range(wpl):
        lane_gen = gen[:, u] | (prop[:, u] & lane_gen)
    cin, cout = lookahead_carries(lane_gen, prop.all(axis=1))
    out = np.zeros_like(x)
    c = cin
    for u in range(wpl):
        with np.errstate(over="ignore"):
            out[:, u] = s1[:, u] + c
        c = (gen[:, u] | (prop[:, u] & (c == 1))).astype(np.uint64)
    return out, int(c[31])


def _as_int(words):
    return sum(int(w) << (64 * i) for i, w in enumerate(words.ravel()))


@pytest.mark.parametrize("wpl", [1, 2, 3, 6])
def test_k1_ballot_lookahead_equals_ripple(wpl):
    rng = np.random.default_rng(wpl)
    nbits = 64 * 32 * wpl

    def words(v):
        return np.array([(v >> (64 * i)) & (2**64 - 1) for i in range(32 * wpl)],
                        np.uint64).reshape(32, wpl)

    trials = [rng.integers(0, 2**63, (2, 32, wpl), dtype=np.uint64) * U64(2)
              + rng.integers(0, 2, (2, 32, wpl), dtype=np.uint64) for _ in range(20)]
    trials = [(t[0], t[1]) for t in trials]
    ones = 2**nbits - 1
    for lo, hi in ((0, nbits), (64, 64 * 20), (60, 64 * 7 + 3), (64 * wpl, 64 * wpl * 31)):
        run = ones >> (nbits - (hi - lo)) << lo            # a run of ones
        trials.append((words(run), words(1 << lo)))        # + 1 at its bottom: carries through it
        trials.append((words(run), words(run)))
        trials.append((words(ones), words(1)))             # carry out of the top
    for x, y in trials:
        got, cout = lookahead_add(x, y)
        want = _as_int(x) + _as_int(y)
        assert _as_int(got) == want & ones
        assert cout == want >> nbits


# ---------------------------------------------------------- (c) K1 warp path


def k1_warp_model(A, las, Bm, lbs, *, la_max, w_max, ratio, wpl,
                  maxn=Constants.ALIGNER_MAXN, maxm=Constants.ALIGNER_MAXM):
    """BatchScores fields as bitwave_warp_kernel computes them: 32 lanes of
    wpl words each, one pair at a time."""
    B, LA = A.shape
    LB = Bm.shape[1]
    tab_len = max(la_max, LB, LA) + 1
    early_thr, accept_min, band_tab = scan._threshold_tables(ratio, tab_len)
    PW = (max(LA, LB) + 63) // 64 + 1
    lane = np.arange(32)
    w = lane[:, None] * wpl + np.arange(wpl)[None, :]
    rows = []
    for q in range(B):
        la, lb = int(las[q]), int(lbs[q])
        cond = lb >= la
        md = int(band_tab[min(max(la if cond else lb, 0), tab_len)])
        len_a = la if cond else min(la, lb + md)
        len_b = min(lb, la + md) if cond else lb
        res = [0, INF, 0, 0, -1, 0]
        if not (len_a < maxn + maxm and md < maxm and md <= w_max and len_a <= la_max):
            rows.append(res)
            continue
        swap = len_a > len_b
        n, m = min(len_a, len_b), max(len_a, len_b)
        ka, kb = (Bm[q], A[q]) if swap else (A[q], Bm[q])
        kb_codes = kb[np.minimum(np.arange(64 * PW), len(kb) - 1)] & 3
        bits = (np.arange(64 * PW) < m)[None, :] & (kb_codes[None, :] == np.arange(4)[:, None])
        peq = (bits.reshape(4, PW, 64).astype(np.uint64) << np.arange(64, dtype=np.uint64)).sum(
            axis=2, dtype=np.uint64)
        S = 2 * md + 1
        nw, topw = (S + 63) >> 6, (S - 1) >> 6
        topbit = U64(1) << U64((S - 1) & 63)
        lastmask = ALL if S & 63 == 0 else (U64(1) << U64(S & 63)) - U64(1)
        cw_h, cb_h, cw_v, cb_v = (md - 1) >> 6, (md - 1) & 63, md >> 6, md & 63
        mask = np.where(w < nw - 1, ALL, np.where(w == nw - 1, lastmask, U64(0)))
        VP, VN = mask.copy(), np.zeros_like(mask)
        Sc, fail_i, pending = 0, 0, 0
        for i in range(1, n + 1):
            P = peq[int(ka[min(i - 1, len(ka) - 1)]) & 3]
            t0, p0 = i - md - 1, md - i
            idx = (t0 >> 6) + lane[:, None] * wpl + np.arange(wpl + 1)[None, :]
            Pw = np.where((idx >= 0) & (idx < PW), P[np.clip(idx, 0, PW - 1)], U64(0))
            rb = t0 & 63
            # bit 0 of the next lane's first words (shfl_down; lane 31 reads 0)
            nb_vp = np.append(VP[1:, 0] & U64(1), U64(0))
            nb_vn = np.append(VN[1:, 0] & U64(1), U64(0))
            vp_next = np.concatenate([VP[:, 1:], nb_vp[:, None]], axis=1)
            vn_next = np.concatenate([VN[:, 1:], nb_vn[:, None]], axis=1)
            VPp = ((VP >> U64(1)) | (vp_next << U64(63)) | np.where(w == topw, topbit, U64(0))) & mask
            VNp = ((VN >> U64(1)) | (vn_next << U64(63))) & mask
            if rb == 0:
                PM = Pw[:, :wpl] & mask
            else:
                PM = ((Pw[:, :wpl] >> U64(rb)) | (Pw[:, 1:] << U64(64 - rb))) & mask
            total, _ = lookahead_add(PM & VPp, VPp)
            Xh = ((total & mask) ^ VPp) | PM
            Ph = (VNp | ~(Xh | VPp)) & mask
            Mh = VPp & Xh
            if p0 >= 0:
                at = w == (p0 >> 6)
                bb = U64(1) << U64(p0 & 63)
                Ph = np.where(at, Ph | bb, Ph)
                Mh = np.where(at, Mh & ~bb, Mh)
            # top bits of the previous lane's last words (shfl_up; lane 0 reads 0)
            ph_in = np.concatenate([[[U64(0)]], (Ph[:-1, -1:] >> U64(63))], axis=0)
            mh_in = np.concatenate([[[U64(0)]], (Mh[:-1, -1:] >> U64(63))], axis=0)
            ph_in = np.concatenate([ph_in, Ph[:, :-1] >> U64(63)], axis=1)
            mh_in = np.concatenate([mh_in, Mh[:, :-1] >> U64(63)], axis=1)
            Phs = ((Ph << U64(1)) | ph_in) & mask
            Mhs = ((Mh << U64(1)) | mh_in) & mask
            Xv = PM | VNp
            VP, VN = (Mhs | ~(Xv | Phs)) & mask, Phs & Xv
            lh, uh, lv, uv = cw_h // wpl, cw_h % wpl, cw_v // wpl, cw_v % wpl
            dh = int((Ph[lh, uh] >> U64(cb_h)) & U64(1)) - int((Mh[lh, uh] >> U64(cb_h)) & U64(1))
            dv = int((VP[lv, uv] >> U64(cb_v)) & U64(1)) - int((VN[lv, uv] >> U64(cb_v)) & U64(1))
            # column i - 1's test runs after column i's step, as in the kernel
            Sc += pending
            if i > 11 and Sc > early_thr[i - 1]:
                fail_i = i - 1
                break
            pending = dh + dv
        if not fail_i:  # the last column's test
            Sc += pending
            if n > 10 and Sc > early_thr[n]:
                fail_i = n
        if not fail_i and n >= 1:
            # per-lane popcounts over bits md+1 .. md+m-n, a warp prefix sum,
            # each lane's own bits, then the argmin with ties to the lowest j
            b_lo, b_hi = md + 1, md + m - n
            pos = w[:, :, None] * 64 + np.arange(64)[None, None, :]
            inr = (pos >= b_lo) & (pos <= b_hi)
            d = (((VP[:, :, None] >> np.arange(64, dtype=np.uint64)) & U64(1)).astype(np.int64)
                 - ((VN[:, :, None] >> np.arange(64, dtype=np.uint64)) & U64(1)).astype(np.int64))
            d = np.where(inr, d, 0).reshape(32, -1)
            base = Sc + np.concatenate([[0], np.cumsum(d.sum(axis=1))[:-1]])
            best = (Sc << 32) | n
            for x in range(32):
                vals = base[x] + np.cumsum(d[x])
                for t in np.nonzero(inr.reshape(32, -1)[x])[0]:
                    best = min(best, (int(vals[t]) << 32) | (n + int(pos.reshape(32, -1)[x, t]) - md))
            cost, j = best >> 32, best & 0xFFFFFFFF
            ma, mb = (j, n) if swap else (n, j)
            if mb >= accept_min[min(max(len_b, 0), tab_len)] and cost < INF:
                res[:5] = [1, cost, ma, mb, -1 if swap else Sc]
        res[5] = fail_i if fail_i else len_a
        rows.append(res)
    return np.array(rows, np.int64).T


def _k1_cases():
    rng = np.random.default_rng(5)
    cases = overlap_cases(rng, 14, src_len=700, seg_lo=150, seg_hi=420, err=0.08, a_lo=100, a_hi=600)
    cases += random_cases(rng, 8, a_hi=500, b_hi=420)
    x = rng.integers(0, 4, 400).astype(np.uint8)
    cases += [
        (x[:300], x[:360]),                        # n = 300 columns, no swap
        (x[:380], x[:250]),                        # swapped: len_a > len_b
        (x[:1], x[:1]),                            # n = 1
        (x[:1], rng.integers(0, 4, 3).astype(np.uint8)),
        (np.zeros(0, np.uint8), x[:5]),           # empty side
    ]
    return cases


@pytest.mark.parametrize("wpl", [1, 2, 3])
def test_k1_word_split_column_step_gives_plain_scores(wpl):
    LA, LB, W, ratio = 601, 420, 127, 0.3
    A, las, Bm, lbs = pack(_k1_cases(), LA, LB)
    plain = scan.batch_score(*batch_tensors(A, las, Bm, lbs), la_max=LA, w_max=W, ratio=ratio)
    model = k1_warp_model(A, las, Bm, lbs, la_max=LA, w_max=W, ratio=ratio, wpl=wpl)
    for f, name in enumerate(plain._fields):
        np.testing.assert_array_equal(model[f], plain[f].numpy().astype(np.int64), name)
    acc = plain.accept.numpy()
    assert 5 <= acc.sum() < len(acc)
    assert (acc & (plain.diag_cost.numpy() == -1)).any()  # an accepted swapped pair
    assert ((~acc) & (plain.dp_rows.numpy() > 10) & (plain.dp_rows.numpy() < 200)).any()


# ---------------------------------------------------------------- (d) K3


def k3_model(A, las, Bm, lbs, *, la_max, w_max, ratio, L, warp,
             maxn=Constants.ALIGNER_MAXN, maxm=Constants.ALIGNER_MAXM):
    """BatchScores fields as wavefront_kernel<L, warp> computes them, one
    pair at a time: T threads of L lanes over the pair's band 0 .. 2md."""
    B, LA = A.shape
    LB = Bm.shape[1]
    tab_len = max(la_max, LB, LA) + 1
    early_thr, accept_min, band_tab = scan._threshold_tables(ratio, tab_len)
    band_cap = 2 * max(min(w_max, maxm - 1), 0) + 1
    if warp:
        assert band_cap <= 32 * L
        T = 32
    else:
        T = -(-band_cap // (32 * L)) * 32
    nw = T // 32
    warp_of = np.arange(T) // 32
    rows = []
    for q in range(B):
        la, lb = int(las[q]), int(lbs[q])
        cond = lb >= la
        md = int(band_tab[min(max(la if cond else lb, 0), tab_len)])
        len_a = la if cond else min(la, lb + md)
        len_b = min(lb, la + md) if cond else lb
        ok = len_a < maxn + maxm and md < maxm and md <= w_max and len_a <= la_max
        res = [0, INF, 0, 0, -1, len_a if ok else 0]
        if not ok or min(len_a, len_b) < 1:
            rows.append(res)
            continue
        hi = 2 * md
        k = np.arange(T * L).reshape(T, L)  # thread t owns row t
        idle = np.zeros(nw, bool) if warp else np.arange(nw) * 32 * L > hi
        j0 = k - md
        pr = np.where((k <= hi) & (j0 >= 0) & (j0 <= min(len_b, md)), j0, INF)
        first = np.full(nw + 1, INF)
        first[:nw][~idle] = pr[::32, 0][~idle]
        act = np.repeat(~idle, 32)
        failed, fail_i, best, best_i, d_ii = False, 0, INF, 0, INF
        for i in range(1, len_a + 1):
            vlo, vhi = max(0, md + 1 - i), min(hi, md + len_b - i)
            kbord = md - i if i <= md else -1
            kc = len_b - i + md
            col = i >= len_b and kc >= 0
            ai = int(A[q, min(i - 1, LA - 1)])
            # UP source of each thread's last lane: shfl_down, or the next warp's first lane
            nxt = np.concatenate([pr[1:, 0], [INF]])
            nxt[31::32] = INF if warp else first[warp_of[31::32] + 1]
            mm = Bm[q, np.clip(k + i - md - 1, 0, LB - 1)].astype(np.int64) != ai
            D = np.minimum(pr + mm, np.concatenate([pr[:, 1:], nxt[:, None]], axis=1) + 1)
            # the fix-up, only in threads not wholly inside the live run [vlo, vhi]
            inner = (k[:, 0] >= vlo) & (k[:, -1] <= vhi)
            valid = (k >= vlo) & (k <= vhi)
            live = np.where(inner[:, None], True, valid | (k == kbord))
            D = np.where(inner[:, None], D, np.where(k == kbord, i, np.where(valid, D, INF)))
            u = D - k
            x = _warp_scan_min(u.min(axis=1))
            run = np.concatenate([np.full((nw, 1), SCAN_ID), x[:, :-1]], axis=1).ravel()
            if not warp:  # the earlier warps' totals, after the first barrier
                carry = np.array([min([SCAN_ID, *x[:w, 31]]) for w in range(nw)])
                run = np.minimum(run, carry[warp_of])
            new = np.empty_like(pr)
            for l in range(L):
                run = np.minimum(run, u[:, l])
                new[:, l] = k[:, l] + run
            new = np.where(live, new, INF)
            pr = np.where(act[:, None], new, pr)  # warps past the band keep their INF row
            first[:nw][~idle] = pr[::32, 0][~idle]
            # the published slots: D(i, i) from lane md's owner, D(i, len_b) from lane kc's
            d_ii = int(pr.ravel()[md])
            c_far = int(pr.ravel()[kc]) if col else INF
            if 10 < i <= len_b and d_ii > early_thr[min(i, tab_len)]:
                failed, fail_i = True, i
                break
            if col and c_far < best:
                best, best_i = c_far, i
        res[5] = fail_i if failed else len_a
        if not failed:
            if len_a > len_b:
                cost, ma, mb, dc = best, best_i, len_b, -1
            else:
                # each thread's first minimum over its lanes in [md, md + len_b - len_a],
                # then (value, lane) minima over the warp and the warps
                ghi = md + len_b - len_a
                cand = [(int(pr[t, l]), int(k[t, l])) for t in range(T) for l in range(L)
                        if md <= k[t, l] <= ghi]
                cost, kk = min(cand)
                ma, mb, dc = len_a, len_a + kk - md, d_ii
            if mb >= accept_min[min(max(len_b, 0), tab_len)] and cost < INF:
                res[:5] = [1, cost, ma, mb, dc]
        rows.append(res)
    return np.array(rows, np.int64).T


def _k3_cases():
    """Overlaps, unrelated pairs and the edges: a far column with two equal
    minima, a final row with a tie, swapped and unswapped pairs, an empty
    side, a pair whose md is the launch's w_max and one above it (size
    rejected)."""
    rng = np.random.default_rng(8)
    cases = overlap_cases(rng, 10, src_len=400, seg_lo=60, seg_hi=260, err=0.08, a_lo=40, a_hi=380)
    cases += random_cases(rng, 6, a_hi=300, b_hi=260)
    x = rng.integers(0, 4, 300).astype(np.uint8)
    cases += [
        (np.append(x[:120], 1).astype(np.uint8), np.append(x[:120], [2, 1]).astype(np.uint8)),
        (np.append(x[:120], [2, 1]).astype(np.uint8), np.append(x[:120], 1).astype(np.uint8)),
        (x[:200], x[:260]),
        (x[:260], x[:200]),
        (x[:1], x[:1]),
        (np.zeros(0, np.uint8), x[:5]),
        (x[:5], np.zeros(0, np.uint8)),
        (x[:280], x[:290]),  # md = 85 > w_max: size-rejected
    ]
    return cases


@pytest.mark.parametrize("path, L", [("block", 4), ("block", 8), ("block", 16),
                                     ("warp", 4), ("warp", 8), ("warp", 16)])
def test_k3_lane_warp_block_split_gives_plain_scores(path, L):
    LA, LB, ratio = 400, 300, 0.3
    # the warp path holds the launch's band in one warp: 32 L lanes
    W = (32 * L - 1) // 2 if path == "warp" else 82
    A, las, Bm, lbs = pack(_k3_cases(), LA, LB)
    plain = scan.batch_score(*batch_tensors(A, las, Bm, lbs), la_max=LA, w_max=W, ratio=ratio)
    model = k3_model(A, las, Bm, lbs, la_max=LA, w_max=W, ratio=ratio, L=L, warp=path == "warp")
    for f, name in enumerate(plain._fields):
        np.testing.assert_array_equal(model[f], plain[f].numpy().astype(np.int64), name)
    acc = plain.accept.numpy()
    rows = plain.dp_rows.numpy()
    assert 5 <= acc.sum() < len(acc)
    assert (acc & (plain.diag_cost.numpy() == -1)).any()  # an accepted swapped pair
    assert ((~acc) & (rows > 10) & (rows < 100)).any()    # an early failure
    assert (~acc & (rows == 0)).any() or W >= 85           # the size reject


def test_k3_launch_shapes_cover_the_paths():
    """launch_shape: the warp path at 4 lanes wherever one warp holds the
    band (the prefilter's 117 lanes), the block path at 8 lanes where 768
    threads of 8 hold it (every full-screen and locate bucket), at 16
    lanes above (locate's widest band)."""
    assert launch_shape(0) == launch_shape(58) == launch_shape(63) == ("warp", 4)
    assert launch_shape(64) == ("block", 8)
    # locate's 1024-8192 buckets, the full screen's 4096 and 8192 buckets
    assert {launch_shape(md) for md in (154, 308, 615, 1229, 2458)} == {("block", 8)}
    assert launch_shape((8 * 768 - 1) // 2) == ("block", 8)
    assert launch_shape((8 * 768 + 1) // 2) == launch_shape(6001) == ("block", 16)
    assert shapes(58) == list(BUILDS) and shapes(6001) == [("block", 16)]
    for md_cap in range(0, 6144, 97):
        band = 2 * md_cap + 1
        assert launch_shape(md_cap) == shapes(md_cap)[0]
        for path, L in shapes(md_cap):
            assert (band <= 32 * L) if path == "warp" else -(-band // (32 * L)) <= 24


# ----------------------------------------------------------------- (e) W

TILE, RING = WALK_TILE, WALK_RING  # csrc/walk.cu: kTile, kRing


def walk_model(P, b, lb_dp, md, matlen_a, matlen_b, accept, *, w_max, e_max):
    """(ops, vals, nedit, tile misses, late, steps) as walk_kernel computes
    them, `late` the misses on entering a row block whose prefetched tile
    does not hold k (the tile is loaded again over its slot): a
    step reads one word of a 128-lane tile of its row block and takes the
    run of MATCH parents down that word plus the parent below it; entering
    row block rb issues the copy of rb - (RING - 1) into a ring of RING
    slots, centred where rb was entered, and a cell outside its tile loads
    the tile at once (a miss)."""
    B, NRB, S = P.shape
    LB = b.shape[1]
    E = e_max
    tmax = E // 32 * 32
    ops = np.zeros((B, E), np.uint8)
    vals = np.zeros((B, E), np.uint8)
    nedit = np.zeros(B, np.int32)
    misses = np.zeros(B, np.int64)
    late = np.zeros(B, np.int64)
    steps = np.zeros(B, np.int64)
    for q in range(B):
        os_, vs_ = np.zeros(E, np.uint8), np.zeros(E, np.uint8)  # back to front
        lim = min(int(lb_dp[q]), int(md[q]))
        i, j, t = int(matlen_a[q]), int(matlen_b[q]), 0
        trb, tbase, tile, ring = -1, 0, None, {}

        def prefetch(rbp, base):
            if rbp >= 0:
                ring[rbp % RING] = (rbp, base, P[q, rbp, base : base + TILE])

        done = not accept[q]
        while not done and t < tmax:
            steps[q] += 1
            if i == 0:
                n, p = (j if 1 <= j <= lim else 0), 0
            else:
                k = min(max(j - i + w_max, 0), S - 1)
                rb = min((i - 1) >> 4, NRB - 1)
                if rb != trb or not tbase <= k < tbase + TILE:
                    base = min(max(k - 63, 0), S - TILE)
                    slot, have = rb % RING, False
                    if rb == trb - 1:
                        assert ring[slot][0] == rb  # the copy that went out RING - 1 entries ago
                        tbase = ring[slot][1]
                        have = tbase <= k < tbase + TILE
                        prefetch(rb - (RING - 1), base)
                    if not have:
                        ring[slot] = (rb, base, P[q, rb, base : base + TILE])
                        tbase = base
                        misses[q] += 1
                        late[q] += rb == trb - 1
                        if trb < 0:
                            for d in range(1, RING):
                                prefetch(rb - d, base)
                    trb, tile = rb, ring[slot][2]
                w = int(tile[k - tbase]) & 0xFFFFFFFF
                r = (i - 1) & 15
                x = (w ^ 0x55555555) & (0xFFFFFFFF >> (30 - 2 * r))
                f = (x.bit_length() - 1) >> 1 if x else -1
                n, p = r - f, ((w >> (2 * f)) & 3 if f >= 0 else -1)
            op = 2 if i == 0 else 1
            m = min(n, tmax - t)
            one = m == n and p > 0 and t + n < tmax
            for l in range(m):
                os_[E - 1 - t - l] = op
                vs_[E - 1 - t - l] = b[q, min(max(j - 1 - l, 0), LB - 1)]
            if one:
                os_[E - 1 - t - n] = p
                vs_[E - 1 - t - n] = b[q, min(max(j - 1 - n, 0), LB - 1)] if p != 3 else 0
            t, j = t + m, j - m
            i -= m if op == 1 else 0
            if one:
                t += 1
                i -= p != 2
                j -= p != 3
            done = m < n or p == 0
        ops[q, :t], vals[q, :t], nedit[q] = os_[E - t :], vs_[E - t :], t
    return ops, vals, nedit, misses, late, steps


def _walk_check(args, E, w_max):
    model = walk_model(*(x.numpy() for x in args), w_max=w_max, e_max=E)
    plain = walk_parents_plain(*args, w_max=w_max, e_max=E)
    for m, p in zip(model[:3], plain):
        np.testing.assert_array_equal(m, p.numpy())
    return model


@pytest.mark.parametrize("name", sorted(walk_edge_cases()))
def test_w_tiled_walk_edges_give_the_plain_walk(name):
    """Each synthetic edge plane alone (B = 1): tile misses where a run
    leaves the window, the clamps, rows cut, E truncation, accept = 0."""
    case = walk_edge_cases()[name]
    args, E = walk_batch([case])
    _, _, nedit, misses, late, _ = _walk_check(args, E, WALK_W)
    n = int(nedit[0])
    want = {"insert_run": n > 150 and misses[0] >= 2,  # the first load and a refetch
            "delete_run": n > 100 and misses[0] >= 2 and late[0] >= 1,
            "rows_cut": n > 160, "k_low": n == E,
            "k_high": 10 <= n < 100, "stops": 0 < n < 150, "e_small": n == 64,
            "rejected": n == 0}
    assert want[name], (n, int(misses[0]), int(late[0]))


def _words_read(P, lb_dp, md, matlen_a, matlen_b, accept, *, w_max, e_max):
    """The distinct (pair, row block, lane) parent words a walk reads, an
    edit at a time, as walk_parents_plain steps."""
    B, NRB, S = P.shape
    seen = set()
    for q in range(B):
        lim = min(int(lb_dp[q]), int(md[q]))
        i, j, t = int(matlen_a[q]), int(matlen_b[q]), 0
        while accept[q] and not (t % 32 == 0 and t + 32 > e_max):
            if i == 0:
                p = INSERT if 1 <= j <= lim else 0
            else:
                k, rb = min(max(j - i + w_max, 0), S - 1), min((i - 1) >> 4, NRB - 1)
                seen.add((q, rb, k))
                p = (int(P[q, rb, k]) >> (2 * ((i - 1) & 15))) & 3
            if p == 0:
                break
            t, i, j = t + 1, i - (p != INSERT), j - (p != DELETE)
    return len(seen)


@pytest.mark.parametrize("name", sorted(walk_edge_cases()))
def test_w_bound_counts_the_words_the_walk_reads(name):
    """chip_smoke.py's bound for W reads only the words under the walk's
    path, rebuilt from its edit stream, not the whole plane."""
    import chip_smoke

    args, E = walk_batch([walk_edge_cases()[name]])
    out = walk_parents_plain(*args, w_max=WALK_W, e_max=E)
    P, _, lb_dp, md, ma, mb, acc = (x.numpy() for x in args)
    want = _words_read(P, lb_dp, md, ma, mb, acc, w_max=WALK_W, e_max=E)
    assert chip_smoke.walk_words(torch, args, dict(w_max=WALK_W), out) == want
    assert want < P.size or name == "rejected"


def test_w_tiled_walk_gives_the_plain_walk_from_screened_goals():
    """Planes of real pairs (the parent kernel's plain version, rows cut
    at the plane) walked from the plain scan's goal cells, in one batch."""
    from test_torch_tbwave import _multi_block_cases as mb_cases

    cases = mb_cases() + make_cases(np.random.default_rng(6), 10, max_len=200)
    LA = LB = 320
    A, las, Bm, lbs = pack(cases, LA, LB)
    W = _full_band(las, lbs, 0.3)
    args = batch_tensors(A, las, Bm, lbs)
    sc = scan.batch_score(*args, la_max=LA, w_max=W, ratio=0.3)
    for rows_max in (None, 128):
        pk, md, lb_dp = batch_parents(*args, la_max=LA, w_max=W, ratio=0.3, rows_max=rows_max)
        E = pk.shape[1] * 16 + W + 2 + 32
        _, _, nedit, misses, _, steps = _walk_check(
            (pk, args[2], lb_dp, md, sc.matlen_a, sc.matlen_b, sc.accept), E, W)
        assert (nedit > 200).any() and int(sc.accept.sum()) > 5
        assert steps.sum() * 4 < nedit.sum() and misses.max() <= 2  # runs of MATCH; few misses


# ------------------------------------------------------ (f) K1 thread path

M64 = (1 << 64) - 1


def _peq_window(P, PW, s):
    """Bits [s, s + 64) of the PW-word bit vector P (a Python int), zero
    outside [0, 64 PW): the parent design's global-PEQ read."""
    P &= (1 << (64 * PW)) - 1
    return (P >> s) & M64 if s >= 0 else (P << -s) & M64


def _staged(row, garbage=0xFF):
    """A row as the thread path stages it: its codes, then filler up to
    its pitch (an odd number of 32-bit words) and on to 128 bytes (the
    next rows or the pad after the last, which the first windows read and
    mask off)."""
    pitch = 4 * (((len(row) + 3) // 4) | 1)
    return np.concatenate([row, np.full(max(pitch, 128) - len(row), garbage, np.uint8)])


def k1_thread_model(A, las, Bm, lbs, *, la_max, w_max, ratio, band_tab=None,
                    maxn=Constants.ALIGNER_MAXN, maxm=Constants.ALIGNER_MAXM):
    """BatchScores fields as bitwave_kernel (the thread path) computes them,
    one pair at a time, checking every letter window against the full PEQ
    at every column. `band_tab` replaces the table's md values."""
    B, LA = A.shape
    LB = Bm.shape[1]
    tab_len = max(la_max, LB, LA) + 1
    early_thr, accept_min, bt = scan._threshold_tables(ratio, tab_len)
    if band_tab is not None:
        bt = band_tab
    assert 2 * min(w_max, maxm - 1) + 1 <= 128  # 2 words a stripe at most
    PW = (max(LA, LB) + 63) // 64 + 1
    rows = []
    for q in range(B):
        la, lb = int(las[q]), int(lbs[q])
        cond = lb >= la
        md = int(bt[min(max(la if cond else lb, 0), tab_len)])
        len_a = la if cond else min(la, lb + md)
        len_b = min(lb, la + md) if cond else lb
        res = [0, INF, 0, 0, -1, 0]
        if not (len_a < maxn + maxm and md < maxm and md <= w_max and len_a <= la_max):
            rows.append(res)
            continue
        swap = len_a > len_b
        n, m = min(len_a, len_b), max(len_a, len_b)
        ra, rb = _staged(A[q]), _staged(Bm[q])
        ka, kb = (rb, ra) if swap else (ra, rb)
        ka_last, kb_last = (LB - 1, LA - 1) if swap else (LA - 1, LB - 1)

        def code(row, t, last):
            return int(row[min(t, last)]) & 3

        # the full PEQ, for the window check: bit t of letter c = (kb[t] == c), t < m
        P = [sum(1 << t for t in range(m) if code(kb, t, kb_last) == c) for c in range(4)]
        # column 1's windows: the first 128 bytes, four a word split into
        # their two bit planes, masked to codes t < lim; past the row's
        # width its last code, up to m; shifted up by md
        lim = min(m, kb_last + 1, 128)
        win = [0, 0, 0, 0]
        for k in range(32):
            lo = [int(v) & 1 for v in kb[4 * k : 4 * k + 4]]
            hi = [(int(v) >> 1) & 1 for v in kb[4 * k : 4 * k + 4]]
            for c, (want_lo, want_hi) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
                nib = sum(1 << u for u in range(4) if (lo[u], hi[u]) == (want_lo, want_hi))
                win[c] |= nib << (4 * k)
        tail = ((1 << min(m, 128)) - 1) & ~((1 << min(kb_last + 1, 128)) - 1)
        c_last = code(kb, max(kb_last, 0), kb_last)
        win = [(((w & ((1 << lim) - 1)) | (tail if c == c_last else 0)) << md) & ((1 << 128) - 1)
               for c, w in enumerate(win)]

        S = 2 * md + 1
        lastmask = (1 << (S & 63)) - 1
        mask0, mask1 = (M64, lastmask) if S > 64 else (lastmask, 0)
        top = 1 << ((S - 1) & 63)
        top0, top1 = (0, top) if S > 64 else (top, 0)
        hbit = 1 << (md - 1) if md >= 1 else 0
        vbit = 1 << md
        vp0, vp1, vn0, vn1 = mask0, mask1, 0, 0
        bb = 1 << (md - 1) if md >= 1 else 0  # the border row's bit, column 1
        Sc, pending, failed, fail_i = 0, 0, False, 0
        c = code(ka, 0, ka_last)
        t_in = 128 - md
        c_in = code(kb, t_in, kb_last) if t_in < m else 4
        for i in range(1, n + 1):
            t0 = i - md - 1
            for x in range(4):
                assert win[x] & M64 == _peq_window(P[x], PW, t0), (q, i, x)
                assert win[x] >> 64 == _peq_window(P[x], PW, t0 + 64), (q, i, x)
            pm0, pm1 = win[c] & M64 & mask0, (win[c] >> 64) & mask1
            win = [(w >> 1) | (1 << 127 if c_in == x else 0) for x, w in enumerate(win)]
            c = code(ka, i, ka_last)
            t_in += 1
            c_in = code(kb, t_in, kb_last) if t_in < m else 4

            # VP, VN and the top bit lie inside the masks: no mask on VPp, VNp
            assert vp0 <= mask0 and vp1 <= mask1 and vn0 <= mask0 and vn1 <= mask1
            vpp0 = (vp0 >> 1) | ((vp1 << 63) & M64) | top0
            vpp1 = (vp1 >> 1) | top1
            vnp0 = (vn0 >> 1) | ((vn1 << 63) & M64)
            vnp1 = vn1 >> 1
            x0, x1 = pm0 & vpp0, pm1 & vpp1
            total = ((x1 << 64) | x0) + ((vpp1 << 64) | vpp0)  # one 128-bit add
            xh0 = ((total & M64) ^ vpp0) | pm0
            xh1 = (((total >> 64) & M64) ^ vpp1) | pm1
            ph0, mh0 = ((vnp0 | (~(xh0 | vpp0) & M64)) & mask0) | bb, vpp0 & xh0 & ~bb & M64
            ph1, mh1 = (vnp1 | (~(xh1 | vpp1) & M64)) & mask1, vpp1 & xh1
            bb >>= 1
            phs0, mhs0 = (ph0 << 1) & mask0, (mh0 << 1) & mask0
            phs1 = ((ph1 << 1) | (ph0 >> 63)) & mask1
            mhs1 = ((mh1 << 1) | (mh0 >> 63)) & mask1
            xv0, xv1 = pm0 | vnp0, pm1 | vnp1
            vp0, vn0 = (mhs0 | (~(xv0 | phs0) & M64)) & mask0, phs0 & xv0
            vp1, vn1 = (mhs1 | (~(xv1 | phs1) & M64)) & mask1, phs1 & xv1
            # column i - 1's test runs after column i's step, as in the kernel
            Sc += pending
            if i > 11 and Sc > early_thr[i - 1]:
                failed, fail_i = True, i - 1
                break
            pending = (bool(ph0 & hbit) - bool(mh0 & hbit)) + (bool(vp0 & vbit) - bool(vn0 & vbit))
        if not failed:  # the last column's test
            Sc += pending
            if n > 10 and Sc > early_thr[n]:
                failed, fail_i = True, n
        if not failed and n >= 1:
            # the bits md+1 .. 2md of the two words, shifted into one, as
            # the kernel shifts: by md, then by 1
            lo = (vp0 >> md) | ((((vp1 << 1) & M64) << (63 - md)) & M64)
            dp = (lo >> 1) | (((vp1 >> md) << 63) & M64)
            lo = (vn0 >> md) | ((((vn1 << 1) & M64) << (63 - md)) & M64)
            dn = (lo >> 1) | (((vn1 >> md) << 63) & M64)
            val = best = Sc
            best_j = n
            for k in range(m - n):
                val += ((dp >> k) & 1) - ((dn >> k) & 1)
                if val < best:
                    best, best_j = val, n + 1 + k
            ma, mb = (best_j, n) if swap else (n, best_j)
            if mb >= accept_min[min(max(len_b, 0), tab_len)] and best < INF:
                res[:5] = [1, best, ma, mb, -1 if swap else Sc]
        res[5] = fail_i if failed else len_a
        rows.append(res)
    return np.array(rows, np.int64).T


def _thread_geometry(las, lbs, kw, zero_band):
    """(md, len_a, len_b, ok) per pair, as the kernels derive them."""
    LA = kw["la_max"]
    tab_len = max(LA, 200) + 1
    _, _, bt = scan._threshold_tables(kw["ratio"], tab_len)
    if zero_band:
        bt = np.zeros_like(bt)
    las, lbs = las.astype(np.int64), lbs.astype(np.int64)
    md = bt[np.minimum(np.where(lbs >= las, las, lbs), tab_len)].astype(np.int64)
    len_a = np.where(lbs >= las, las, np.minimum(las, lbs + md))
    len_b = np.where(lbs >= las, np.minimum(lbs, las + md), lbs)
    return md, len_a, len_b, (md <= kw["w_max"])


def test_k1_thread_model_gives_plain_scores_at_the_prefilter_geometry():
    """The prefilter launch (LA=187, LB=128, W=58, R=0.45): overlaps at 3%
    and 15% error and unrelated pairs."""
    rng = np.random.default_rng(12)
    cases = overlap_cases(rng, 12, src_len=400, seg_lo=128, seg_hi=300, err=0.03, a_lo=60, a_hi=400)
    cases += overlap_cases(rng, 12, src_len=400, seg_lo=128, seg_hi=300, err=0.15, a_lo=60, a_hi=400)
    cases += random_cases(rng, 12, a_hi=400, b_hi=300)
    A, las, Bm, lbs = pack([(a[:187], b[:128]) for a, b in cases], 187, 128)
    plain = scan.batch_score(*batch_tensors(A, las, Bm, lbs), **PREFILTER)
    model = k1_thread_model(A, las, Bm, lbs, **PREFILTER)
    for f, name in enumerate(plain._fields):
        np.testing.assert_array_equal(model[f], plain[f].numpy().astype(np.int64), name)
    acc = plain.accept.numpy()
    assert 8 <= acc.sum() < len(acc)
    assert (acc & (plain.diag_cost.numpy() == -1)).any()  # an accepted swapped pair


@pytest.mark.parametrize("name", sorted(k1_thread_edge_cases()))
def test_k1_thread_model_edges_give_plain_scores(name, monkeypatch):
    A, las, Bm, lbs, kw, zero_band = k1_thread_edge_cases()[name]
    if zero_band:
        monkeypatch.setattr(scan, "threshold_tensors", zero_band_tables(scan.threshold_tensors))
    plain = scan.batch_score(*batch_tensors(A, las, Bm, lbs), **kw)
    tab_len = max(kw["la_max"], Bm.shape[1], A.shape[1]) + 1
    band = np.zeros(tab_len + 1, np.int32) if zero_band else None
    model = k1_thread_model(A, las, Bm, lbs, band_tab=band, **kw)
    for f, fname in enumerate(plain._fields):
        np.testing.assert_array_equal(model[f], plain[f].numpy().astype(np.int64), fname)
    # the batch reaches its edge
    md, len_a, len_b, ok = _thread_geometry(las, lbs, kw, zero_band)
    acc, rows = plain.accept.numpy(), plain.dp_rows.numpy()
    swapped = len_a > len_b
    want = {
        "md0": (md == 0).all() and acc.any() and (rows == 11).any(),
        "md1": (md == 1).all() and (np.minimum(las, lbs) <= 1).sum() >= 6 and acc.any(),
        "md63": (ok & (md == 63) & swapped & acc).any() and (ok & (md == 63) & ~swapped & acc).any()
        and (~ok).sum() == 2,
        "swap": (acc & swapped).sum() >= 3 and (acc & ~swapped).sum() >= 3,
        "row11": (rows == 11).sum() >= 12 and not acc.any(),
        "m_minus_n": (acc & (np.abs(len_a - len_b) == md) & swapped).any()
        and (acc & (len_b - len_a == md)).any(),
        "past_width": (acc & (len_b > Bm.shape[1]) & ~swapped).any()
        and (acc & (np.minimum(len_a, len_b) > Bm.shape[1]) & swapped).any(),
    }
    assert want[name], (md, len_a, len_b, acc, rows)
