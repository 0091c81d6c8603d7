"""Banded Myers/Hyyrö bit-parallel scorer — exact reference implementation.

Computes the same banded edit-distance decisions as align/banded.py
(scores, match lengths, early failure, goal cells) in O(len_a) word
operations per 32/64 band cells instead of O(len_a * band) cell updates.
This Python-int version (bit vectors as arbitrary-precision ints, bit p =
stripe position j - i + md) is the exactness root for the future Pallas
port (docs/PERF_NOTES.md roadmap item 2); tests pin it cell-for-cell to
the banded DP.

Derivation notes (stripe coordinates):
  * the band window slides one row per column, which exactly cancels
    Myers' row shift — the standard column formulas apply verbatim on
    stripe-indexed bit vectors, with the previous column's vertical
    deltas read shifted by one stripe (VPp[p] = VP[p+1]);
  * the incoming top bit (the row that just entered the band) is set to
    VPp=1 / VNp=0 — pretending D(i-1, j_new) = D(i-1, j_new - 1) + 1 is
    safe because the pretended up-source D+2 can never beat the diagonal
    source D+delta;
  * the banned INSERT source at the band's bottom edge is exactly the
    addition's zero carry-in (the carry chain is the in-column insert
    chaining), so no correction is needed there;
  * while the band still contains column j=0 (i <= md), the border row's
    horizontal delta is forced to +1 (D(i,0) = i), reproducing Myers'
    classic `| 1` injection at the moving border position;
  * scores are tracked incrementally: the center diagonal D(i,i) for the
    early-failure test, and one top-edge/row-len_b score for the
    far-column goal; the far-row goal is recovered from the final
    column's vertical deltas.
"""

from __future__ import annotations

import numpy as np

from ..config import Constants
from .banded import compute_band_params
from .scan import _threshold_tables


def bp_score(
    a: np.ndarray,
    b: np.ndarray,
    ratio: float = Constants.MAXR,
    maxn: int = Constants.ALIGNER_MAXN,
    maxm: int = Constants.ALIGNER_MAXM,
):
    """Score one alignment; returns None (reject) or
    (cost, matlen_a, matlen_b, diag_cost) — identical to the banded DP."""
    la0, lb0 = len(a), len(b)
    if la0 == 0 or lb0 == 0:
        return None
    p = compute_band_params(la0, lb0, ratio, maxn, maxm)
    if not p.ok:
        return None
    len_a, len_b, md = p.len_a, p.len_b, p.max_dst
    early_thr, accept_min, _ = _threshold_tables(ratio, max(len_a, len_b) + 1)

    S = 2 * md + 1
    FULL = (1 << S) - 1
    a_ = np.asarray(a[:len_a], dtype=np.int64)
    b_ = np.asarray(b[:len_b], dtype=np.int64)

    # per-letter match masks of b in stripe coords are rebuilt per column
    # (the Pallas port will pre-shift like b_ext); here: bit p corresponds
    # to row j = p + i - md
    VP = FULL  # column 0: D(0, j) - D(0, j-1) = +1 for every in-window row
    VN = 0

    # tracked scores
    S_c = 0  # D(i, i) center
    # top-edge score: D(0, min(len_b, md))
    TS = min(len_b, md)
    top_is_lenb = md >= len_b  # whether the tracked top row is already len_b

    best_col = None  # running (value, i) for D(i, len_b), i >= len_b
    failed = False

    for i in range(1, len_a + 1):
        ai = int(a_[i - 1])
        # valid rows this column: j in [max(1, i-md), min(len_b, i+md)]
        j_lo = max(1, i - md)
        j_hi = min(len_b, i + md)
        p_lo = j_lo - i + md
        p_hi = j_hi - i + md

        # match bits PM[p] = (b[j-1] == a[i-1]), masked to valid rows
        PM = 0
        for pp in range(p_lo, p_hi + 1):
            if int(b_[pp + i - md - 1]) == ai:
                PM |= 1 << pp

        # previous column's vertical deltas, re-aligned (read one stripe up);
        # incoming top row pretends VP=1
        VPp = ((VP >> 1) | (1 << (S - 1))) & FULL
        VNp = (VN >> 1) & FULL

        Xh = ((((PM & VPp) + VPp) & ((1 << (S + 1)) - 1)) ^ VPp) | PM
        Ph = VNp | (~(Xh | VPp) & FULL)
        Mh = VPp & Xh

        # border row j=0 while in window: force horizontal delta +1
        if i <= md:
            p0 = md - i
            Ph |= 1 << p0
            Mh &= ~(1 << p0)

        Phs = (Ph << 1) & FULL
        Mhs = (Mh << 1) & FULL
        Xv = PM | VNp
        VP_new = Mhs | (~(Xv | Phs) & FULL)
        VN_new = Phs & Xv

        # center score D(i, i) = D(i-1, i-1) + Dh(i, i-1) + Dv(i, i)
        dh = ((Ph >> (md - 1)) & 1) - ((Mh >> (md - 1)) & 1)
        dv = ((VP_new >> md) & 1) - ((VN_new >> md) & 1)
        S_c += dh + dv

        # top / row-len_b score
        if not top_is_lenb:
            # top row is i + md (diagonal move): Dv at top + Dh below top
            dh_t = ((Ph >> (S - 2)) & 1) - ((Mh >> (S - 2)) & 1)
            dv_t = ((VP_new >> (S - 1)) & 1) - ((VN_new >> (S - 1)) & 1)
            TS += dh_t + dv_t
            if i + md >= len_b:
                top_is_lenb = True
        else:
            # horizontal move along row len_b at stripe p = len_b - i + md
            pr = len_b - i + md
            TS += ((Ph >> pr) & 1) - ((Mh >> pr) & 1)

        VP, VN = VP_new, VN_new

        # far-column running argmin once i >= len_b (first minimum wins)
        if i >= len_b:
            if best_col is None or TS < best_col[0]:
                best_col = (TS, i)

        # early failure (skip stale rows i > len_b, as in scan/banded)
        if i > 10 and i <= len_b and S_c > int(early_thr[i]):
            failed = True
            break

    if failed:
        return None

    diag_cost = S_c if len_a <= len_b else -1

    if len_a > len_b:
        final_cost, matlen_a = best_col
        matlen_b = len_b
    else:
        # far-row goal: D(len_a, j) for j in [len_a, len_b] from the final
        # column's vertical deltas above the center
        matlen_a = len_a
        val = S_c
        best_v, best_j = S_c, len_a
        for j in range(len_a + 1, len_b + 1):
            pp = j - len_a + md
            val += ((VP >> pp) & 1) - ((VN >> pp) & 1)
            if val < best_v:
                best_v, best_j = val, j
        final_cost, matlen_b = best_v, best_j

    if matlen_b < int(accept_min[len_b]):
        return None
    return int(final_cost), int(matlen_a), int(matlen_b), int(diag_cost)
