"""Exact banded edit-distance DP with traceback (numpy).

Semantics are pinned, cell for cell, to the reference aligner
(seq_aligner.h:92-233):

  * band geometry: the longer sequence is clamped to shorter + max_dst,
    where max_dst = 1 + floor(min_len * R)                       (:92-102)
  * unit costs; source preference on cost ties MATCH > INSERT > DELETE
    (strict < replacement in search(), :161-173)
  * INSERT allowed only while i-j < max_dst, DELETE only while
    j-i < max_dst (band-edge guards, :166,170)
  * early failure: at any row i > 10, if cost(i,i) > i*R the whole
    alignment is abandoned                                        (:185-187)
  * goal cell: best cost along the far row/column scanning outward from the
    main diagonal with strict improvement (first minimum wins)    (:191-213)
  * acceptance: matlen_b >= len_b*(1-R)                           (:114)

Storage is diagonal-stripe: cell (i, j) lives at stripe index
k = j - i + max_dst, k in [0, 2*max_dst]. Rows are computed with vectorized
numpy; the in-row INSERT dependency r[k] = min(D[k], r[k-1]+1) is resolved
exactly via the prefix-min identity r[k] = k + min_{m<=k}(D[m] - m).

Divergence from the reference (documented, SURVEY.md §7): when
len_b < i <= len_a the reference's early-failure test reads a stale cell of
its persistent DP matrix (undefined behavior); here the test is simply
skipped for those rows.
"""

from __future__ import annotations

import numpy as np

from ..config import Constants
from .types import AlignParams, AlignResult, DELETE, INSERT, MATCH

_INF = np.int32(1 << 30)


def compute_band_params(
    la: int,
    lb: int,
    ratio: float,
    maxn: int = Constants.ALIGNER_MAXN,
    maxm: int = Constants.ALIGNER_MAXM,
) -> AlignParams:
    """Band geometry from raw lengths (seq_aligner.h:92-107)."""
    if lb >= la:
        len_a = la
        max_dst = 1 + int(la * ratio)
        len_b = min(lb, len_a + max_dst)
    else:
        len_b = lb
        max_dst = 1 + int(lb * ratio)
        len_a = min(la, len_b + max_dst)
    ok = not (len_a >= maxn + maxm or max_dst >= maxm)
    return AlignParams(len_a=len_a, len_b=len_b, max_dst=max_dst, ok=ok)


def align_banded(
    a: np.ndarray,
    b: np.ndarray,
    ratio: float = Constants.MAXR,
    maxn: int = Constants.ALIGNER_MAXN,
    maxm: int = Constants.ALIGNER_MAXM,
) -> AlignResult | None:
    """Align code array `a` against `b`; returns None on failure.

    Mirrors seq_aligner::align(seg_a, seg_b) with both accessors already
    materialized in reading order (the engine handles direction by slicing
    reversed views before calling).
    """
    la0, lb0 = len(a), len(b)
    if la0 == 0 or lb0 == 0:
        return None
    p = compute_band_params(la0, lb0, ratio, maxn, maxm)
    if not p.ok:
        return None
    len_a, len_b, max_dst = p.len_a, p.len_b, p.max_dst

    S = 2 * max_dst + 1
    ks = np.arange(S, dtype=np.int32)
    a_ = np.asarray(a[:len_a], dtype=np.int16)
    b_ = np.asarray(b[:len_b], dtype=np.int16)

    parents = np.zeros((len_a + 1, S), dtype=np.uint8)

    # row 0: cost(0, j) = j, parent INSERT for j >= 1 (init_cell, :144-149)
    j_row0 = ks - max_dst
    prev = np.where((j_row0 >= 0) & (j_row0 <= len_b), j_row0, _INF).astype(np.int32)
    parents[0, (j_row0 >= 1) & (j_row0 <= len_b)] = INSERT

    # column len_b costs, needed by goal_cell when len_a > len_b
    col_costs = np.full(len_a + 1, _INF, dtype=np.int32)
    if len_b <= max_dst:  # (0, len_b) lies in row 0's band
        col_costs[0] = len_b

    up = np.empty(S, dtype=np.int32)
    for i in range(1, len_a + 1):
        j = ks + np.int32(i - max_dst)
        valid = (j >= 1) & (j <= len_b)
        bj = np.where(valid, b_[np.clip(j - 1, 0, len_b - 1)], np.int16(-1))
        mismatch = (bj != a_[i - 1]).astype(np.int32)
        diag = np.where(valid, prev + mismatch, _INF)
        up[:-1] = prev[1:] + 1  # DELETE source (i-1, j); k = S-1 has no up
        up[-1] = _INF
        D = np.where(valid, np.minimum(diag, up), _INF)

        # border cell (i, 0) = i, parent DELETE (init_cell :140-142)
        border_k = max_dst - i
        if border_k >= 0:
            D[border_k] = i

        # exact in-row INSERT relaxation via prefix-min
        cur = (ks + np.minimum.accumulate(D - ks)).astype(np.int32)
        live = valid.copy()
        if border_k >= 0:
            live[border_k] = True
        cur = np.where(live, cur, _INF)

        # parents with MATCH > INSERT > DELETE preference
        par = np.full(S, DELETE, dtype=np.uint8)
        left_plus1 = np.empty(S, dtype=np.int32)
        left_plus1[0] = _INF
        left_plus1[1:] = cur[:-1] + 1
        par[cur == left_plus1] = INSERT
        par[cur == diag] = MATCH
        if border_k >= 0:
            par[border_k] = DELETE
        parents[i] = par

        k_col = len_b - i + max_dst
        if 0 <= k_col < S:
            col_costs[i] = cur[k_col]

        # early failure (:185-187), skipped for stale rows i > len_b
        if i > 10 and i <= len_b and cur[max_dst] > i * ratio:
            return None

        prev = cur

    diag_cost = int(prev[max_dst]) if len_a <= len_b else -1

    # goal_cell (:191-213): strict improvement scanning outward
    if len_a > len_b:
        matlen_b = len_b
        seg = col_costs[len_b : len_a + 1]
        matlen_a = len_b + int(np.argmin(seg))
        final_cost = int(seg[matlen_a - len_b])
    else:
        matlen_a = len_a
        row = prev  # row len_a
        k_lo = len_a - len_a + max_dst  # j = len_a
        seg = row[k_lo : k_lo + (len_b - len_a) + 1]
        matlen_b = len_a + int(np.argmin(seg))
        final_cost = int(seg[matlen_b - len_a])

    if matlen_b < len_b * (1 - ratio):
        return None

    # iterative traceback (find_path, :214-233)
    ops_rev = []
    vals_rev = []
    i, j = matlen_a, matlen_b
    while True:
        pcode = parents[i, j - i + max_dst]
        if pcode == 0:
            break
        if pcode == MATCH:
            ops_rev.append(MATCH)
            vals_rev.append(b_[j - 1])
            i -= 1
            j -= 1
        elif pcode == INSERT:
            ops_rev.append(INSERT)
            vals_rev.append(b_[j - 1])
            j -= 1
        else:
            ops_rev.append(DELETE)
            vals_rev.append(0)
            i -= 1

    ops = np.asarray(ops_rev[::-1], dtype=np.uint8)
    vals = np.asarray(vals_rev[::-1], dtype=np.uint8)
    return AlignResult(
        matlen_a=matlen_a,
        matlen_b=matlen_b,
        cost=final_cost,
        ops=ops,
        vals=vals,
        len_a=len_a,
        len_b=len_b,
        max_dst=max_dst,
        diag_cost=diag_cost,
    )
