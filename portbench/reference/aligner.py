"""Plain banded aligner with traceback (numpy), frozen for the benchmark.

A copy of the port's host aligner fallback (`align/banded.py`), the plain
version of its native C++ aligner: unit-cost banded DP with max_dst =
1 + floor(min_len * R), MATCH > INSERT > DELETE on ties, early failure at
rows past 10, goal cell by first minimum, acceptance at matlen_b >=
len_b * (1 - R), and the edit stream from the traceback (seq_aligner.h).
Returns (matlen_a, matlen_b, cost, ops, vals) or None.
"""

from __future__ import annotations

import numpy as np

from .traceback import DELETE, INSERT, MATCH

_INF = np.int32(1 << 30)


def align(a: np.ndarray, b: np.ndarray, ratio: float, maxn: int = 26_000, maxm: int = 6_000):
    la0, lb0 = len(a), len(b)
    if la0 == 0 or lb0 == 0:
        return None
    if lb0 >= la0:
        len_a = la0
        max_dst = 1 + int(la0 * ratio)
        len_b = min(lb0, len_a + max_dst)
    else:
        len_b = lb0
        max_dst = 1 + int(lb0 * ratio)
        len_a = min(la0, len_b + max_dst)
    if len_a >= maxn + maxm or max_dst >= maxm:
        return None

    S = 2 * max_dst + 1
    ks = np.arange(S, dtype=np.int32)
    a_ = np.asarray(a[:len_a], dtype=np.int16)
    b_ = np.asarray(b[:len_b], dtype=np.int16)
    parents = np.zeros((len_a + 1, S), dtype=np.uint8)

    j_row0 = ks - max_dst
    prev = np.where((j_row0 >= 0) & (j_row0 <= len_b), j_row0, _INF).astype(np.int32)
    parents[0, (j_row0 >= 1) & (j_row0 <= len_b)] = INSERT
    col_costs = np.full(len_a + 1, _INF, dtype=np.int32)
    if len_b <= max_dst:
        col_costs[0] = len_b

    up = np.empty(S, dtype=np.int32)
    for i in range(1, len_a + 1):
        j = ks + np.int32(i - max_dst)
        valid = (j >= 1) & (j <= len_b)
        bj = np.where(valid, b_[np.clip(j - 1, 0, len_b - 1)], np.int16(-1))
        mismatch = (bj != a_[i - 1]).astype(np.int32)
        diag = np.where(valid, prev + mismatch, _INF)
        up[:-1] = prev[1:] + 1
        up[-1] = _INF
        D = np.where(valid, np.minimum(diag, up), _INF)
        border_k = max_dst - i
        if border_k >= 0:
            D[border_k] = i
        cur = (ks + np.minimum.accumulate(D - ks)).astype(np.int32)
        live = valid.copy()
        if border_k >= 0:
            live[border_k] = True
        cur = np.where(live, cur, _INF)

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
        if i > 10 and i <= len_b and cur[max_dst] > i * ratio:
            return None
        prev = cur

    if len_a > len_b:
        matlen_b = len_b
        seg = col_costs[len_b : len_a + 1]
        matlen_a = len_b + int(np.argmin(seg))
        cost = int(seg[matlen_a - len_b])
    else:
        matlen_a = len_a
        seg = prev[max_dst : max_dst + (len_b - len_a) + 1]
        matlen_b = len_a + int(np.argmin(seg))
        cost = int(seg[matlen_b - len_a])
    if matlen_b < len_b * (1 - ratio):
        return None

    ops_rev, vals_rev = [], []
    i, j = matlen_a, matlen_b
    while True:
        p = parents[i, j - i + max_dst]
        if p == 0:
            break
        if p == MATCH:
            ops_rev.append(MATCH)
            vals_rev.append(b_[j - 1])
            i -= 1
            j -= 1
        elif p == INSERT:
            ops_rev.append(INSERT)
            vals_rev.append(b_[j - 1])
            j -= 1
        else:
            ops_rev.append(DELETE)
            vals_rev.append(0)
            i -= 1
    ops = np.asarray(ops_rev[::-1], dtype=np.uint8)
    vals = np.asarray(vals_rev[::-1], dtype=np.uint8)
    return matlen_a, matlen_b, cost, ops, vals
