"""Plain banded edit-distance scorer (PyTorch row DP), frozen for the benchmark.

A copy of the port's plain screening DP (`align/scan.py::batch_score`), kept
here so that the benchmark's reference does not depend on the program it
judges. B alignments with a shared row bound (la_max) and band half-width
(w_max) are scored row by row over the (B, 2*w_max+1) band; the in-row
INSERT chain is an exact min-plus prefix (cummin). Rejected pairs report
canonical values (cost INF, matlen 0, diag_cost -1).

Semantics (seq_aligner.h:92-213 of the assembler this program ports): band
geometry from the shorter side, unit costs, early failure at rows past 10
when cost(i, i) > floor(i * R), goal cell by first minimum along the far
row or column, acceptance when matlen_b >= ceil(len_b * (1 - R)).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

INF = 1 << 28
COMPACT = 32  # rows between working-set compactions
MAXN, MAXM = 26_000, 6_000  # the assembler's aligner bounds (MAX_READ_LEN + MAX_DIFF_LEN, MAX_DIFF_LEN)


class Scores(NamedTuple):
    accept: torch.Tensor     # (B,) bool
    cost: torch.Tensor       # (B,) int32
    matlen_a: torch.Tensor   # (B,) int32
    matlen_b: torch.Tensor   # (B,) int32
    diag_cost: torch.Tensor  # (B,) int32
    dp_rows: torch.Tensor    # (B,) int32: rows up to the early failure, else len_a


def threshold_tables(ratio: float, max_len: int):
    """early_thr[i] = floor(i R), accept_min[l] = ceil(l (1 - R)),
    band[l] = 1 + floor(l R), in float64 on the host."""
    i = np.arange(max_len + 1, dtype=np.float64)
    return (
        np.floor(i * ratio).astype(np.int32),
        np.ceil(i * (1.0 - ratio)).astype(np.int32),
        (1 + np.floor(i * ratio)).astype(np.int32),
    )


@functools.lru_cache(maxsize=64)
def threshold_tensors(ratio: float, tab_len: int, device: str):
    return tuple(torch.from_numpy(t).to(device) for t in threshold_tables(ratio, tab_len))


def pair_geometry(la, lb, band_tab, tab_len: int):
    """(md, len_a, len_b): the band and the clamped lengths of each pair."""
    cond = lb >= la
    min_len = torch.where(cond, la, lb)
    md = band_tab[min_len.clamp(0, tab_len).long()]
    len_a = torch.where(cond, la, torch.minimum(la, lb + md))
    len_b = torch.where(cond, torch.minimum(lb, la + md), lb)
    return md, len_a, len_b


def score(a, la, b, lb, *, la_max: int, w_max: int, ratio: float,
          maxn: int = MAXN, maxm: int = MAXM) -> Scores:
    """Score B banded alignments of a (B, LA) against b (B, LB)."""
    dev = a.device
    B, LA = a.shape
    LB = b.shape[1]
    S = 2 * w_max + 1
    W = w_max
    tab_len = max(la_max, LB, LA) + 1
    early_thr, accept_min, band_tab = threshold_tensors(ratio, tab_len, str(dev))
    a = a.to(torch.int32)
    b = b.to(torch.int32)
    la = la.to(torch.int32)
    lb = lb.to(torch.int32)
    md, len_a, len_b = pair_geometry(la, lb, band_tab, tab_len)
    ok_size = (len_a < maxn + maxm) & (md < maxm) & (md <= w_max) & (len_a <= la_max)

    k = torch.arange(S, dtype=torch.int32, device=dev)
    inf = torch.full((), INF, dtype=torch.int32, device=dev)
    j0 = (k - W)[None, :]
    prev = torch.where((j0 >= 0) & (j0 <= torch.minimum(len_b, md)[:, None]), j0, inf)
    failed = torch.zeros(B, dtype=torch.bool, device=dev)
    fail_i = torch.zeros(B, dtype=torch.int32, device=dev)
    final_row = torch.full((B, S), INF, dtype=torch.int32, device=dev)
    cols = torch.full((B, la_max + 1), INF, dtype=torch.int32, device=dev)
    cols[:, 0] = torch.where(len_b <= md, len_b, inf)

    w = torch.nonzero(ok_size & (len_a >= 1)).flatten()
    nrows = min(la_max, int(len_a[w].max().item())) if len(w) else 0
    for i in range(1, nrows + 1):
        if i == 1 or (i - 1) % COMPACT == 0:
            if i == 1:
                prev_w, failed_w = prev[w], failed[w]
                fail_i_w, final_w = fail_i[w], final_row[w]
            else:
                failed[w], fail_i[w], final_row[w] = failed_w, fail_i_w, final_w
                keep = ~failed_w & (len_a[w] >= i)
                w = w[keep]
                if len(w) == 0:
                    break
                prev_w, failed_w = prev_w[keep], failed_w[keep]
                fail_i_w, final_w = fail_i_w[keep], final_w[keep]
            a_w, b_w = a[w], b[w]
            md_w, la_w, lb_w = md[w], len_a[w], len_b[w]
            in_band = (k[None, :] - W).abs() <= md_w[:, None]
            rw = torch.arange(len(w), device=dev)
            inf_col = inf.expand(len(w), 1)
        active = i <= la_w
        j = k + (i - W)
        validj = ((j >= 1)[None, :] & (j[None, :] <= lb_w[:, None])) & in_band & active[:, None]
        bj = b_w[:, (j - 1).clamp(0, LB - 1).long()]
        ai = a_w[:, min(i - 1, LA - 1)]
        mismatch = (bj != ai[:, None]).to(torch.int32)
        diag = torch.where(validj, prev_w + mismatch, inf)
        up_src = torch.cat([prev_w[:, 1:], inf_col], dim=1)
        up = torch.where(validj, up_src + 1, inf)
        D = torch.minimum(diag, up)
        border = (j == 0)[None, :] & ((i <= md_w) & active)[:, None]
        D = torch.where(border, torch.full_like(D, i), D)
        r = k + torch.cummin(D - k, dim=1).values
        cur = torch.where(validj | border, r, inf)

        fail_now = active & (i > 10) & (i <= lb_w) & (cur[:, W] > early_thr[min(i, tab_len)])
        fail_i_w = torch.where(fail_now & ~failed_w, torch.full_like(fail_i_w, i), fail_i_w)
        failed_w = failed_w | fail_now
        final_w = torch.where((i == la_w)[:, None], cur, final_w)

        k_col = lb_w - i + W
        col_ok = (k_col >= 0) & (k_col < S) & active
        cols[w, i] = torch.where(col_ok, cur[rw, k_col.clamp(0, S - 1).long()], inf)
        prev_w = torch.where(active[:, None], cur, prev_w)
    if nrows and len(w):
        failed[w], fail_i[w], final_row[w] = failed_w, fail_i_w, final_w

    rows_b = torch.arange(B, device=dev)
    long = len_a > len_b
    ii = torch.arange(la_max + 1, dtype=torch.int32, device=dev)[None, :]
    colm = torch.where((ii >= len_b[:, None]) & (ii <= len_a[:, None]), cols, inf)
    iL = torch.argmin(colm, dim=1)
    costL = colm[rows_b, iL]
    rowm = torch.where(
        (k[None, :] >= W) & (k[None, :] <= (W + len_b - len_a)[:, None]), final_row, inf
    )
    kS = torch.argmin(rowm, dim=1)
    costS = rowm[rows_b, kS]
    mbS = len_a + (kS.to(torch.int32) - W)

    matlen_a = torch.where(long, iL.to(torch.int32), len_a)
    matlen_b = torch.where(long, len_b, mbS)
    cost = torch.where(long, costL, costS)
    accept = (
        ok_size & ~failed & (torch.minimum(len_a, len_b) >= 1)
        & (matlen_b >= accept_min[len_b.clamp(0, tab_len).long()]) & (cost < INF)
    )
    diag_cost = torch.where(len_a <= len_b, final_row[:, W], torch.full_like(len_a, -1))
    rows = torch.where(ok_size, torch.where(failed, fail_i, len_a), torch.zeros_like(len_a))
    zero = torch.zeros_like(matlen_a)
    return Scores(
        accept,
        torch.where(accept, cost, torch.full_like(cost, INF)).to(torch.int32),
        torch.where(accept, matlen_a, zero).to(torch.int32),
        torch.where(accept, matlen_b, zero).to(torch.int32),
        torch.where(accept, diag_cost, torch.full_like(diag_cost, -1)).to(torch.int32),
        rows.to(torch.int32),
    )
