"""Plain traceback: the parent plane and its walk, frozen for the benchmark.

Copies of the port's plain versions (`align/tbwave.py::batch_parents_plain`
and `walk_parents_plain`). The screen supplies accept and the goal cell
(matlen_a, matlen_b); the plane holds each DP cell's parent (MATCH > INSERT
> DELETE on ties, 2 bits a cell, 16 rows an int32 word), and the walk steps
back from the goal cell and emits the left-aligned edit stream
(find_path, seq_aligner.h:214-233).
"""

from __future__ import annotations

import numpy as np
import torch

from .rowdp import COMPACT, INF, pair_geometry, threshold_tensors

MATCH, INSERT, DELETE = 1, 2, 3
CHUNK = 128   # plane lane / row quantum
RB = 16       # DP rows a packed int32 word
TB_WALK = 32  # the walk emits in blocks of this many edits


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plane_dims(la_max: int, w_max: int, rows_max):
    S = _round_up(2 * w_max + 1, CHUNK)
    R = _round_up(min(la_max, rows_max) if rows_max else la_max, CHUNK)
    return S, R // RB


def geometry(la, lb, la_max, LA, LB, ratio):
    tab_len = max(la_max, LB, LA) + 2
    _, _, band_tab = threshold_tensors(ratio, tab_len, str(la.device))
    return pair_geometry(la.to(torch.int32), lb.to(torch.int32), band_tab, tab_len)


def parents(a, la, b, lb, *, la_max: int, w_max: int, ratio: float, rows_max=None):
    """(plane (B, NRB, S) int32, md, len_b of the DP)."""
    dev = a.device
    B, LA = a.shape
    LB = b.shape[1]
    S, NRB = plane_dims(la_max, w_max, rows_max)
    W = w_max
    md, len_a, len_b = geometry(la, lb, la_max, LA, LB, ratio)
    a32, b32, lb32 = a.to(torch.int32), b.to(torch.int32), lb.to(torch.int32)

    lane = torch.arange(S, dtype=torch.int32, device=dev)
    inf = torch.full((), INF, dtype=torch.int32, device=dev)
    j0 = (lane - W)[None, :]
    prev = torch.where((j0 >= 0) & (j0 <= torch.minimum(len_b, md)[:, None]), j0, inf)
    out = torch.zeros((B, NRB, S), dtype=torch.int32, device=dev)

    w = torch.arange(B, device=dev)
    nrows = min(NRB * RB, int(len_a.max().item())) if B else 0
    for i in range(1, nrows + 1):
        r = (i - 1) % RB
        if i == 1 or (i - 1) % (COMPACT * 2) == 0:
            if i > 1:
                keep = len_a[w] >= i
                w, prev_w = w[keep], prev_w[keep]
            else:
                prev_w = prev[w]
            a_w, b_w, lb_w = a32[w], b32[w], lb32[w]
            md_w, la_w, lbd_w = md[w], len_a[w], len_b[w]
            in_band = (lane[None, :] - W).abs() <= md_w[:, None]
            pw = torch.zeros((len(w), S), dtype=torch.int32, device=dev)
            nw = len(w)
        active = i <= la_w
        j = lane + (i - W)
        validj = ((j >= 1)[None, :] & (j[None, :] <= lbd_w[:, None])) & in_band & active[:, None]
        src = j - 1
        bvalid = (src >= 0)[None, :] & (src[None, :] < lb_w[:, None])
        bj = torch.where(bvalid, b_w[:, src.clamp(0, LB - 1).long()], -1)
        ai = a_w[:, i - 1] if i - 1 < LA else torch.zeros(nw, dtype=torch.int32, device=dev)
        mismatch = (bj != ai[:, None]).to(torch.int32)
        diag = torch.where(validj, prev_w + mismatch, inf)
        up_src = torch.cat([prev_w[:, 1:], inf.expand(nw, 1)], dim=1)
        up = torch.where(validj, up_src + 1, inf)
        D = torch.minimum(diag, up)
        border = (j == 0)[None, :] & ((i <= md_w) & active)[:, None]
        D = torch.where(border, torch.full_like(D, i), D)
        rr = D
        sh = 1
        while sh < S:
            shifted = torch.cat([inf.expand(nw, sh), rr[:, :-sh]], dim=1)
            rr = torch.minimum(rr, shifted + sh)
            sh <<= 1
        live = validj | border
        cur = torch.where(live, rr, inf)

        left_plus1 = torch.cat([inf.expand(nw, 1), cur[:, :-1]], dim=1) + 1
        par = torch.full_like(cur, DELETE)
        par = torch.where(cur == left_plus1, torch.full_like(par, INSERT), par)
        par = torch.where(cur == diag, torch.full_like(par, MATCH), par)
        par = torch.where(border, torch.full_like(par, DELETE), par)
        par = torch.where(live, par, torch.zeros_like(par))
        pw = pw | (par << (2 * r))
        prev_w = torch.where(active[:, None], cur, prev_w)
        if r == RB - 1 or i == nrows:
            out[w, (i - 1) // RB] = pw
            pw = torch.zeros_like(pw)
    return out, md, len_b


def walk(plane, b, lb_dp, md, matlen_a, matlen_b, accept, *, w_max: int, e_max: int):
    """Per-pair walk on the host: (ops, vals, nedit) numpy arrays."""
    P = plane.cpu().numpy()
    bn = b.cpu().numpy()
    lim_v = np.minimum(lb_dp.cpu().numpy(), md.cpu().numpy())
    ma_v, mb_v = np.asarray(matlen_a), np.asarray(matlen_b)
    acc_v = np.asarray(accept)
    B, NRB, S = P.shape
    LB = bn.shape[1]
    E = e_max
    ops = np.zeros((B, E), np.uint8)
    vals = np.zeros((B, E), np.uint8)
    nedit = np.zeros(B, np.int32)
    for q in range(B):
        if not acc_v[q]:
            continue
        lim = int(lim_v[q])
        i, j = int(ma_v[q]), int(mb_v[q])
        so: list[int] = []
        sv: list[int] = []
        done = False
        while not done and len(so) + TB_WALK <= E:
            for _ in range(TB_WALK):
                if i == 0:
                    p = INSERT if 1 <= j <= lim else 0
                else:
                    k = min(max(j - i + w_max, 0), S - 1)
                    im1 = i - 1
                    p = (int(P[q, min(im1 >> 4, NRB - 1), k]) >> ((im1 & 15) * 2)) & 3
                if p == 0:
                    done = True
                    break
                so.append(p)
                sv.append(int(bn[q, min(max(j - 1, 0), LB - 1)]) if p != DELETE else 0)
                if p != INSERT:
                    i -= 1
                if p != DELETE:
                    j -= 1
        t = len(so)
        ops[q, :t] = so[::-1]
        vals[q, :t] = sv[::-1]
        nedit[q] = t
    return ops, vals, nedit
