"""Batched banded Myers bit-parallel scorer over 32-bit word arrays.

Port of pacbioassembly_tpu/align/bitscan.py::batch_score_bp, the multiword
form of align/bitparallel.py: bit p of a pair's stripe is bit p & 31 of
word p >> 5, the Myers addition's cross-word carries resolve with a
Kogge-Stone prefix over (generate, propagate) pairs, and the column loop
runs over every pair of the batch at once. It is an XLA program in the
JAX package, not a Pallas kernel; the hand-written kernel for this algebra
is K1 (csrc/bitwave.cu, 64-bit words), so this module is torch ops only and
runs on whichever device its inputs are on.

torch has no usable uint32 arithmetic, so each 32-bit word lives in an
int64 lane holding a value in [0, 2^32): every shift is then logical, and
every left shift, add and complement is masked back to 32 bits (the carry
of an add is its bit 32).

The outputs follow the port's screening contract (align/scan.py): the
value fields of a rejected pair are canonical, an empty side rejects, and
dp_rows is the scan's (the early-failure row, else len_a; 0 when
size-rejected); on accepted pairs every field equals the JAX function's
and align/banded.py's.
"""

from __future__ import annotations

import torch

from ..config import Constants
from .scan import INF, BatchScores, canonical, pair_geometry, threshold_tensors

MASK32 = 0xFFFFFFFF


def _up(x: torch.Tensor, k: int) -> torch.Tensor:
    """Words v -> v + k (toward higher significance), zero-filled."""
    if k >= x.shape[1]:
        return torch.zeros_like(x)
    return torch.cat([torch.zeros_like(x[:, :k]), x[:, :-k]], dim=1)


def _shl1(x):
    """Whole-bitvector << 1 across words."""
    return ((x << 1) & MASK32) | (_up(x, 1) >> 31)


def _shr1(x):
    """Whole-bitvector >> 1 across words."""
    hi = torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)
    return (x >> 1) | ((hi << 31) & MASK32)


def _add_carry(x, y, n_words: int):
    """Multiword x + y with Kogge-Stone carry lookahead."""
    s = x + y
    gen = s >> 32           # carry-out generated by this word
    s = s & MASK32
    prop = (s == MASK32).long()  # a carry would propagate through
    sh = 1
    while sh < n_words:
        gen = gen | (prop & _up(gen, sh))
        prop = prop & _up(prop, sh)
        sh <<= 1
    return (s + _up(gen, 1)) & MASK32


def _bit_range_mask(lo, hi, w):
    """Words with bits lo..hi (inclusive) set; empty when lo > hi. lo, hi
    (B, 1); w the (1, n_words) word index."""
    lo_edge = (MASK32 << (lo & 31)) & MASK32
    hi_edge = MASK32 >> (31 - (hi & 31))
    base = torch.where(w < (lo >> 5), 0, torch.where(w > (lo >> 5), MASK32, lo_edge))
    top = torch.where(w > (hi >> 5), 0, torch.where(w < (hi >> 5), MASK32, hi_edge))
    return torch.where(lo > hi, 0, base & top)


def _bit_mask(p, w):
    """Single-bit mask at position p (p < 0: empty); p (B, 1)."""
    m = torch.where(w == (p >> 5), 1 << (p & 31), 0)
    return torch.where(p < 0, 0, m)


def _get_bit(x, p):
    """Bit p (B,) of each pair's multiword vector, as int64."""
    word = x.gather(1, (p >> 5).clamp(0, x.shape[1] - 1)[:, None])[:, 0]
    return (word >> (p & 31)) & 1


def batch_score_bp(
    a: torch.Tensor,   # (B, LA) codes
    la: torch.Tensor,  # (B,)
    b: torch.Tensor,   # (B, LB) codes
    lb: torch.Tensor,  # (B,)
    *,
    la_max: int,
    w_max: int,
    ratio: float = Constants.MAXR,
    maxn: int = Constants.ALIGNER_MAXN,
    maxm: int = Constants.ALIGNER_MAXM,
) -> BatchScores:
    """Score B banded alignments (the contract of align/scan.py's
    batch_score) by the word-array Myers recurrence."""
    dev = a.device
    B = a.shape[0]
    LB = b.shape[1]
    S_stat = 2 * w_max + 1
    WORDS = -(-S_stat // 32) + 1
    tab_len = max(la_max, LB) + 1
    tables = threshold_tensors(ratio, tab_len, str(dev))
    early_thr, accept_min, band_tab = (t.long() for t in tables)

    a = a.long()
    b = b.long()
    md, len_a, len_b = (x.long() for x in pair_geometry(la.long(), lb.long(), band_tab, tab_len))
    ok_size = (len_a < maxn + maxm) & (md < maxm) & (md <= w_max) & (len_a <= la_max)
    S = 2 * md + 1  # the pair's own stripe width (bits)

    # PEQ in row coordinates, pre-shifted by md + 1 bits a pair so that the
    # column's window starts at bit i: bit t of PEQ[c] is b[t - md - 1] == c
    PB = -(-(LB + w_max + 2) // 32) + (-(-(la_max + S_stat) // 32)) + 2
    t_idx = torch.arange(PB * 32, device=dev)[None, :]
    src = t_idx - md[:, None] - 1
    bch = b.gather(1, src.clamp(0, LB - 1))
    in_rng = (src >= 0) & (src < len_b[:, None])
    weights = (1 << torch.arange(32, device=dev, dtype=torch.int64))
    peq = torch.stack(
        [(((bch == c) & in_rng).long().reshape(B, PB, 32) * weights).sum(dim=2) for c in range(4)],
        dim=1,
    )  # (B, 4, PB)

    w = torch.arange(WORDS, device=dev)[None, :]
    col = lambda v: v[:, None]  # noqa: E731  (B,) -> (B, 1)
    full_mask = _bit_range_mask(torch.zeros_like(col(S)), col(S - 1), w)
    top_bit = _bit_mask(col(S - 1), w)

    VP = full_mask
    VN = torch.zeros_like(VP)
    S_c = torch.zeros(B, dtype=torch.int64, device=dev)
    TS = torch.minimum(len_b, md)
    best_col = torch.full((B,), INF, dtype=torch.int64, device=dev)
    best_col_i = torch.zeros(B, dtype=torch.int64, device=dev)
    failed = la < 0
    fail_i = torch.zeros(B, dtype=torch.int64, device=dev)
    rows_b = torch.arange(B, device=dev)

    for i in range(1, la_max + 1):
        active = i <= len_a
        # PM window: bits [i, i + S) of PEQ[a_i]
        sel = peq[rows_b, a[:, i - 1].clamp(0, 3)]
        w0, r = i >> 5, i & 31  # w0 + 1 + WORDS <= PB: PB covers la_max + S_stat
        winA = sel[:, w0 : w0 + WORDS]
        if r == 0:
            PM = winA
        else:
            winB = sel[:, w0 + 1 : w0 + 1 + WORDS]
            PM = (winA >> r) | ((winB << (32 - r)) & MASK32)
        p_lo = torch.clamp(md - i + 1, min=0)
        p_hi = torch.minimum(len_b - i + md, 2 * md)
        PM = PM & _bit_range_mask(col(p_lo), col(p_hi), w)

        VPp = _shr1(VP) | top_bit
        VNp = _shr1(VN) & (~top_bit & MASK32)

        X = PM & VPp
        SUM = _add_carry(X, VPp, WORDS)
        Xh = (SUM ^ VPp) | PM
        Ph = VNp | (~(Xh | VPp) & MASK32)
        Mh = VPp & Xh

        # border row j = 0 while in the window: horizontal delta forced +1
        bmask = _bit_mask(col(md - i), w)  # empty once i > md
        Ph = Ph | bmask
        Mh = Mh & (~bmask & MASK32)

        Phs = _shl1(Ph)
        Mhs = _shl1(Mh)
        Xv = PM | VNp
        VP_new = (Mhs | (~(Xv | Phs) & MASK32)) & full_mask
        VN_new = Phs & Xv & full_mask

        # center score D(i, i)
        dh = _get_bit(Ph, md - 1) - _get_bit(Mh, md - 1)
        dv = _get_bit(VP_new, md) - _get_bit(VN_new, md)
        S_c_new = S_c + dh + dv

        # top-edge / row-len_b score
        diag_move = i + md <= len_b
        dh_t = _get_bit(Ph, 2 * md - 1) - _get_bit(Mh, 2 * md - 1)
        dv_t = _get_bit(VP_new, 2 * md) - _get_bit(VN_new, 2 * md)
        pr = len_b - i + md
        dh_r = _get_bit(Ph, pr) - _get_bit(Mh, pr)
        TS_new = TS + torch.where(diag_move, dh_t + dv_t, dh_r)

        fail_now = active & (i > 10) & (i <= len_b) & (S_c_new > early_thr[min(i, tab_len)])
        fail_i = torch.where(fail_now & ~failed, i, fail_i)
        failed = failed | fail_now

        upd = active & (i >= len_b) & (TS_new < best_col)
        best_col = torch.where(upd, TS_new, best_col)
        best_col_i = torch.where(upd, i, best_col_i)

        VP = torch.where(col(active), VP_new, VP)
        VN = torch.where(col(active), VN_new, VN)
        S_c = torch.where(active, S_c_new, S_c)
        TS = torch.where(active, TS_new, TS)

    diag_cost = torch.where(len_a <= len_b, S_c, -1)

    # far-row goal from the final column's vertical deltas above the center
    pvec = torch.arange(S_stat, device=dev)[None, :]
    widx = (pvec >> 5).clamp(0, WORDS - 1).expand(B, -1)
    bits_p = (VP.gather(1, widx) >> (pvec & 31)) & 1
    bits_n = (VN.gather(1, widx) >> (pvec & 31)) & 1
    deltas = torch.where(pvec > col(md), bits_p - bits_n, 0)
    vals = col(S_c) + torch.cumsum(deltas, dim=1)  # vals[p] = D(len_a, len_a + p - md)
    jj = col(len_a) + pvec - col(md)
    rowm = torch.where((pvec >= col(md)) & (jj <= col(len_b)), vals, INF)
    kS = torch.argmin(rowm, dim=1)  # the first minimum
    costS = rowm[rows_b, kS]
    mbS = len_a + kS - md

    long = len_a > len_b
    matlen_a = torch.where(long, best_col_i, len_a)
    matlen_b = torch.where(long, len_b, mbS)
    cost = torch.where(long, best_col, costS)
    accept = (
        ok_size
        & ~failed
        & (torch.minimum(len_a, len_b) >= 1)
        & (matlen_b >= accept_min[len_b.clamp(0, tab_len)])
        & (cost < INF)
    )
    rows = torch.where(ok_size, torch.where(failed, fail_i, len_a), 0)
    return canonical(accept, cost, matlen_a, matlen_b, diag_cost, rows)
