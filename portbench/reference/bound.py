"""The least work of a kernel launch, and the card's peaks: the roofline's yardstick.

Frozen from the port's `chip_smoke.py::bound_work`. A launch is counted by
the function it computes, not by the kernel that computes it: each input
byte read once and each output byte written once, and the int32
operations of the least work known, over each pair's own band of 2md+1
lanes and the rows these inputs run. Screening (K1 or any kernel that
replaces it) takes per pair the lower of a plain DP (CELL_OPS a cell) and
a bit-parallel one (WORD_OPS a 64-lane word) over its dp_rows (rows up to
the early failure, else len_a; 0 when the pair is size-rejected). The
parent plane (K2) takes CELL_OPS + PARENT_OPS a cell over min(len_a, the
plane's rows) rows. Set-up work is left out, so the count stays below the
least work. The least time of a launch is the larger of bytes over the
memory rate and operations over the int32 rate.
"""

from __future__ import annotations

import torch

from .rowdp import MAXM, MAXN, pair_geometry, threshold_tensors

HBM_BYTES_PER_S = 3.35e12       # NVIDIA H100 SXM data sheet
INT32_OPS_PER_S = 132 * 64 * 1.98e9  # 132 SMs x 64 int32 lanes x 1,980 MHz max SM clock
CELL_OPS = 6     # a DP cell: the match compare, three adds, two mins
WORD_OPS = 34    # a 64-cell word of a bit-parallel (Myers) step: 17 64-bit ops
PARENT_OPS = 4   # a cell's parent: two compares, a select, the 2-bit pack


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def screen_work(la, lb, a_shape, b_shape, dp_rows, *, la_max, w_max, ratio,
                maxn=MAXN, maxm=MAXM) -> tuple[float, float]:
    """(bytes, int32 ops) of one screening launch of B pairs: a (B, LA) and
    b (B, LB) codes, la and lb int32, six int32 outputs a pair."""
    B = la.numel()
    nbytes = float(a_shape[0] * a_shape[1] + b_shape[0] * b_shape[1] + 8 * B + 24 * B)
    tab_len = max(la_max, a_shape[1], b_shape[1]) + 1
    _, _, band_tab = threshold_tensors(ratio, tab_len, str(la.device))
    md, len_a, _ = pair_geometry(la.to(torch.int32), lb.to(torch.int32), band_tab, tab_len)
    ok = (len_a < maxn + maxm) & (md < maxm) & (md <= w_max) & (len_a <= la_max)
    band = 2 * md.double() + 1
    ops = dp_rows.double() * torch.minimum(CELL_OPS * band, WORD_OPS * torch.ceil(band / 64))
    return nbytes, float(torch.where(ok, ops, torch.zeros_like(ops)).sum())


def parents_work(la, lb, a_shape, b_shape, plane_shape, *, la_max, w_max, ratio):
    """(bytes, int32 ops) of one parent-plane launch: its inputs, and the
    (B, NRB, S) int32 plane written once."""
    B = la.numel()
    NRB = plane_shape[1]
    nbytes = float(a_shape[0] * a_shape[1] + b_shape[0] * b_shape[1] + 8 * B)
    nbytes += 4.0 * plane_shape[0] * plane_shape[1] * plane_shape[2]
    tab_len = max(la_max, b_shape[1], a_shape[1]) + 2
    _, _, band_tab = threshold_tensors(ratio, tab_len, str(la.device))
    md, len_a, _ = pair_geometry(la.to(torch.int32), lb.to(torch.int32), band_tab, tab_len)
    rows = torch.clamp(len_a.double(), max=NRB * 16)
    band = 2 * torch.clamp(md.double(), max=w_max) + 1
    return nbytes, float((rows * band * (CELL_OPS + PARENT_OPS)).sum())
