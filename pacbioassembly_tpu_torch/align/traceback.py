"""Batched alignment with traceback: scores plus left-aligned edit streams.

Port of pacbioassembly_tpu/align/traceback.py::batch_align_traceback. The
JAX function re-runs a banded DP that stores a 2-bit parent per band cell
(a lax.scan over blocks of rows) and walks the parents back in a
while_loop. The port does not re-port that scan: it chains the port's own
kernels for the same function, as the engine's commit already does
(assemble/gather.py::parents_and_walk):

  1. the screening kernel (K1 or K3, `screen_kernel`): BatchScores and the
     goal cell (matlen_a, matlen_b) of every pair;
  2. the parent kernel K2 (align/tbwave.py::batch_parents): the packed
     parent plane, MATCH > INSERT > DELETE on ties, as align/banded.py;
  3. the walk W (tbwave.walk_parents) from the goal cells: left-aligned
     ops and vals, zero past nedit.

On CUDA tensors each step launches its kernel; on CPU tensors each runs its
plain version. The outputs are the JAX function's: (B, E) uint8 ops and
vals with E = ceil(R / 32) * 32 + w_max + 2 + 32 (R the rows, min(la_max,
rows_max)) unless `e_max` is given, and the walk stops as the JAX one does
(a 32-edit block is emitted only while it fits in E). Two decisions differ
from the JAX function, both outside accepted alignments, as everywhere in
the port (align/scan.py):

  * dp_rows follows the scan: the early-failure row of a failed pair, else
    len_a (the JAX traceback reports len_a for every pair);
  * the value fields of a rejected pair are canonical (cost INF, matlen 0,
    diag_cost -1; its nedit 0 and its streams all zero).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Constants
from .scan import BatchScores
from .screen import score_batch
from .tbwave import TB_WALK, batch_parents, walk_parents

UNROLL_TB = 32  # the JAX scan's rows a step: its E rounds the rows up to this


class TracebackResult(NamedTuple):
    scores: BatchScores
    ops: torch.Tensor    # (B, E) uint8, left-aligned edit opcodes, 0-padded
    vals: torch.Tensor   # (B, E) uint8 b-side codes for MATCH/INSERT
    nedit: torch.Tensor  # (B,) int32


def traceback_width(la_max: int, w_max: int, rows_max: int | None = None) -> int:
    """The JAX function's default stream width E."""
    R = la_max if rows_max is None else min(la_max, rows_max)
    return -(-R // UNROLL_TB) * UNROLL_TB + w_max + 2 + TB_WALK


def batch_align_traceback(
    a: torch.Tensor,
    la: torch.Tensor,
    b: torch.Tensor,
    lb: torch.Tensor,
    *,
    la_max: int,
    w_max: int,
    ratio: float = Constants.MAXR,
    maxn: int = Constants.ALIGNER_MAXN,
    maxm: int = Constants.ALIGNER_MAXM,
    e_max: int | None = None,
    rows_max: int | None = None,
    screen_kernel: str = "bitwave",
) -> TracebackResult:
    """Score B banded alignments and trace the accepted ones back.
    `rows_max` bounds the parent plane's rows below la_max when the caller
    knows max(la) for the batch: it must be >= every pair's len_a (rows_max
    >= max(la) suffices)."""
    a, b = a.to(torch.uint8), b.to(torch.uint8)
    la, lb = la.to(torch.int32), lb.to(torch.int32)
    scores = score_batch(a, la, b, lb, screen_kernel=screen_kernel, kind="fullscreen",
                         la_max=la_max, w_max=w_max, ratio=ratio, maxn=maxn, maxm=maxm)
    parents, md, lb_dp = batch_parents(a, la, b, lb, la_max=la_max, w_max=w_max, ratio=ratio,
                                       rows_max=rows_max)
    E = e_max if e_max is not None else traceback_width(la_max, w_max, rows_max)
    ops, vals, nedit = walk_parents(parents, b, lb_dp, md, scores.matlen_a, scores.matlen_b,
                                    scores.accept, w_max=w_max, e_max=E)
    return TracebackResult(scores, ops, vals, nedit)
