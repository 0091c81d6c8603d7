"""Screening kernel K3 wrapper: the banded row DP on the card.

Port of pacbioassembly_tpu/align/wavefront.py::batch_score_pallas (the
Pallas kernel `_kernel` with its XLA geometry prologue and accept_min
epilogue). The CUDA kernel (csrc/wavefront.cu) runs the row DP of
align/scan.py::batch_score, one block per pair over the pair's own band,
and computes the whole `BatchScores` contract in one launch: geometry and
the size check, the rows with early failure and the far-column running
argmin, the final-row first-minimum goal and acceptance.

For CUDA tensors the wrapper launches the kernel or raises; for CPU tensors
it runs the plain version, align/scan.py::batch_score. Both give identical
BatchScores (tests and chip_smoke.py hold them equal, field by field).
`dp_rows` follows the scan (the failure row, else len_a; 0 when
size-rejected), where the JAX kernel reports len_a for every pair
(ROADMAP queue C).
"""

from __future__ import annotations

import torch

from .. import _build
from ..config import Constants
from .bitwave import KINDS, screen_inputs
from .scan import BatchScores, batch_score
from .tbwave import SMEM_LIMIT


def batch_score_rowdp(
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
    kind: str = "fullscreen",
) -> BatchScores:
    """Score B banded alignments (same contract as scan.batch_score).
    `kind` names the launch counter: prefilter, fullscreen or locate."""
    if kind not in KINDS:
        raise ValueError(f"unknown screening launch kind {kind!r} (expected {KINDS})")
    if a.device.type == "cpu":
        return batch_score(
            a, la, b, lb, la_max=la_max, w_max=w_max, ratio=ratio, maxn=maxn, maxm=maxm
        )
    if a.device.type != "cuda":
        raise ValueError(f"no screening kernel for device {a.device}")
    return _launch(
        a, la, b, lb, la_max=la_max, w_max=w_max, ratio=ratio, maxn=maxn, maxm=maxm,
        kind=kind,
    )


def _launch(a, la, b, lb, *, la_max, w_max, ratio, maxn, maxm, kind) -> BatchScores:
    """Check the inputs, launch csrc/wavefront.cu, count the launch."""
    B, LA = a.shape
    LB = b.shape[1]
    smem = 3 * (2 * min(w_max, maxm - 1) + 1) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"band of w_max {w_max} needs {smem} B of shared memory (> {SMEM_LIMIT})")
    a, la, b, lb, tab_len, early_thr, accept_min, band_tab = screen_inputs(
        a, la, b, lb, la_max, ratio
    )
    out = torch.empty((6, B), dtype=torch.int32, device=a.device)
    lib = _build.library()
    err = lib.pb_wavefront(
        a.data_ptr(), LA, b.data_ptr(), LB, la.data_ptr(), lb.data_ptr(), B,
        early_thr.data_ptr(), accept_min.data_ptr(), band_tab.data_ptr(), tab_len,
        la_max, w_max, maxn, maxm, out.data_ptr(), _build.stream_of(a),
    )
    _build.check(lib, err, "wavefront")
    _build.count(f"rowdp_{kind}")
    return BatchScores(out[0] != 0, out[1], out[2], out[3], out[4], out[5])
