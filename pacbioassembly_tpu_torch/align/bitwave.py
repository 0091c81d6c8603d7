"""Screening kernel K1 wrapper: banded bit-parallel DP on the card.

Port of pacbioassembly_tpu/align/bitwave.py::batch_score_bitpallas (the
Pallas kernel `_kernel` with its XLA `_prep`/`_post`). The CUDA kernel
(csrc/bitwave.cu) computes the whole `BatchScores` contract in one launch:
per-pair geometry, transpose normalization, PEQ build, the column loop with
early failure, the far-row goal, un-transpose and acceptance.

For CUDA tensors the wrapper launches the kernel or raises; for CPU tensors
it runs the plain version, align/scan.py::batch_score. Both give identical
BatchScores (tests and chip_smoke.py hold them equal, field by field).

Codes must be 2-bit (0..3); the kernel reads `code & 3`.
"""

from __future__ import annotations

import torch

from .. import _build
from ..host import Constants
from .scan import BatchScores, batch_score, threshold_tensors

KINDS = ("prefilter", "fullscreen")


def batch_score_bitwave(
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
    `kind` names the launch counter: prefilter or fullscreen."""
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
    """Check the inputs, launch csrc/bitwave.cu, count the launch."""
    B, LA = a.shape
    LB = b.shape[1]
    for name, t, dt, shape in (
        ("a", a, torch.uint8, (B, LA)),
        ("b", b, torch.uint8, (B, LB)),
        ("la", la, torch.int32, (B,)),
        ("lb", lb, torch.int32, (B,)),
    ):
        _build.check_tensor(t, dt, shape, name, a.device)
    if la_max > LA:
        raise ValueError(f"la_max {la_max} exceeds a's width {LA}")
    a, b, la, lb = (t.contiguous() for t in (a, b, la, lb))
    tab_len = max(la_max, LB, LA) + 1
    early_thr, accept_min, band_tab = threshold_tensors(ratio, tab_len, str(a.device))
    PW = (max(LA, LB) + 63) // 64 + 1
    peq = torch.empty((max(B, 1), 4, PW), dtype=torch.int64, device=a.device)
    out = torch.empty((6, B), dtype=torch.int32, device=a.device)
    lib = _build.library()
    err = lib.pb_bitwave(
        a.data_ptr(), LA, b.data_ptr(), LB, la.data_ptr(), lb.data_ptr(), B,
        early_thr.data_ptr(), accept_min.data_ptr(), band_tab.data_ptr(), tab_len,
        la_max, w_max, maxn, maxm, peq.data_ptr(), PW, out.data_ptr(),
        _build.stream_of(a),
    )
    _build.check(lib, err, "bitwave")
    _build.count(f"bitwave_{kind}")
    return BatchScores(out[0] != 0, out[1], out[2], out[3], out[4], out[5])
