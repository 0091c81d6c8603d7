"""Screening kernel K1 wrapper: banded bit-parallel DP on the card.

Port of pacbioassembly_tpu/align/bitwave.py::batch_score_bitpallas (the
Pallas kernel `_kernel` with its XLA `_prep`/`_post`). The CUDA kernel
(csrc/bitwave.cu) computes the whole `BatchScores` contract in one launch:
per-pair geometry, transpose normalization, PEQ build, the column loop with
early failure, the far-row goal, un-transpose and acceptance. Launches
whose stripes reach WARP_MIN_WORDS words run one warp per pair, narrower
ones (the prefilter) one thread per pair, THREAD_PAIRS pairs a block with
their rows staged in shared memory (the warp path takes launches whose
rows do not fit).

For CUDA tensors the wrapper launches the kernel or raises; for CPU tensors
it runs the plain version, align/scan.py::batch_score. Both give identical
BatchScores (tests and chip_smoke.py hold them equal, field by field).

Codes must be 2-bit (0..3); the kernel reads `code & 3`.
"""

from __future__ import annotations

import torch

from .. import _build
from ..config import Constants
from .scan import BatchScores, batch_score, threshold_tensors
from .tbwave import SMEM_LIMIT

KINDS = ("prefilter", "fullscreen", "locate")
# stripes of at least this many 64-bit words run one warp per pair, narrower
# ones (the prefilter's 2) one thread per pair, the only width the thread path
# is built for (csrc/bitwave.cu); PERF.md's cutover table gives the reason
WARP_MIN_WORDS = 3
# pairs (threads) a thread-path block: one warp (PERF.md, `[kernels:shapes]`)
THREAD_PAIRS = 32


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


def screen_inputs(a, la, b, lb, la_max: int, ratio: float):
    """Check a screening kernel's inputs; returns them contiguous, with the
    threshold tables: (a, la, b, lb, tab_len, early_thr, accept_min,
    band_tab)."""
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
    tab_len = max(la_max, LB, LA) + 1
    return (
        *(t.contiguous() for t in (a, la, b, lb)),
        tab_len,
        *threshold_tensors(ratio, tab_len, str(a.device)),
    )


def stripe_words(w_max: int, maxm: int) -> int:
    """64-bit words in the widest stripe a launch can run (md <= w_max and
    md < maxm)."""
    return (2 * min(w_max, maxm - 1) + 1 + 63) // 64


def _launch(a, la, b, lb, *, la_max, w_max, ratio, maxn, maxm, kind, path=None,
            pairs=THREAD_PAIRS) -> BatchScores:
    """Check the inputs, launch csrc/bitwave.cu, count the launch. `path`
    ("thread" or "warp"; None = by WARP_MIN_WORDS and whether a thread-path
    block's rows fit in shared memory) and `pairs` (a thread-path block's)
    let the tests and the smoke's shapes table run other shapes."""
    B, LA = a.shape
    LB = b.shape[1]
    a, la, b, lb, tab_len, early_thr, accept_min, band_tab = screen_inputs(
        a, la, b, lb, la_max, ratio
    )
    words = stripe_words(w_max, maxm)
    lib = _build.library()
    fits = lib.pb_bitwave_thread_smem(LA, LB, tab_len, pairs) <= SMEM_LIMIT
    if path is None:
        path = "thread" if words < WARP_MIN_WORDS and fits else "warp"
    if path not in ("thread", "warp") or (
        path == "thread" and (words >= WARP_MIN_WORDS or not fits)
    ):
        raise ValueError(
            f"no K1 {path!r} path for stripes of {words} words and rows of {LA} + {LB} codes"
        )
    # the warp path's PEQ scratch, where one warp's 4 x PW words do not fit
    # in shared memory; the thread path keeps its PEQ in registers
    PW = (max(LA, LB) + 63) // 64 + 1
    peq = None
    if path == "warp" and 32 * PW > SMEM_LIMIT:
        peq = torch.empty((max(B, 1), 4, PW), dtype=torch.int64, device=a.device)
    out = torch.empty((6, B), dtype=torch.int32, device=a.device)
    with _build.launching(a) as stream:
        err = lib.pb_bitwave(
            a.data_ptr(), LA, b.data_ptr(), LB, la.data_ptr(), lb.data_ptr(), B,
            early_thr.data_ptr(), accept_min.data_ptr(), band_tab.data_ptr(), tab_len,
            la_max, w_max, maxn, maxm, None if peq is None else peq.data_ptr(), PW,
            1 if path == "thread" else 2, pairs, out.data_ptr(), stream,
        )
    _build.check(lib, err, "bitwave")
    _build.count(f"bitwave_{kind}")
    return BatchScores(out[0] != 0, out[1], out[2], out[3], out[4], out[5])
