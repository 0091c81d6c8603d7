"""Screening kernel K3 wrapper: the banded row DP on the card.

Port of pacbioassembly_tpu/align/wavefront.py::batch_score_pallas (the
Pallas kernel `_kernel` with its XLA geometry prologue and accept_min
epilogue). The CUDA kernel (csrc/wavefront.cu) runs the row DP of
align/scan.py::batch_score over each pair's own band, with the row in
registers (L band lanes a thread), and computes the whole `BatchScores`
contract in one launch: geometry and the size check, the rows with early
failure and the far-column running argmin, the final-row first-minimum
goal and acceptance. It has two shapes (`launch_shape`): a warp per pair
when the launch's band fits one warp, a block per pair above.

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

# The kernel's builds, (path, band lanes a thread), in the order
# `launch_shape` prefers them: a warp per pair at 4 lanes where one warp
# holds the band (up to 128 lanes: the prefilter), else a block per pair
# at 8 lanes, or 16 where 8 lanes a thread do not fit a block. Chosen on
# the card against the other lanes on each path (PERF.md, K3 cutover).
BUILDS = (("warp", 4), ("block", 8), ("block", 16))
BLOCK_THREADS = 768   # the block path's most threads (csrc/wavefront.cu::kBlockThreads)


def shapes(md_cap: int) -> list[tuple[str, int]]:
    """The builds that hold a launch whose pairs have md <= md_cap: the
    warp path where 32 x lanes hold the band, the block path where its
    threads fit a block."""
    band = 2 * md_cap + 1
    return [
        (path, L) for path, L in BUILDS
        if (band <= 32 * L if path == "warp" else -(-band // (32 * L)) * 32 <= BLOCK_THREADS)
    ]


def launch_shape(md_cap: int) -> tuple[str, int]:
    """(path, lanes) for a launch whose pairs have md <= md_cap: the first
    build that holds its band (the block path at 16 lanes where none does,
    which the launch then refuses)."""
    return (shapes(md_cap) or [BUILDS[-1]])[0]


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


def _launch(a, la, b, lb, *, la_max, w_max, ratio, maxn, maxm, kind, path=None,
            lanes=0) -> BatchScores:
    """Launch csrc/wavefront.cu, count the launch. `path` ("warp" or
    "block") and `lanes` force one of the BUILDS, for the tests and the
    measurements that compare the kernel's shapes; by default
    `launch_shape` chooses. The launcher refuses a band its threads do not
    hold and b rows its shared memory does not (raised here)."""
    B, LA = a.shape
    LB = b.shape[1]
    auto_path, auto_lanes = launch_shape(max(min(w_max, maxm - 1), 0))
    path, lanes = path or auto_path, lanes or auto_lanes
    a, la, b, lb, tab_len, early_thr, accept_min, band_tab = screen_inputs(
        a, la, b, lb, la_max, ratio
    )
    out = torch.empty((6, B), dtype=torch.int32, device=a.device)
    lib = _build.library()
    with _build.launching(a) as stream:
        err = lib.pb_wavefront(
            a.data_ptr(), LA, b.data_ptr(), LB, la.data_ptr(), lb.data_ptr(), B,
            early_thr.data_ptr(), accept_min.data_ptr(), band_tab.data_ptr(), tab_len,
            la_max, w_max, maxn, maxm, int(path == "warp"), lanes, out.data_ptr(), stream,
        )
    _build.check(lib, err, "wavefront")
    _build.count(f"rowdp_{kind}")
    return BatchScores(out[0] != 0, out[1], out[2], out[3], out[4], out[5])
