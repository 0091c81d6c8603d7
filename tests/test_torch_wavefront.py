"""Port: the row-DP screening wrapper (align/wavefront.py::batch_score_rowdp)
on CPU tensors against the JAX row-DP Pallas kernel in interpret mode
(pacbioassembly_tpu/align/wavefront.py::batch_score_pallas), at
tests/test_pallas.py's size, plus transposed pairs (len_a > len_b).
Integer fields, no tolerance: accept on every pair, the value fields on
every accepted pair, and dp_rows against the JAX scan (the JAX kernel
reports len_a there for every pair; ROADMAP queue C). Also the screening
selector: PBTPU_SCREEN_BACKEND names map to the kernels, and anything
else raises.

The CUDA kernel behind the same wrapper is held against this plain path on
the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from pacbioassembly_tpu.align.scan import batch_score as jax_scan
from pacbioassembly_tpu.align.wavefront import batch_score_pallas
from pacbioassembly_tpu_torch.align.screen import score_batch, screen_kernel
from pacbioassembly_tpu_torch.align.wavefront import batch_score_rowdp

from test_scan import make_cases, pack
from torch_parity import assert_scores_match, batch_tensors, overlap_cases, random_cases

torch.set_num_threads(1)

LA, LB, W, R = 56, 56, 20, 0.3


def _pallas_size_cases():
    return make_cases(np.random.default_rng(21), 16, max_len=48)


def _swapped_cases():
    """Reference side longer than the segment (the transposed goal), with
    random pairs that fail early and single-base edges."""
    rng = np.random.default_rng(5)
    cases = overlap_cases(rng, 8, src_len=64, seg_lo=20, seg_hi=36, err=0.05, a_lo=40, a_hi=56)
    cases += random_cases(rng, 6, a_hi=56, b_hi=56)
    cases.append((np.array([2], np.uint8), np.array([2], np.uint8)))
    cases.append((rng.integers(0, 4, 50).astype(np.uint8), np.array([3], np.uint8)))
    return cases


@pytest.mark.parametrize("cases", [_pallas_size_cases, _swapped_cases], ids=["pallas_size", "swapped"])
def test_rowdp_matches_pallas_interpret(cases):
    A, las, Bm, lbs = pack(cases(), LA, LB)
    ref = batch_score_pallas(A, las, Bm, lbs, la_max=LA, w_max=W, ratio=R, interpret=True)
    port = batch_score_rowdp(*batch_tensors(A, las, Bm, lbs), la_max=LA, w_max=W, ratio=R)
    assert assert_scores_match(port, ref, dp_rows=False) >= 5
    scan = jax_scan(A, las, Bm, lbs, la_max=LA, w_max=W, ratio=R)
    assert_scores_match(port, scan)  # all six fields, dp_rows included
    # the JAX kernel's dp_rows is len_a for every pair; it differs from the
    # scan only on pairs that it rejects
    acc = port.accept.numpy()
    differs = np.asarray(ref.dp_rows) != np.asarray(scan.dp_rows)
    assert not (differs & acc).any()
    if cases is _swapped_cases:
        swapped = acc & (port.diag_cost.numpy() == -1)
        assert swapped.sum() >= 5, "fixture must include accepted transposed pairs"
        failed = ~acc & (port.dp_rows.numpy() > 10) & (port.dp_rows.numpy() < np.minimum(las, lbs))
        assert failed.sum() >= 2 and differs.sum() >= 2, "fixture must include early failures"


def test_rowdp_refuses_what_it_cannot_run():
    A, las, Bm, lbs = pack(make_cases(np.random.default_rng(1), 4, max_len=20), 24, 24)
    args = batch_tensors(A, las, Bm, lbs)
    with pytest.raises(ValueError, match="no screening kernel for device meta"):
        batch_score_rowdp(*(t.to("meta") for t in args), la_max=24, w_max=8)
    with pytest.raises(ValueError, match="unknown screening launch kind"):
        batch_score_rowdp(*args, la_max=24, w_max=8, kind="full")
    with pytest.raises(ValueError, match="unknown screening kernel"):
        score_batch(*args, screen_kernel="pallas", kind="fullscreen", la_max=24, w_max=8)


@pytest.mark.parametrize(
    "value, device, expected",
    [
        (None, "cuda", "bitwave"),
        ("", "cpu", "bitwave"),
        ("bitpallas", "cuda:0", "bitwave"),
        ("pallas", "cuda", "rowdp"),
        ("pallas", "cpu", "rowdp"),
        ("scan", "cpu", "bitwave"),  # on the CPU every wrapper runs the scan
        ("scan", "cuda", ValueError),
        ("bitpallas_interpret", "cpu", ValueError),
        ("wavefront", "cuda", ValueError),
    ],
)
def test_screen_kernel_selector(value, device, expected):
    env = {} if value is None else {"PBTPU_SCREEN_BACKEND": value}
    if expected is ValueError:
        with pytest.raises(ValueError, match="PBTPU_SCREEN_BACKEND"):
            screen_kernel(device, env)
    else:
        assert screen_kernel(device, env) == expected
