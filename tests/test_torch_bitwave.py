"""Port: the screening wrapper (align/bitwave.py::batch_score_bitwave) on CPU
tensors against the JAX bit-parallel Pallas kernel in interpret mode
(pacbioassembly_tpu/align/bitwave.py::batch_score_bitpallas), the way
tests/test_bitwave.py runs it. Integer fields, no tolerance.

The CUDA kernel behind the same wrapper is held against this plain path on
the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from pacbioassembly_tpu.align.bitwave import batch_score_bitpallas
from pacbioassembly_tpu.align.scan import batch_score as jax_scan
from pacbioassembly_tpu_torch.align.bitwave import batch_score_bitwave

from test_scan import make_cases, pack
from torch_parity import assert_scores_match, batch_tensors, overlap_cases, random_cases

torch.set_num_threads(1)


def _both(cases, LA, LB, W, ratio):
    A, las, Bm, lbs = pack(cases, LA, LB)
    ref = batch_score_bitpallas(
        A, las, Bm, lbs, la_max=LA, w_max=W, ratio=ratio, interpret=True
    )
    port = batch_score_bitwave(*batch_tensors(A, las, Bm, lbs), la_max=LA, w_max=W, ratio=ratio)
    return A, las, Bm, lbs, ref, port


def test_screen_matches_bitpallas_small():
    rng = np.random.default_rng(21)
    cases = make_cases(rng, 24, max_len=48)
    *_, ref, port = _both(cases, 56, 56, 20, 0.3)
    # dp_rows: see test_dp_rows_follows_scan_not_bitwave
    assert assert_scores_match(port, ref, dp_rows=False) >= 5


def test_screen_swapped_early_failure_band_overflow_and_dp_rows():
    """One batch with transposed pairs (reference side longer), early
    failures at R=0.3, single-base edges and band-overflow rejects; and
    the dp_rows difference between the JAX backends."""
    rng = np.random.default_rng(3)
    cases = overlap_cases(rng, 16, src_len=600, seg_lo=150, seg_hi=384, err=0.1, a_lo=60, a_hi=500)
    cases += random_cases(rng, 12, a_hi=500, b_hi=384)
    cases.append((np.array([2], np.uint8), np.array([2], np.uint8)))
    cases.append((np.array([1], np.uint8), rng.integers(0, 4, 380).astype(np.uint8)))
    cases.append((rng.integers(0, 4, 500).astype(np.uint8), np.array([3], np.uint8)))
    a = rng.integers(0, 4, 384).astype(np.uint8)
    cases.append((a, a))  # max_dst 116 fits; the same pair at W=60 below overflows
    LA, LB, W = 501, 384, 116
    A, las, Bm, lbs, ref, port = _both(cases, LA, LB, W, 0.3)
    assert assert_scores_match(port, ref, dp_rows=False) >= 10
    swapped = np.asarray(ref.accept) & (np.asarray(ref.diag_cost) == -1)
    assert swapped.sum() >= 3, "fixture must include accepted transposed pairs"

    # dp_rows differs between the JAX backends when len_a > len_b: the scan
    # counts len_a rows (align/scan.py:198), the bit-parallel kernel
    # min(len_a, len_b) (align/bitwave.py:636). The port follows the scan.
    scan = jax_scan(A, las, Bm, lbs, la_max=LA, w_max=W, ratio=0.3)
    assert_scores_match(port, scan)  # all six fields, dp_rows included
    rows_bit, rows_scan = np.asarray(ref.dp_rows), np.asarray(scan.dp_rows)
    assert (rows_bit[swapped] < rows_scan[swapped]).all()
    assert (rows_bit[~swapped] == rows_scan[~swapped]).sum() > len(cases) // 2
    failed = ~port.accept.numpy() & (port.dp_rows.numpy() > 10) & (
        port.dp_rows.numpy() < np.minimum(las, lbs)
    )
    assert failed.sum() >= 5, "fixture must include early failures"
    # band overflow: max_dst beyond w_max rejects with no rows
    small = batch_score_bitwave(
        *batch_tensors(A[-1:], las[-1:], Bm[-1:], lbs[-1:]), la_max=LA, w_max=60, ratio=0.3
    )
    assert not bool(small.accept[0]) and int(small.dp_rows[0]) == 0


def test_backend_names_are_checked():
    """No silent fallback: the tensors' device picks the backend, a device
    with neither a kernel nor a plain version raises, and so does an
    unknown launch kind."""
    A, las, Bm, lbs = pack(make_cases(np.random.default_rng(1), 4, max_len=20), 24, 24)
    args = batch_tensors(A, las, Bm, lbs)
    with pytest.raises(ValueError, match="no screening kernel for device meta"):
        batch_score_bitwave(*(t.to("meta") for t in args), la_max=24, w_max=8)
    with pytest.raises(ValueError, match="unknown screening launch kind"):
        batch_score_bitwave(*args, la_max=24, w_max=8, kind="full")
