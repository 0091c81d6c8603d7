"""Port: the bit-parallel exactness root (align/bitparallel.py::bp_score,
a copy of the JAX module) and the word-array Myers screen
(align/bitscan.py::batch_score_bp, torch ops) against the JAX package's
bp_score and batch_score_bp, align/banded.py and the port's plain scan, on
tests/test_bitparallel.py's inputs, exactly."""

import numpy as np
import pytest
import torch

from pacbioassembly_tpu.align.banded import align_banded
from pacbioassembly_tpu.align.bitparallel import bp_score as jax_bp_score
from pacbioassembly_tpu.align.bitscan import batch_score_bp as jax_batch_score_bp
from pacbioassembly_tpu_torch.align.bitparallel import bp_score
from pacbioassembly_tpu_torch.align.bitscan import batch_score_bp
from pacbioassembly_tpu_torch.align.scan import batch_score

from test_bitparallel import _mutate
from test_scan import make_cases, pack
from torch_parity import assert_scores_match, batch_tensors, overlap_cases, random_cases
from torch_parity import pack as clipped_pack

torch.set_num_threads(1)


def _banded(a, b, ratio):
    ref = align_banded(a, b, ratio)
    return None if ref is None else (ref.cost, ref.matlen_a, ref.matlen_b, ref.diag_cost)


@pytest.mark.parametrize("ratio", [0.3, 0.15, 0.45])
def test_bp_score_matches_jax_and_banded(ratio):
    rng = np.random.default_rng(42)
    n_acc = 0
    for trial in range(150):
        a = rng.integers(0, 4, int(rng.integers(1, 90))).astype(np.uint8)
        if trial % 3 == 0:
            b = rng.integers(0, 4, int(rng.integers(1, 90))).astype(np.uint8)
        else:
            b = _mutate(rng, a)
        got = bp_score(a, b, ratio)
        assert got == jax_bp_score(a, b, ratio) == _banded(a, b, ratio), (trial, a, b)
        n_acc += got is not None
    assert n_acc > 30


def test_bp_score_long_reads():
    rng = np.random.default_rng(9)
    for t in range(6):
        n = int(rng.integers(700, 1600))
        a = rng.integers(0, 4, n).astype(np.uint8)
        b = _mutate(rng, a)
        if t % 3 == 1:
            b = b[: len(b) // 3]
        assert bp_score(a, b, 0.3) == jax_bp_score(a, b, 0.3) == _banded(a, b, 0.3), t


def test_batch_score_bp_matches_jax_and_banded():
    rng = np.random.default_rng(5)
    cases = make_cases(rng, 32, max_len=80)
    LA, LB, W = 96, 96, 32
    A, las, Bm, lbs = pack(cases, LA, LB)
    kw = dict(la_max=LA, w_max=W, ratio=0.3)
    got = batch_score_bp(*batch_tensors(A, las, Bm, lbs), **kw)
    assert assert_scores_match(got, jax_batch_score_bp(A, las, Bm, lbs, **kw), dp_rows=False) >= 10
    assert_scores_match(got, batch_score(*batch_tensors(A, las, Bm, lbs), **kw))
    acc = got.accept.numpy()
    for i, (a, b) in enumerate(cases):
        want = _banded(a, b, 0.3)
        assert acc[i] == (want is not None), i
        if want is not None:
            assert (int(got.cost[i]), int(got.matlen_a[i]), int(got.matlen_b[i]),
                    int(got.diag_cost[i])) == want, i


@pytest.mark.parametrize("LB, ratio", [(256, 0.3), (128, 0.45)])
def test_batch_score_bp_multiword_matches_scan(LB, ratio):
    """Stripes of 6 and 4 32-bit words (carries across words), overlaps at
    3% and 15% error, transposed and unrelated pairs, early failures, the
    plain scan's every field (its rejects and dp_rows too)."""
    rng = np.random.default_rng(LB)
    cases = overlap_cases(rng, 16, src_len=2 * LB, seg_lo=LB // 2, seg_hi=LB, err=0.03,
                          a_lo=LB // 4, a_hi=2 * LB)
    cases += overlap_cases(rng, 16, src_len=2 * LB, seg_lo=LB // 2, seg_hi=LB, err=0.15,
                           a_lo=LB // 4, a_hi=2 * LB)
    cases += random_cases(rng, 8, a_hi=2 * LB, b_hi=LB)
    W = 1 + int(LB * ratio)
    LA = LB + W + 1
    x = batch_tensors(*clipped_pack(cases, LA, LB))
    got = batch_score_bp(*x, la_max=LA, w_max=W, ratio=ratio)
    want = batch_score(*x, la_max=LA, w_max=W, ratio=ratio)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f).numpy(), f)
    assert 8 <= int(want.accept.sum()) < len(cases)
    assert int(((~want.accept) & (want.dp_rows > 10) & (want.dp_rows < LA)).sum()) > 0
