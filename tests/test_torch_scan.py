"""Port: the plain PyTorch row DP (pacbioassembly_tpu_torch/align/scan.py)
against the JAX scan (pacbioassembly_tpu/align/scan.py) and the numpy
exactness root (align/banded.py). Integer fields, no tolerance."""

import numpy as np
import pytest
import torch

from pacbioassembly_tpu.align.banded import align_banded
from pacbioassembly_tpu.align.scan import batch_score as jax_batch_score
from pacbioassembly_tpu_torch.align.scan import INF, batch_score

from test_scan import make_cases, pack
from torch_parity import assert_scores_match, batch_tensors

torch.set_num_threads(1)


@pytest.mark.parametrize("ratio", [0.3, 0.15])
def test_plain_scan_matches_jax_scan_and_banded(ratio):
    rng = np.random.default_rng(11)
    cases = make_cases(rng, 40)
    LA, LB, W = 72, 72, 24
    A, las, Bm, lbs = pack(cases, LA, LB)
    ref = jax_batch_score(A, las, Bm, lbs, la_max=LA, w_max=W, ratio=ratio)
    port = batch_score(*batch_tensors(A, las, Bm, lbs), la_max=LA, w_max=W, ratio=ratio)
    assert assert_scores_match(port, ref) > 5
    for i, (a, b) in enumerate(cases):
        want = align_banded(a, b, ratio)
        assert bool(port.accept[i]) == (want is not None), i
        if want is not None:
            got = tuple(int(getattr(port, f)[i]) for f in ("cost", "matlen_a", "matlen_b", "diag_cost"))
            assert got == (want.cost, want.matlen_a, want.matlen_b, want.diag_cost), i


def test_plain_scan_rejects_band_overflow_and_canonicalizes():
    """max_dst beyond w_max rejects (reference MAXM rejection, dp_rows 0);
    every rejected pair carries the canonical (INF, 0, 0, -1) values."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 4, 64).astype(np.uint8)
    cases = [(a, a)] + make_cases(rng, 20)
    A, las, Bm, lbs = pack(cases, 72, 72)
    ref = jax_batch_score(A, las, Bm, lbs, la_max=72, w_max=10, ratio=0.3)
    port = batch_score(*batch_tensors(A, las, Bm, lbs), la_max=72, w_max=10, ratio=0.3)
    assert not bool(port.accept[0]) and int(port.dp_rows[0]) == 0
    assert_scores_match(port, ref)
    rej = ~port.accept
    assert rej.sum() > 0
    assert (port.cost[rej] == INF).all() and (port.matlen_a[rej] == 0).all()
    assert (port.matlen_b[rej] == 0).all() and (port.diag_cost[rej] == -1).all()


def test_plain_scan_empty_side_rejects_like_banded():
    """(la >= 1, lb = 0): the JAX scan accepts with matlen 0; the port
    rejects, as align/banded.py and the bit-parallel kernels do (recorded
    in ROADMAP.md queue C). Screening drops such pairs at overlap_min
    either way."""
    cases = [(np.array([1, 2, 3], np.uint8), np.zeros(0, np.uint8)),
             (np.zeros(0, np.uint8), np.array([1, 2, 3], np.uint8))]
    A, las, Bm, lbs = pack(cases, 8, 8)
    ref = jax_batch_score(A, las, Bm, lbs, la_max=8, w_max=4, ratio=0.3)
    port = batch_score(*batch_tensors(A, las, Bm, lbs), la_max=8, w_max=4, ratio=0.3)
    assert np.asarray(ref.accept).tolist() == [True, False]
    assert port.accept.tolist() == [False, False]
    assert all(align_banded(a, b, 0.3) is None for a, b in cases)
    np.testing.assert_array_equal(port.dp_rows.numpy(), np.asarray(ref.dp_rows))


def test_plain_scan_pair_results_independent_of_batch():
    """The working-set compaction (failed / finished pairs leave the row
    loop) must not couple pairs: each pair scored alone equals the pair
    scored inside the batch."""
    rng = np.random.default_rng(17)
    cases = make_cases(rng, 12, max_len=60)
    LA, LB, W = 72, 72, 24
    A, las, Bm, lbs = pack(cases, LA, LB)
    full = batch_score(*batch_tensors(A, las, Bm, lbs), la_max=LA, w_max=W, ratio=0.3)
    for i in range(len(cases)):
        one = batch_score(
            *batch_tensors(A[i : i + 1], las[i : i + 1], Bm[i : i + 1], lbs[i : i + 1]),
            la_max=LA, w_max=W, ratio=0.3,
        )
        for f in range(6):
            assert int(one[f][0]) == int(full[f][i]), (i, f)
