"""Port: align/traceback.py::batch_align_traceback (the screen, then K2 and
W from its goal cells; their plain versions on the CPU) against the JAX
package's batch_align_traceback (its XLA scan and walk) and the numpy
aligner, on tests/test_traceback.py's inputs: the scores, the full (B, E)
ops and vals (the zero padding too) and nedit equal; and bounding the
parent plane's rows (rows_max) changes nothing."""

import numpy as np
import pytest
import torch

from pacbioassembly_tpu.align.banded import align_banded
from pacbioassembly_tpu.align.scan import batch_score
from pacbioassembly_tpu.align.traceback import batch_align_traceback as jax_traceback
from pacbioassembly_tpu.align.types import DELETE
from pacbioassembly_tpu_torch.align.traceback import batch_align_traceback, traceback_width

from test_scan import make_cases, pack
from torch_parity import assert_scores_match, batch_tensors

torch.set_num_threads(1)


def _same_streams(port, ref):
    for f in ("ops", "vals", "nedit"):
        np.testing.assert_array_equal(getattr(port, f).numpy(), np.asarray(getattr(ref, f)), f)


@pytest.mark.parametrize("screen_kernel", ["bitwave", "rowdp"])
def test_traceback_matches_jax_and_numpy_edits(screen_kernel):
    rng = np.random.default_rng(17)
    cases = make_cases(rng, 24, max_len=56)
    LA, LB, W = 64, 64, 24
    A, las, Bm, lbs = pack(cases, LA, LB)
    kw = dict(la_max=LA, w_max=W, ratio=0.3)
    got = batch_align_traceback(*batch_tensors(A, las, Bm, lbs), screen_kernel=screen_kernel, **kw)
    want = jax_traceback(A, las, Bm, lbs, **kw)
    assert got.ops.shape == tuple(want.ops.shape) == (24, traceback_width(LA, W))
    assert got.ops.dtype == got.vals.dtype == torch.uint8
    # dp_rows follows the scan (the JAX traceback reports len_a)
    assert_scores_match(got.scores, batch_score(A, las, Bm, lbs, **kw))
    assert_scores_match(got.scores, want.scores, dp_rows=False)
    _same_streams(got, want)
    acc = got.scores.accept.numpy()
    ops, vals, ne = got.ops.numpy(), got.vals.numpy(), got.nedit.numpy()
    n_acc = 0
    for i, (a, b) in enumerate(cases):
        ref = align_banded(a, b, 0.3)
        assert acc[i] == (ref is not None), i
        if ref is None:
            assert ne[i] == 0 and not ops[i].any(), i
            continue
        assert ne[i] == ref.nedit, i
        np.testing.assert_array_equal(ops[i, : ne[i]], ref.ops, i)
        sel = ref.ops != DELETE
        np.testing.assert_array_equal(vals[i, : ne[i]][sel], ref.vals[sel], i)
        assert not ops[i, ne[i] :].any()
        n_acc += 1
    assert n_acc >= 10


def test_traceback_rows_max_equivalent():
    """rows_max >= max(la) bounds the plane and the stream width (the JAX
    E) without changing any stream; equal to the JAX function's bounded
    run, and an explicit e_max sets the width."""
    rng = np.random.default_rng(23)
    cases = make_cases(rng, 16, max_len=40)
    LA, LB, W = 128, 128, 40  # la_max far above the real lengths
    A, las, Bm, lbs = pack(cases, LA, LB)
    x = batch_tensors(A, las, Bm, lbs)
    rows = int(las.max())
    full = batch_align_traceback(*x, la_max=LA, w_max=W, ratio=0.3)
    bounded = batch_align_traceback(*x, la_max=LA, w_max=W, ratio=0.3, rows_max=rows)
    want = jax_traceback(A, las, Bm, lbs, la_max=LA, w_max=W, ratio=0.3, rows_max=rows)
    assert bounded.ops.shape[1] == traceback_width(LA, W, rows) < full.ops.shape[1]
    _same_streams(bounded, want)
    assert_scores_match(bounded.scores, want.scores, dp_rows=False)
    np.testing.assert_array_equal(full.nedit.numpy(), bounded.nedit.numpy())
    E = bounded.ops.shape[1]
    np.testing.assert_array_equal(full.ops.numpy()[:, :E], bounded.ops.numpy())
    np.testing.assert_array_equal(full.vals.numpy()[:, :E], bounded.vals.numpy())
    assert not full.ops.numpy()[:, E:].any()
    wide = batch_align_traceback(*x, la_max=LA, w_max=W, ratio=0.3, rows_max=rows, e_max=E + 64)
    assert wide.ops.shape[1] == E + 64
    np.testing.assert_array_equal(wide.ops.numpy()[:, :E], bounded.ops.numpy())
    assert int(full.scores.accept.sum()) >= 4
