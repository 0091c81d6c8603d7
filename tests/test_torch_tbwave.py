"""Port: the plain parent plane and walk (pacbioassembly_tpu_torch/align/
tbwave.py) against the JAX Pallas parent kernel in interpret mode, the
JAX device walk (align/tbwave.py::walk_parents) and the XLA traceback
(align/traceback.py::batch_align_traceback). Bit-equal planes and
byte-equal edit streams, no tolerance."""

import numpy as np
import torch

from pacbioassembly_tpu.align.scan import batch_score as jax_scan
from pacbioassembly_tpu.align.tbwave import batch_parents_pallas, walk_parents
from pacbioassembly_tpu.align.traceback import batch_align_traceback
from pacbioassembly_tpu_torch.align.tbwave import batch_parents, walk_parents_plain

from test_scan import make_cases, pack
from torch_parity import T, batch_tensors

torch.set_num_threads(1)


def _multi_block_cases():
    """Long enough to cross several 16-row blocks and a 128-row window,
    with mixed lengths in one batch (tests/test_tbwave.py's fixture)."""
    rng = np.random.default_rng(34)
    cases = []
    for ln in (40, 150, 260, 300, 299, 256):
        a = rng.integers(0, 4, ln).astype(np.uint8)
        b = a.copy()
        nmut = max(1, ln // 15)
        pos = rng.choice(ln, nmut, replace=False)
        b[pos] = (b[pos] + rng.integers(1, 4, nmut)) % 4
        b = np.delete(b, rng.choice(len(b), 2, replace=False))
        b = np.insert(b, rng.integers(0, len(b)), rng.integers(0, 4))
        cases.append((a, b))
    return cases


def check_plane_and_walk(cases, LA, LB, W, rows_max, E=None):
    """Plain plane == JAX plane bit for bit; plain walk == JAX walk (ops,
    vals, nedit over the whole buffer) from the JAX scan's goal cells.
    E defaults to the engine's buffer size for the plane. Returns the
    inputs, the port's plane and geometry, the goal cells and the walk."""
    A, las, Bm, lbs = pack(cases, LA, LB)
    pj, mdj, lbj = batch_parents_pallas(
        A, las, Bm, lbs, la_max=LA, w_max=W, ratio=0.3, rows_max=rows_max, interpret=True
    )
    pt, mdt, lbt = batch_parents(
        *batch_tensors(A, las, Bm, lbs), la_max=LA, w_max=W, ratio=0.3, rows_max=rows_max
    )
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))  # the whole plane
    np.testing.assert_array_equal(mdt.numpy(), np.asarray(mdj))
    np.testing.assert_array_equal(lbt.numpy(), np.asarray(lbj))

    sc = jax_scan(A, las, Bm, lbs, la_max=LA, w_max=W, ratio=0.3)
    goal = [np.asarray(x) for x in (sc.matlen_a, sc.matlen_b, sc.accept)]
    E = E or pj.shape[1] * 16 + W + 2 + 32
    oj, vj, nj = walk_parents(pj, Bm, lbj, mdj, *goal, w_max=W, e_max=E)
    walk = walk_parents_plain(pt, T(Bm), lbt, mdt, *(T(g) for g in goal), w_max=W, e_max=E)
    for x, y in zip(walk, (oj, vj, nj)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    return (A, las, Bm, lbs), goal, walk


def test_parent_plane_walk_and_traceback_match_jax():
    cases = make_cases(np.random.default_rng(33), 24, max_len=60)
    LA, LB, W = 128, 80, 28
    (A, las, Bm, lbs), goal, (ot, vt, nt) = check_plane_and_walk(cases, LA, LB, W, None)
    # against the XLA traceback pass (itself pinned to align/banded.py)
    ref = batch_align_traceback(A, las, Bm, lbs, la_max=LA, w_max=W, ratio=0.3)
    acc = np.asarray(ref.scores.accept)
    np.testing.assert_array_equal(acc, goal[2])
    assert acc.sum() >= 5
    for i in np.nonzero(acc)[0]:
        ne = int(np.asarray(ref.nedit)[i])
        assert int(nt[i]) == ne, i
        np.testing.assert_array_equal(ot[i, :ne].numpy(), np.asarray(ref.ops)[i, :ne])
        np.testing.assert_array_equal(vt[i, :ne].numpy(), np.asarray(ref.vals)[i, :ne])
