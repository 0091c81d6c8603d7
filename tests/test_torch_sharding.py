"""Port: the sharded screen and the summed elect on an 8-shard CPU mesh
(`make_mesh(devices=["cpu"] * 8)`), against the JAX package's sharded_*
on the suite's 8 virtual CPU devices, its single-device scan and the
serial ConsensusRef.elect, on tests/test_sharding.py's inputs (one case
each of its five tests). Integers are compared exactly."""

import numpy as np
import pytest
import torch

import pacbioassembly_tpu.parallel as jax_parallel
from pacbioassembly_tpu.align.scan import batch_score
from pacbioassembly_tpu.align.screen import ladder_size as jax_ladder_size
from pacbioassembly_tpu.consensus import ConsensusRef
from pacbioassembly_tpu_torch.align import screen
from pacbioassembly_tpu_torch.config import Constants
from pacbioassembly_tpu_torch.parallel import (
    assembly_step,
    make_mesh,
    sharded_elect,
    sharded_elect_packed,
    sharded_screen,
)

from test_scan import make_cases, pack
from test_sharding import _random_edit_streams
from torch_parity import assert_scores_match, batch_tensors

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def meshes():
    import jax

    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(devices=["cpu"] * 8), jax_parallel.make_mesh(8)


def _serial_elect(ops, vals, start, forward, enabled, L):
    ref = ConsensusRef(np.zeros(L, np.uint8), capacity=3 * L)
    base = [getattr(ref, f)[ref.pre : ref.post].copy() for f in ("sel", "sup", "total")]
    for i in range(len(start)):
        if enabled[i]:
            ne = int((ops[i] != 0).sum())
            ref.elect(int(start[i]), ops[i, :ne], vals[i, :ne], bool(forward[i]))
    return [getattr(ref, f)[ref.pre : ref.post] - b for f, b in zip(("sel", "sup", "total"), base)]


def test_sharded_screen_equals_jax_sharded_and_single(meshes):
    mesh, jmesh = meshes
    rng = np.random.default_rng(31)
    A, las, Bm, lbs = pack(make_cases(rng, 32, max_len=48), 56, 56)
    kw = dict(la_max=56, w_max=20, ratio=0.3)
    got = sharded_screen(mesh, A, las, Bm, lbs, **kw)
    assert got.accept.device.type == "cpu"
    want = jax_parallel.sharded_screen(jmesh, A, las, Bm, lbs, **kw)
    assert assert_scores_match(got, want) >= 8
    assert_scores_match(got, batch_score(A, las, Bm, lbs, **kw))


def test_sharded_elect_equals_jax_and_serial(meshes):
    mesh, jmesh = meshes
    rng = np.random.default_rng(7)
    L, E, N = 200, 24, 32
    ops, vals, start, forward = _random_edit_streams(rng, N, L, E)
    enabled = rng.integers(0, 2, N).astype(bool)
    got = sharded_elect(mesh, ops, vals, start, forward, enabled, L)
    want = jax_parallel.sharded_elect(jmesh, ops, vals, start, forward, enabled, L)
    serial = _serial_elect(ops, vals, start, forward, enabled, L)
    for f, s in zip(("sel", "sup", "total"), serial):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
        np.testing.assert_array_equal(getattr(got, f).numpy(), s, f)
    packed = sharded_elect_packed(mesh, ops, vals, start, forward, enabled, L)
    np.testing.assert_array_equal(packed.numpy(), np.concatenate(
        [serial[0], serial[1], serial[2][:, None]], axis=1))


def test_assembly_step_equals_jax(meshes):
    mesh, jmesh = meshes
    rng = np.random.default_rng(5)
    A, las, Bm, lbs = pack(make_cases(rng, 16, max_len=40), 48, 48)
    L, E = 128, 16
    ops, vals, start, forward = _random_edit_streams(rng, 16, L, E)
    kw = dict(la_max=48, w_max=16, L=L, overlap_min=8)
    scores, votes, n_accept = assembly_step(mesh, A, las, Bm, lbs, ops, vals, start, forward, **kw)
    jscores, jvotes, jn = jax_parallel.assembly_step(
        jmesh, A, las, Bm, lbs, ops, vals, start, forward, **kw)
    assert n_accept == int(jn) > 0
    assert_scores_match(scores, jscores)
    for f in ("sel", "sup", "total"):
        np.testing.assert_array_equal(getattr(votes, f).numpy(), np.asarray(getattr(jvotes, f)), f)
    assert votes.sel.shape == (L, 4)


def test_shard_sizes_balance_across_device_counts():
    """The engine pads a sharded screen to ladder_size(B, 64 n)
    (align/screen.py::pad_batch; the JAX engine's quantum and ladder), so
    that every shard gets exactly
    the same rows, a multiple of 64, with bounded overhead; pad rows cost
    one DP row and never vote."""
    for n_dev in (2, 4, 8):
        q = 64 * n_dev
        for B in (1, 63, 64, 100, 511, 512, 1000, 4096, 5000):
            Bp = screen.ladder_size(B, q)
            assert Bp == jax_ladder_size(B, q)
            assert Bp % n_dev == 0 and (Bp // n_dev) % 64 == 0
            assert B <= Bp < 2 * max(B, q)
    rng = np.random.default_rng(3)
    A, las, Bm, lbs = pack(make_cases(rng, 100, max_len=40), 48, 48)
    (a, b), la, lb, _ = screen.pad_batch([A, Bm], las, lbs, 64 * 4)
    assert a.shape == (256, 48) and b.shape == (256, 48)
    assert (la[100:] == 1).all() and (lb[100:] == 1).all() and not a[100:].any()
    res = sharded_screen(make_mesh(devices=["cpu"] * 4), a, la, b, lb, la_max=48, w_max=16,
                         ratio=0.3)
    # pad rows are cheap (one DP row) and can never pass overlap_min
    assert (res.dp_rows[100:] <= 1).all()
    assert not (res.accept[100:] & (res.matlen_a[100:] >= Constants.OVERLAP_MIN)).any()
    assert_scores_match(res, batch_score(a, la, b, lb, la_max=48, w_max=16, ratio=0.3))


def test_sharded_screen_per_device_shards_equal(meshes, monkeypatch):
    """Each shard's launch gets an equal contiguous row block on its own
    mesh device, in shard order; a batch that does not split evenly
    raises."""
    mesh, _ = meshes
    rng = np.random.default_rng(33)
    A, las, Bm, lbs = pack(make_cases(rng, 64, max_len=48), 56, 56)
    launches = []
    real = screen.score_batch

    def spy(a, la, b, lb, **kw):
        launches.append((a.device, la.clone()))
        return real(a, la, b, lb, **kw)

    import pacbioassembly_tpu_torch.parallel.sharded as sharded

    monkeypatch.setattr(sharded, "score_batch", spy)
    sharded_screen(mesh, A, las, Bm, lbs, la_max=56, w_max=20, ratio=0.3)
    assert [d.type for d, _ in launches] == ["cpu"] * 8
    assert [len(x) for _, x in launches] == [64 // 8] * 8
    np.testing.assert_array_equal(torch.cat([x for _, x in launches]).numpy(), las)
    with pytest.raises(ValueError, match="equal shards"):
        sharded_screen(mesh, *batch_tensors(A[:60], las[:60], Bm[:60], lbs[:60]), la_max=56,
                       w_max=20, ratio=0.3)
