"""Port: the engine's multi-device round. The port's BatchAssembler on an
8-shard CPU mesh (`make_mesh(devices=["cpu"] * 8)`), 6 rounds of
tests/torch_slice.py's fixture, with the device read matrix and without it
(host packing):

  * against the port's own single-device round (its default), every
    RoundStats field, every round's consensus, the votes and the surviving
    reads equal, and so does the launch log, launch for launch: the mesh
    round is the single-device round with each full screen split into 8
    equal shards (padded to 64 rows a shard) and the elect's streams
    padded to 8 a shard;
  * against the JAX BatchAssembler left unpinned on the suite's 8 virtual
    CPU devices (its own multi-device round, which skips the prefilter and
    re-runs commit chunks through its XLA traceback), every round's
    consensus, the votes, the surviving reads and each round's matches
    equal (tests/test_batch.py's multi- against single-device check)."""

import dataclasses
import io

import pytest
import torch

from pacbioassembly_tpu.assemble import ReadStore
from pacbioassembly_tpu.assemble.batch import BatchAssembler as JaxAssembler
from pacbioassembly_tpu_torch.align.screen import ladder_size
from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler
from pacbioassembly_tpu_torch.parallel import make_mesh, sharded

from torch_jax_native import jax_native_loader  # noqa: F401  (builds the JAX library aside)
from torch_slice import (
    assert_same_state,
    history_dicts,
    patterns,
    port_config,
    port_reads,
    slice_config,
    write_fixture,
)

torch.set_num_threads(1)
N_DEV = 8


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return write_fixture(tmp_path_factory.mktemp("torch_mesh"))


@pytest.fixture(scope="module")
def jax_mesh_run(fx):
    """The JAX engine on all 8 virtual devices: (engine, consensus)."""
    import jax

    assert len(jax.devices()) == N_DEV, "the suite runs on 8 virtual CPU devices"
    cfg = slice_config(fx)
    asm = JaxAssembler(cfg, ReadStore.from_file(fx["bin"], cfg), patterns())
    out = io.StringIO()
    asm.run(out=out)
    return asm, out.getvalue()


def _port_run(fx, materialize, mesh):
    """The port engine over `mesh` (None: its default), keeping each
    round's launch log and the rows of each screening shard: (engine,
    every round's consensus, per-round launch logs, shard rows)."""
    cfg = dataclasses.replace(port_config(slice_config(fx)), device_materialize=materialize)
    asm = BatchAssembler(cfg, port_reads(fx["bin"], cfg), patterns(), device="cpu", mesh=mesh)
    logs, shards = [], []
    real_round, real_score = BatchAssembler.run_round, sharded.score_batch

    def run_round(self, log=None):
        stats = real_round(self, log=log)
        logs.append(list(self.launch_log))
        return stats

    def score_spy(a, la, b, lb, **kw):
        shards.append(len(la))
        return real_score(a, la, b, lb, **kw)

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BatchAssembler, "run_round", run_round)
        mp.setattr(sharded, "score_batch", score_spy)
        asm.run(out=out)
    return asm, out.getvalue(), logs, shards


@pytest.mark.parametrize("materialize", [True, False], ids=["device_matrix", "host_packing"])
def test_mesh_engine_equals_single_device_and_jax_multi_device(fx, jax_mesh_run, materialize):
    single, s_out, s_logs, s_shards = _port_run(fx, materialize, None)
    asm, out, logs, shards = _port_run(fx, materialize, make_mesh(devices=["cpu"] * N_DEV))
    assert single.mesh.size == 1 and asm.mesh.size == N_DEV

    # one round with the single-device one
    assert len(asm.history) == 6
    assert history_dicts(asm) == history_dicts(single)
    assert out == s_out
    assert_same_state(asm, single)
    assert (asm.phase_s["prefilter_kept"] >= 0) == materialize
    screen = "fs" if materialize else "fs_host"
    for r, (log, s_log) in enumerate(zip(logs, s_logs), start=1):
        assert [e["kind"] for e in log] == [e["kind"] for e in s_log], r
        for e, se in zip(log, s_log):
            if e["kind"] == screen:
                assert e["shape"][0] == ladder_size(se["shape"][0], 64 * N_DEV), r
                assert e["shape"][1:] == se["shape"][1:], r
            elif e["kind"] == "elect":
                (Lc, Np, Ep, n), (Lc1, N, E, n1) = e["shape"], se["shape"]
                assert (Lc, n, n1) == (Lc1, N_DEV, 1), r
                assert (Np, Ep) == (ladder_size(N, 8 * N_DEV), ladder_size(E, 256)), r
            else:
                assert e["shape"] == se["shape"], r
    # every full screen went through 8 equal shards, and only there
    sizes = [e["shape"][0] for log in logs for e in log if e["kind"] == screen]
    assert sizes and shards == [s // N_DEV for s in sizes for _ in range(N_DEV)]
    assert s_shards == [e["shape"][0] for log in s_logs for e in log if e["kind"] == screen]

    # the results of the JAX engine's multi-device round
    ref, ref_out = jax_mesh_run
    assert out == ref_out
    assert_same_state(asm, ref)
    assert [s.nmatches for s in asm.history] == [s.nmatches for s in ref.history]
    assert asm.ref.length() > 3000
