"""Port: the mesh paths of the multi-device dry run (`__graft_entry__.py`,
part 3) against the JAX package on its 8 virtual CPU devices. On
tests/torch_mesh_paths.py's two-segment store with edge retreat on, the
port's `assemble_contigs(..., 3, dedupe=True, mesh=M8)`, M8 being
`make_mesh(devices=["cpu"] * 8)`, equals the JAX `assemble_contigs` left
unpinned on the suite's 8 devices (its own multi-device round):

  (a) the first contig's engine is the dry run's retreat run (the same
      config and seed, built the same way): 10 rounds, 2 retreats, 5,581 bp,
      85 reads left; every RoundStats field, the consensus, the votes, the
      surviving reads, the retreat counters and its log lines equal;
  (b) every ContigResult, the surviving reads and the whole log equal: 3
      contigs, the third (one read, 556 bp) dropped by the dedupe.

tests/test_torch_mesh_paths_shards.py holds M8 to one shard on the same
paths, checkpoint and resume included. The JAX reference runs once for the
module, with the JAX native library built aside (tests/torch_jax_native.py)."""

import io

import pytest
import torch

from pacbioassembly_tpu_torch.parallel import make_mesh

from torch_jax_native import jax_native_loader  # noqa: F401  (builds the JAX library aside)
from torch_mesh_paths import (
    N_CONTIGS,
    SETTINGS,
    contig0_log,
    contig_rows,
    contigs_run,
    counters,
    kept_engines,
    patterns,
    records,
)
from torch_retreat import retreat_lines
from torch_slice import assert_same_state, history_dicts

torch.set_num_threads(1)
N_DEV = 8


@pytest.fixture(scope="module")
def data():
    return records()


@pytest.fixture(scope="module")
def jax_run(data, jax_native_loader):  # noqa: F811
    """The JAX `assemble_contigs(..., 3, dedupe=True)` on all 8 virtual
    devices: (engines, contigs, surviving, log)."""
    import jax
    import numpy as np

    from pacbioassembly_tpu.assemble import ReadStore
    from pacbioassembly_tpu.assemble.batch import BatchAssembler as JaxAssembler
    from pacbioassembly_tpu.assemble.batch import assemble_contigs as jax_assemble_contigs
    from pacbioassembly_tpu.config import AssemblyConfig

    assert len(jax.devices()) == N_DEV, "the suite runs on 8 virtual CPU devices"
    init, engines = kept_engines(JaxAssembler)
    log = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxAssembler, "__init__", init)
        contigs, surv = jax_assemble_contigs(
            AssemblyConfig(**SETTINGS), ReadStore(np.frombuffer(data, dtype=np.uint8)),
            patterns(), N_CONTIGS, log=log, dedupe=True)
    return engines, contigs, surv, log.getvalue()


@pytest.fixture(scope="module")
def mesh_run(data):
    return contigs_run(data, make_mesh(devices=["cpu"] * N_DEV))


def test_retreat_run_on_mesh_equals_jax_multi_device(mesh_run, jax_run):
    asm, ref = mesh_run["engines"][0], jax_run[0][0]
    assert asm.mesh.size == N_DEV
    assert (asm.nround, asm.retreats, asm.ref.length(), len(asm.surviving)) == (10, 2, 5581, 85)
    assert history_dicts(asm) == history_dicts(ref)
    assert_same_state(asm, ref)
    assert counters(asm) == counters(ref)
    log = contig0_log(mesh_run["log"])
    assert log == contig0_log(jax_run[3]) and len(retreat_lines(log)) == 2


def test_contigs_on_mesh_equal_jax_multi_device(mesh_run, jax_run):
    engines, want, want_surv, want_log = jax_run
    assert mesh_run["contigs"] == contig_rows(want)
    assert mesh_run["surviving"] == want_surv == []
    assert mesh_run["log"] == want_log
    assert [len(c[0]) for c in mesh_run["contigs"]] == [5581, 5566]
    assert len(mesh_run["engines"]) == len(engines) == N_CONTIGS
    assert "=== dropping contig 2 (556 bp)" in want_log
    for asm, ref in zip(mesh_run["engines"], engines):
        assert history_dicts(asm) == history_dicts(ref)
        assert_same_state(asm, ref)
