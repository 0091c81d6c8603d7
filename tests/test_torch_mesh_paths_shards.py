"""Port: the mesh paths of the multi-device dry run (`__graft_entry__.py`,
part 3) on an 8-shard CPU mesh, `make_mesh(devices=["cpu"] * 8)` (M8),
against the port's own one-shard runs, on tests/torch_mesh_paths.py's
two-segment store with edge retreat on (tests/test_torch_mesh_paths.py
holds M8 to the JAX package's 8-device runs):

  (a) the retreat run (the first contig's engine of (b)) equals the one-shard
      run on every RoundStats field, the consensus, the votes, the surviving
      reads, the retreat counters, the log and the launch log, launch for
      launch: every full screen of every contig is split into 8 equal shards
      of ladder_size(B, 64 * 8) / 8 rows (on this store the rounds after a
      trim find no candidates, so no screen follows a trim);
  (b) `assemble_contigs(..., 3, mesh=M8)` equals `mesh=None` with and
      without the dedupe: every ContigResult, the surviving reads, the log;
  (c) a checkpoint saved at round 2 on M8 and resumed to round 6 on M8
      equals 6 uninterrupted rounds on M8, the retreat counters included;
      resumed on one shard it gives the same state (the checkpoint holds
      nothing of the mesh).

And a mesh that does not start on the engine's device is refused."""

import pytest
import torch

from pacbioassembly_tpu_torch.align.screen import ladder_size
from pacbioassembly_tpu_torch.assemble.batch import assemble_contigs
from pacbioassembly_tpu_torch.parallel import make_mesh

from torch_mesh_paths import (
    CHECKPOINT,
    N_CONTIGS,
    checkpoint_runs,
    config,
    contig0_log,
    contigs_run,
    counters,
    patterns,
    port_reads,
    records,
)
from torch_retreat import retreat_lines
from torch_slice import assert_same_state, history_dicts

torch.set_num_threads(1)
N_DEV = 8


def shapes(launches) -> dict:
    """Launch logs without their times."""
    return {ci: [[(e["kind"], e["shape"]) for e in rl] for rl in rounds]
            for ci, rounds in launches.items()}


def m8():
    return make_mesh(devices=["cpu"] * N_DEV)


@pytest.fixture(scope="module")
def data():
    return records()


@pytest.fixture(scope="module")
def runs(data):
    """`assemble_contigs(..., 3, dedupe=True)` on one shard and on M8."""
    return {"single": contigs_run(data, None), "mesh": contigs_run(data, m8())}


def test_retreat_run_on_mesh_equals_single_device(runs):
    single, mesh = runs["single"], runs["mesh"]
    s_asm, asm = single["engines"][0], mesh["engines"][0]
    assert s_asm.mesh.size == 1 and asm.mesh.size == N_DEV
    assert (asm.nround, asm.retreats, asm.ref.length(), len(asm.surviving)) == (10, 2, 5581, 85)
    assert history_dicts(asm) == history_dicts(s_asm)
    assert_same_state(asm, s_asm)
    assert counters(asm) == counters(s_asm)
    log = contig0_log(mesh["log"])
    assert log == contig0_log(single["log"]) and len(retreat_lines(log)) == 2

    # the launch log, launch for launch, over every contig: full screens
    # padded to 64 rows a shard, the elect's streams to 8 a shard; the
    # rest as on one shard
    assert mesh["launches"].keys() == single["launches"].keys() == {0, 1, 2}
    for ci, rounds in mesh["launches"].items():
        s_rounds = single["launches"][ci]
        assert len(rounds) == len(s_rounds) == mesh["engines"][ci].nround
        for r, (rl, s_rl) in enumerate(zip(rounds, s_rounds), start=1):
            assert [e["kind"] for e in rl] == [e["kind"] for e in s_rl], (ci, r)
            for e, se in zip(rl, s_rl):
                if e["kind"] == "fs":
                    assert e["shape"][0] == ladder_size(se["shape"][0], 64 * N_DEV), (ci, r)
                    assert e["shape"][1:] == se["shape"][1:], (ci, r)
                elif e["kind"] == "elect":
                    (Lc, Np, Ep, n), (Lc1, N, E, n1) = e["shape"], se["shape"]
                    assert (Lc, n, n1) == (Lc1, N_DEV, 1), (ci, r)
                    assert (Np, Ep) == (ladder_size(N, 8 * N_DEV), ladder_size(E, 256)), (ci, r)
                else:
                    assert e["shape"] == se["shape"], (ci, r)
        # every full screen went through 8 equal shards, and only there
        sizes = [e["shape"][0] for rl in rounds for e in rl if e["kind"] == "fs"]
        assert sizes and mesh["shards"][ci] == [s // N_DEV for s in sizes for _ in range(N_DEV)]
        assert single["shards"][ci] == [
            e["shape"][0] for rl in s_rounds for e in rl if e["kind"] == "fs"]


def test_contigs_on_mesh_equal_single_device(runs):
    single, mesh = runs["single"], runs["mesh"]
    got = (mesh["contigs"], mesh["surviving"], mesh["log"])
    assert got == (single["contigs"], single["surviving"], single["log"])
    # the dry run's: 2 contigs, one a segment, every read consumed; the
    # third (one read) contained in the second and dropped
    assert [len(c[0]) for c in mesh["contigs"]] == [5581, 5566] and mesh["surviving"] == []
    assert mesh["log"].count("=== contig ") == N_CONTIGS
    assert mesh["log"].count("=== dropping contig") == 1
    for asm, s_asm in zip(mesh["engines"], single["engines"]):
        assert history_dicts(asm) == history_dicts(s_asm)
        assert_same_state(asm, s_asm)


def test_contigs_on_mesh_without_dedupe_equal_single_device(data, runs):
    """`dedupe=False` on M8 against the one-shard run of `runs`: the dedupe
    acts only on the finished contigs, so that run's engines are the
    one-shard engines of `dedupe=False`. Every contig is returned, the
    third one too, and the log has no dropping line."""
    single = runs["single"]
    mesh = contigs_run(data, m8(), dedupe=False)
    e1, e2 = single["engines"][1:]
    want = single["contigs"][:2] + [
        (e2.ref.text().tolist(), len(e1.surviving) - len(e2.surviving), e2.nround)]
    assert mesh["contigs"] == want and [len(c[0]) for c in want] == [5581, 5566, 556]
    assert mesh["surviving"] == single["surviving"] == []
    assert mesh["log"] == "".join(
        ln for ln in single["log"].splitlines(True) if not ln.startswith("=== dropping"))
    assert shapes(mesh["launches"]) == shapes(runs["mesh"]["launches"])
    for asm, s_asm in zip(mesh["engines"], single["engines"]):
        assert history_dicts(asm) == history_dicts(s_asm)
        assert_same_state(asm, s_asm)


def test_checkpoint_resumed_on_mesh_equals_uninterrupted(data, tmp_path):
    runs = checkpoint_runs(data, str(tmp_path / "ck.npz"), m8())
    full = runs["full"]
    assert runs["saved"].nround == CHECKPOINT["saved"]
    assert full.nround == CHECKPOINT["rounds"] and full.mesh.size == N_DEV
    for name in ("resumed", "resumed_1"):
        resumed = runs[name]
        assert resumed.mesh.size == (N_DEV if name == "resumed" else 1)
        assert history_dicts(resumed) == history_dicts(full)[CHECKPOINT["saved"]:], name
        assert_same_state(resumed, full)
        assert counters(resumed) == counters(full), name


def test_mesh_must_start_on_the_engines_device(data, monkeypatch):
    """The device read matrix, the prefilter and K2 + W run on the engine's
    device, and sharded results come back to the mesh's first device: a
    mesh that starts elsewhere is refused, never moved to quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for device, mesh in (("cpu", ["cuda:0", "cuda:0"]), ("cuda:0", ["cpu"] * 2),
                         ("cuda", ["cuda:1", "cuda:0"])):
        with pytest.raises(ValueError, match="starts on"):
            assemble_contigs(config(), port_reads(data), patterns(), N_CONTIGS,
                             device=device, mesh=make_mesh(devices=mesh))
