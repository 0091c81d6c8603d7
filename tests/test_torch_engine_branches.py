"""Port: the batch engine's branches off its main path, held to the JAX
batch engine on tests/torch_branches.py's cases (synth2 with the quirks of
tests/test_pipeline_variants.py):

  * `locked` (`-l`), `dump` (`-d`, ratio 0.25, 16 trials) and
    `host_traceback` (`device_traceback=False`): the port's
    BatchAssembler(device="cpu") and the JAX BatchAssembler pinned to one
    device agree on the printed consensus, the dump's bytes, every
    RoundStats field, the surviving reads and the votes (sel, sup, total);
  * under `locked` the output also equals golden_consensus_locked.txt under
    the test's newline-as-'T' rule and the votes stay bit-untouched; under
    `locked` and `host_traceback` every alignment goes through the host
    try_align and K2 and W never launch; the dump is written on both of
    its paths, the device commit's and the host's;
  * the serial guard of the two-thread commit: with `parallel_commit=True`
    under a locked reference, a dump stream or `quirk_stale_dp`, the commit
    of tests/torch_contigs.py's boundary case (which the two-thread commit
    splits when no guard holds) stays serial and equals
    `parallel_commit=False`;
  * `locked` on an 8-shard CPU mesh equals its one-shard run;
  * the port's CLI `assemble --engine batch -l` and `-d FILE` equal the
    JAX CLI's (here rather than in tests/test_torch_cli.py: the JAX CLI
    reuses this module's XLA compiles of the same shapes, about 35 s less).

Each JAX run happens once for the module, with the JAX native library built
aside (tests/torch_jax_native.py)."""

import io

import numpy as np
import pytest
import torch

import pacbioassembly_tpu_torch.assemble.batch as port_batch
from pacbioassembly_tpu_torch import _build
from pacbioassembly_tpu_torch.parallel import make_mesh

from torch_branches import (
    CASES,
    GOLDEN_LOCKED,
    INIT,
    PATTERNS,
    READS,
    golden_match,
    port_run,
    settings,
)
from torch_contigs import boundary_commit_case
from torch_jax_native import jax_native_loader  # noqa: F401  (builds the JAX library aside)
from torch_slice import assert_same_state, history_dicts

torch.set_num_threads(1)
VOTES = ("sel", "sup", "total")


@pytest.fixture(scope="module")
def jax_runs(jax_native_loader):  # noqa: F811
    """The JAX batch engine on every case, pinned to one device: {case:
    (engine, out, dump)}."""
    import jax

    from pacbioassembly_tpu.assemble import ReadStore
    from pacbioassembly_tpu.assemble.batch import BatchAssembler
    from pacbioassembly_tpu.codec.dna import load_patterns
    from pacbioassembly_tpu.config import AssemblyConfig

    runs = {}
    dev0 = jax.devices()[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a, **k: [dev0])
        for case in CASES:
            cfg = AssemblyConfig(**settings(case))
            dump = io.StringIO() if cfg.dump_path else None
            asm = BatchAssembler(cfg, ReadStore.from_file(READS, cfg), load_patterns(PATTERNS),
                                 dump=dump)
            out = io.StringIO()
            asm.run(out=out)
            runs[case] = (asm, out.getvalue(), dump.getvalue() if dump else "")
    return runs


@pytest.fixture(scope="module")
def port_runs():
    """The port's run of every case on the CPU, with the launches it made."""
    runs = {}
    for case in CASES:
        _build.reset_counts()
        runs[case] = port_run(case)
        runs[case]["launches"] = dict(_build.LAUNCHES)
    return runs


def assert_equal_runs(got: dict, want) -> None:
    asm, out, dump = want
    assert got["out"] == out
    assert got["dump"] == dump
    assert history_dicts(got["engine"]) == history_dicts(asm)
    assert_same_state(got["engine"], asm)


@pytest.mark.parametrize("case", list(CASES))
def test_branch_equals_jax(case, port_runs, jax_runs):
    got = port_runs[case]
    assert_equal_runs(got, jax_runs[case])
    asm, commits, launches = got["engine"], got["commits"], got["launches"]
    assert asm.history and len(commits) == len(asm.history)
    assert launches["plain_batch_score"] > 0
    assert sum(c["host_aligns"] for c in commits) > 0
    if case == "locked":
        # the golden of the exact engine, the votes bit-untouched
        assert golden_match(open(GOLDEN_LOCKED).read(), got["out"])
        for f, v0 in zip(VOTES, got["votes0"]):
            np.testing.assert_array_equal(getattr(asm.ref, f), v0)
        assert len(asm.surviving) < 60
    if case in ("locked", "host_traceback"):
        # every alignment through the host try_align: no K2, no W
        assert all(c["device_commits"] == 0 for c in commits)
        assert launches["plain_parents"] == launches["plain_walk"] == 0
    else:
        # the dump: written by the device commit and by the host path
        assert sum(c["device_commits"] for c in commits) > 0
        assert launches["plain_parents"] == launches["plain_walk"] > 0
        assert set(got["dump_sites"]) == {"commit", "run"}
        assert len(got["dump"]) == 81_829


@pytest.mark.parametrize("guard", ["locked", "dump", "quirk_stale_dp"])
def test_two_thread_commit_guard_keeps_the_commit_serial(guard, monkeypatch):
    """The boundary case splits in two threads when no guard holds
    (tests/test_torch_contigs.py); under each guard it stays serial and
    gives what the serial commit gives."""
    from pacbioassembly_tpu_torch.assemble import ReadStore
    from pacbioassembly_tpu_torch.codec import dna
    from pacbioassembly_tpu_torch.config import AssemblyConfig
    from pacbioassembly_tpu_torch.consensus import ConsensusRef

    L, ref_codes, blob, cand_rows = boundary_commit_case()
    splits = []

    class CountingPool(port_batch.ThreadPoolExecutor):
        def __init__(self, *a, **k):
            splits.append(k.get("max_workers"))
            super().__init__(*a, **k)

    monkeypatch.setattr(port_batch, "ThreadPoolExecutor", CountingPool)

    def commit(parallel, guarded):
        cfg = AssemblyConfig(engine="batch", rng_seed=0, parallel_commit=parallel,
                             max_seq_len=400_000,
                             quirk_stale_dp=guarded and guard == "quirk_stale_dp")
        ref = ConsensusRef(ref_codes, capacity=3 * 400_000,
                           locked=guarded and guard == "locked")
        dump = io.StringIO() if guarded and guard == "dump" else None
        asm = port_batch.BatchAssembler(
            cfg, ReadStore(np.frombuffer(blob, np.uint8)),
            [dna.parse_pattern("1111111111111111")], ref=ref, dump=dump, device="cpu")
        cands = port_batch.CandidateBatch(
            read=[r for r, _, _, _ in cand_rows], j=[j for _, j, _, _ in cand_rows],
            forward=[f for _, _, f, _ in cand_rows], r_offset=[p for _, _, _, p in cand_rows],
            rank=[0] * len(cand_rows),
        )
        nal, consumed = asm._commit_host(cands, [(i, [i]) for i in range(len(cand_rows))])
        r = asm.ref
        return (nal, consumed, r.buf[r.pre : r.post].tolist(),
                *(getattr(r, f)[r.pre : r.post].tolist() for f in VOTES),
                dump.getvalue() if dump else None)

    assert commit(True, False) is not None and splits == [2]  # unguarded: split
    serial = commit(False, True)
    assert commit(True, True) == serial and splits == [2]
    assert serial[0] == len(cand_rows) and len(serial[1]) == len(cand_rows)
    if guard == "dump":
        assert serial[-1].count("\n") == 2 * len(cand_rows)


def test_locked_on_mesh_equals_single_device(port_runs):
    single = port_runs["locked"]
    got = port_run("locked", mesh=make_mesh(devices=["cpu"] * 8))
    assert got["engine"].mesh.size == 8
    assert got["out"] == single["out"]
    assert history_dicts(got["engine"]) == history_dicts(single["engine"])
    assert_same_state(got["engine"], single["engine"])
    counts = [[(c["host_aligns"], c["device_commits"]) for c in run["commits"]]
              for run in (got, single)]
    assert counts[0] == counts[1]


@pytest.mark.parametrize("flag", ["-l", "-d"], ids=["lock", "dump"])
def test_cli_branch_flags_match_jax(flag, tmp_path, monkeypatch, capsys):
    """`assemble --engine batch -l` and `-d FILE` on synth2 with the quirk
    flags of tests/test_pipeline_variants.py (tests/torch_branches.py), the
    JAX CLI pinned to one device: stdout and stderr (the round log) byte
    for byte, and the dump files' bytes (written by the device commit and by
    the host path)."""
    import jax

    from pacbioassembly_tpu.tools import cli as jax_cli
    from pacbioassembly_tpu_torch.tools.cli import main

    dev0 = jax.devices()[0]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev0])
    base = ["assemble", READS, PATTERNS, "--engine", "batch", "--schedule", "roundrobin",
            "-f", INIT, "--quirk-seed-at", "--quirk-init-newline"]
    dumps = {}
    for name, cli, extra in (("jax", jax_cli.main, []), ("port", main, ["--device", "cpu"])):
        if flag == "-l":
            argv = base + ["-l", "-m", "5"]
        else:
            dumps[name] = str(tmp_path / f"{name}.dump")
            argv = base + ["-d", dumps[name], "-r", "0.25", "-t", "16", "-m", "10"]
        assert cli(argv + extra) == 0
        dumps[name + "_out"] = capsys.readouterr()
    got, want = dumps["port_out"], dumps["jax_out"]
    assert got.out == want.out and got.err == want.err
    assert got.out and "--- batch round 1:" in got.err
    if flag == "-d":
        got, want = (open(dumps[n], "rb").read() for n in ("port", "jax"))
        assert got == want and len(got) > 0
