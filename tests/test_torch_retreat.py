"""Port: the batch engine's stall recovery (edge retreat) held to the JAX
engine on the CPU, on fixture (a) of tests/torch_retreat.py: the stall
store, where every pattern fails from round 12 to round 19 and the retreat
trims the contig's single-read fringe after round 19.

Both engines run rounds 1-19 with a checkpoint on the retreat round (the
engine saves after the retreat's bookkeeping, so the checkpoint holds the
trimmed contig), then round 20 on the trimmed contig. They agree on every
RoundStats field, the contig bytes, the votes, the surviving reads, the
retreat counters and the log, `--- edge retreat` line included. Then (d)
each engine resumes from the other's round-19 checkpoint and replays round
20 of the uninterrupted run. The JAX engine is pinned to one CPU device (its
single-device round) and reaches its native library built aside
(tests/torch_jax_native.py)."""

import dataclasses
import io

import pytest
import torch

from torch_jax_native import jax_native_loader  # noqa: F401  (builds the JAX library aside)
from torch_retreat import (
    STALL,
    STALL_RETREAT_ROUND,
    STALL_ROUNDS,
    retreat_lines,
    stall_patterns,
    stall_records,
    write_records,
)
from torch_slice import assert_same_state, history_dicts, port_config, port_reads

torch.set_num_threads(1)


def counters(asm) -> tuple:
    return (asm.nround, asm.nfailure, asm.retreats, asm.fruitless_retreats,
            asm.matches_since_retreat)


def jax_engine(cfg, path):
    from pacbioassembly_tpu.assemble import ReadStore
    from pacbioassembly_tpu.assemble.batch import BatchAssembler

    return BatchAssembler(cfg, ReadStore.from_file(path, cfg), stall_patterns())


def port_engine(cfg, path):
    from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler

    cfg = port_config(cfg)
    return BatchAssembler(cfg, port_reads(path, cfg), stall_patterns(), device="cpu")


@pytest.fixture(scope="module")
def stall(tmp_path_factory, jax_native_loader):  # noqa: F811
    """Both engines' uninterrupted runs: (engines, logs, checkpoint paths)."""
    import jax

    from pacbioassembly_tpu.config import AssemblyConfig

    tmp = tmp_path_factory.mktemp("stall")
    path = write_records(tmp, "stall.bin", stall_records())
    engines, logs, ckpts = {}, {}, {}
    with pytest.MonkeyPatch.context() as mp:
        dev0 = jax.devices()[0]
        mp.setattr(jax, "devices", lambda *a, **k: [dev0])
        for name, make in (("jax", jax_engine), ("port", port_engine)):
            ckpts[name] = str(tmp / f"{name}_round{STALL_RETREAT_ROUND}.npz")
            cfg = AssemblyConfig(**STALL, max_round=STALL_RETREAT_ROUND,
                                 checkpoint_path=ckpts[name],
                                 checkpoint_every=STALL_RETREAT_ROUND)
            asm = make(cfg, path)
            log = io.StringIO()
            asm.run(out=io.StringIO(), log=log)
            # the same engine goes on past the retreat, with no checkpoint
            asm.cfg = dataclasses.replace(asm.cfg, max_round=STALL_ROUNDS, checkpoint_path=None)
            asm.run(out=io.StringIO(), log=log)
            engines[name], logs[name] = asm, log.getvalue()
    return dict(engines=engines, logs=logs, ckpts=ckpts, path=path)


def test_stall_retreat_equals_jax(stall):
    jax_asm, port = stall["engines"]["jax"], stall["engines"]["port"]
    assert port.nround == STALL_ROUNDS
    assert history_dicts(port) == history_dicts(jax_asm)
    assert_same_state(port, jax_asm)
    assert counters(port) == counters(jax_asm)
    assert stall["logs"]["port"] == stall["logs"]["jax"]
    # not vacuous: one retreat, after the retreat round, that trimmed the contig
    lines = retreat_lines(stall["logs"]["port"])
    assert port.retreats == 1 and len(lines) == 1, lines
    stalled = port.history[STALL_RETREAT_ROUND - 1].ref_len
    assert all(s.nmatches == 0 for s in port.history[11:STALL_RETREAT_ROUND])
    assert lines[0] == (f"--- edge retreat 1: trimmed {stalled - port.history[-1].ref_len} "
                        f"low-support cells, ref_len={port.history[-1].ref_len}")
    assert port.history[-1].ref_len < stalled


@pytest.mark.parametrize("saved_by, resumed_by", [("jax", "port"), ("port", "jax")])
def test_retreat_checkpoint_resumes_across_engines(stall, saved_by, resumed_by, monkeypatch):
    """(d): the checkpoint saved on the retreat round by one engine, resumed
    by the other, replays the uninterrupted run's round 20."""
    import jax

    from pacbioassembly_tpu.config import AssemblyConfig

    dev0 = jax.devices()[0]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev0])
    make = {"jax": jax_engine, "port": port_engine}[resumed_by]
    cfg = AssemblyConfig(**STALL, max_round=STALL_ROUNDS, resume_path=stall["ckpts"][saved_by])
    asm = make(cfg, stall["path"])
    log = io.StringIO()
    asm.run(out=io.StringIO(), log=log)
    full = stall["engines"][resumed_by]
    assert asm.history[0].nround == STALL_RETREAT_ROUND + 1
    assert history_dicts(asm) == history_dicts(full)[STALL_RETREAT_ROUND:]
    assert_same_state(asm, full)
    assert counters(asm) == counters(full) and asm.retreats == 1
    assert log.getvalue() == "".join(
        ln + "\n" for ln in stall["logs"][resumed_by].splitlines()[-1:])
