"""Port: the stall recovery's gates held to the JAX engine on the CPU
(fixtures (b) and (c) of tests/torch_retreat.py).

(b) The fruitless store: the contig starts from a junk read, so no retreat
    finds a weak fringe to trim and each takes the fixed bite
    (ConsensusRef.retreat_fixed); after two retreats in a row with no match
    the escape (edge_retreat_fruitless) ends the run with most of the
    retreat budget unspent.
(c) The stall store resumed from the port's round-18 checkpoint with
    edge_retreat_min_len above the contig's length: round 19 stalls as in
    (a), the retreat that (a) takes there is refused and the run stops.

Each engine gives the same RoundStats, contig bytes, votes, surviving
reads, retreat counters and log. The JAX engine is pinned to one CPU device
and reaches its native library built aside (tests/torch_jax_native.py)."""

import dataclasses
import io

import pytest
import torch

from torch_jax_native import jax_native_loader  # noqa: F401  (builds the JAX library aside)
from torch_retreat import (
    FRUITLESS,
    STALL,
    STALL_MIN_LEN,
    STALL_RETREAT_ROUND,
    fruitless_patterns,
    fruitless_records,
    retreat_lines,
    stall_patterns,
    stall_records,
    write_records,
)
from torch_slice import assert_same_state, history_dicts, port_config, port_reads

torch.set_num_threads(1)


@pytest.fixture
def jax_one_device(monkeypatch):
    import jax

    dev0 = jax.devices()[0]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev0])


def run_both(cfg, path, patterns, spy=None):
    """(JAX engine, port engine, JAX log, port log) of one config."""
    from pacbioassembly_tpu.assemble import ReadStore
    from pacbioassembly_tpu.assemble.batch import BatchAssembler as JaxAssembler
    from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler

    jax_asm = JaxAssembler(cfg, ReadStore.from_file(path, cfg), patterns)
    pcfg = port_config(cfg)
    port = BatchAssembler(pcfg, port_reads(path, pcfg), patterns, device="cpu")
    logs = []
    for asm in (jax_asm, port):
        log = io.StringIO()
        asm.run(out=io.StringIO(), log=log)
        logs.append(log.getvalue())
    assert history_dicts(port) == history_dicts(jax_asm)
    assert_same_state(port, jax_asm)
    assert (port.nround, port.retreats, port.fruitless_retreats, port.matches_since_retreat) == (
        jax_asm.nround, jax_asm.retreats, jax_asm.fruitless_retreats, jax_asm.matches_since_retreat)
    assert logs[1] == logs[0]
    return jax_asm, port, *logs


def test_fixed_bite_and_fruitless_escape_equal_jax(tmp_path, jax_one_device, monkeypatch):
    from pacbioassembly_tpu.config import AssemblyConfig
    from pacbioassembly_tpu_torch.consensus.state import ConsensusRef

    bites = []
    real = ConsensusRef.retreat_fixed

    def retreat_fixed(self, n, keep_min=64):
        bites.append(real(self, n, keep_min=keep_min))
        return bites[-1]

    monkeypatch.setattr(ConsensusRef, "retreat_fixed", retreat_fixed)
    path = write_records(tmp_path, "fruitless.bin", fruitless_records())
    cfg = AssemblyConfig(**FRUITLESS)
    _, port, _, log = run_both(cfg, path, fruitless_patterns())
    # every retreat was a fixed bite of edge_retreat_bite cells a side
    lines = retreat_lines(log)
    assert len(lines) == port.retreats == len(bites) == 3, lines
    assert bites == [2 * cfg.edge_retreat_bite] * 3
    # the escape: two fruitless retreats in a row, the budget mostly unspent
    assert port.fruitless_retreats == cfg.edge_retreat_fruitless
    assert port.retreats < cfg.edge_retreat
    assert all(s.nmatches == 0 for s in port.history[1:])


def test_retreat_min_len_blocks_the_stall_retreat(tmp_path, jax_one_device):
    from pacbioassembly_tpu.config import AssemblyConfig
    from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler

    path = write_records(tmp_path, "stall.bin", stall_records())
    ckpt = str(tmp_path / "round18.npz")
    cfg = AssemblyConfig(**STALL, max_round=STALL_RETREAT_ROUND - 1, checkpoint_path=ckpt)
    pcfg = port_config(cfg)
    BatchAssembler(pcfg, port_reads(path, pcfg), stall_patterns(), device="cpu").run(
        out=io.StringIO())

    resumed = dataclasses.replace(cfg, max_round=None, checkpoint_path=None, resume_path=ckpt)
    blocked = dataclasses.replace(resumed, edge_retreat_min_len=STALL_MIN_LEN)
    _, port, _, log = run_both(blocked, path, stall_patterns())
    assert port.nround == STALL_RETREAT_ROUND and port.retreats == 0
    assert port.ref.length() < STALL_MIN_LEN and not retreat_lines(log)
    # the same resume without the gate takes (a)'s retreat at that round
    free = dataclasses.replace(resumed, max_round=STALL_RETREAT_ROUND)
    _, port, _, log = run_both(free, path, stall_patterns())
    assert port.retreats == 1 and len(retreat_lines(log)) == 1
