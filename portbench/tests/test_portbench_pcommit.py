"""A mix may set the engine; the two-thread host commit and the reference that follows it.

A mix's `engine` keys and `screen_kernel` go over its configuration's
(run.py::settings), and a key the configuration does not state is refused.
`ecoli_3pct.grow_pcommit` turns on the engine's two-thread host commit
(`parallel_commit`): once the contig is twice the reach of one end's
alignments, the left reads and the right reads commit in two threads and
the reads with candidates on both sides after them. The reference commits
in that order (reference/engine.py::host_order). The tiny cell here keeps
the published 20,000-base seed window, so its genome is long enough for
the contig to pass 2 * reach = 2 * (20,000 + longest read * 1.3 + 64).
"""

from __future__ import annotations

import numpy as np
import pytest

from conftest import harness, run, run_cell, tiny
from portbench.entries import rounds
from portbench.reference import engine as ref_engine
from portbench.reference.consensus import Consensus

CELL = "ecoli_3pct.grow_pcommit"
EXISTING = ("ecoli_clr15.grow", "ecoli_3pct.grow", "ecoli_3pct.locate")


def tiny_pcommit():
    conf, mix = tiny(CELL)
    conf["store"].update(genome_len=56_000)
    conf["engine"].update(max_read_len=20_000)  # the seed window the program uses
    mix.update(warm_contig_len=46_000, fixed_span=56_000)
    return conf, mix


@pytest.mark.parametrize("cell", EXISTING)
def test_existing_cells_run_their_configuration(cell):
    w = next(w for w in harness.manifest()["workloads"] if w["name"] == cell)
    conf = harness.load_json("configs", w["config"])
    got, over = run.settings(conf, harness.load_json("mixes", w["traffic"]))
    assert got == conf and over == {}


def test_pcommit_mix_is_grow_with_the_split():
    grow, pc = harness.load_json("mixes", "grow"), harness.load_json("mixes", "grow_pcommit")
    strip = lambda m: {k: v for k, v in m.items() if k not in ("engine", "what")}  # noqa: E731
    assert strip(pc) == strip(grow) and pc["what"] != grow["what"]
    assert pc["engine"] == {"parallel_commit": True} and "engine" not in grow
    conf = harness.load_json("configs", "ecoli_3pct")
    got, over = run.settings(conf, pc)
    assert over == {"engine.parallel_commit": True}
    assert got == dict(conf, engine=dict(conf["engine"], parallel_commit=True))


def test_a_mix_key_the_configuration_lacks_is_refused(capsys):
    conf, mix = tiny("ecoli_3pct.grow")
    mix["engine"] = {"paralel_commit": True}
    with pytest.raises(ValueError):
        run.settings(conf, mix)
    rc, res = run_cell("ecoli_3pct.grow", 1, 0.5, config=conf, mix=mix)
    assert rc == 2 and res is None
    assert "paralel_commit" in capsys.readouterr().err


def test_tiny_pcommit_run_is_correct_and_splits(capsys):
    conf, mix = tiny_pcommit()
    rc, res = run_cell(CELL, 2**31 + 11, 2.0, config=conf, mix=mix)
    assert rc == 0 and res["correct"], res["checks"]
    assert res["checks"]["split_rounds_missing"]["value"] == 0
    assert res["checks"]["split_diff"]["value"] == 0
    err = capsys.readouterr().err
    assert "overrides {'engine.parallel_commit': True}" in err
    assert "host commit split; the program's split" in err


def test_control_fails_the_tiny_pcommit_run():
    conf, mix = tiny_pcommit()
    rc, res = run_cell(CELL, 2**31 + 11, 2.0, config=conf, mix=mix, control=True)
    assert rc == 0 and not res["correct"]


def test_window_opens_on_window_contig(capsys):
    conf, mix = tiny("ecoli_clr15.grow")
    mix.update(window_contig=1, warm_contig_len=0)
    rc, res = run_cell("ecoli_clr15.grow", 2**32 + 5, 1.0, config=conf, mix=mix)
    assert rc == 0 and res["correct"], res["checks"]
    assert "warm-up: contig 1 at round 0," in capsys.readouterr().err


def pack(seqs) -> np.ndarray:
    """The store's binary records: [u32 length][4 codes a byte, first in bits 7-6]."""
    out = bytearray()
    for s in seqs:
        q = np.zeros(-(-len(s) // 4) * 4, np.uint8)
        q[: len(s)] = s
        q = q.reshape(-1, 4)
        out += np.uint32(len(s)).tobytes()
        out += ((q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3]).tobytes()
    return np.frombuffer(bytes(out), np.uint8)


def test_reference_follows_the_split_where_order_matters():
    """Read 0 is mixed (a left candidate that fails, then the right end with
    extension X); read 1 is right (the same end with extension Y); reads 2
    and 3 are left. Whichever of 0 and 1 commits first grows the end, and
    the other no longer aligns: the split commits 1 before 0."""
    from pacbioassembly_tpu_torch.assemble import batch
    from pacbioassembly_tpu_torch.assemble.reads import ReadStore
    from pacbioassembly_tpu_torch.config import AssemblyConfig
    from pacbioassembly_tpu_torch.consensus import ConsensusRef

    rng = np.random.default_rng(5)
    L = 2 * (20_000 + int(500 * 1.3) + 64) + 100  # 2 * reach of 500-base reads, and some
    genome = rng.integers(0, 4, L).astype(np.uint8)
    x, y = (rng.integers(0, 4, 400).astype(np.uint8) for _ in range(2))
    seqs = [np.concatenate([genome[L - 100:], x]), np.concatenate([genome[L - 100:], y]),
            genome[1000:1500], genome[2000:2500]]
    eng = dict(harness.load_json("configs", "ecoli_3pct")["engine"], min_read_len=100,
               device_traceback=False)
    # (read, r_offset) of each accepted candidate, all forward from the read's start
    rows = [(0, 5000), (0, L - 100), (1, L - 100), (2, 1000), (3, 2000)]
    cands = {"read": np.array([r for r, _ in rows]), "j": np.zeros(len(rows), np.int64),
             "forward": np.ones(len(rows), bool), "r_offset": np.array([p for _, p in rows]),
             "rank": np.zeros(len(rows), np.int64)}

    # the program, its split counted
    cfg = AssemblyConfig(**dict(eng, parallel_commit=True))
    store = ReadStore(pack(seqs), min_read_len=cfg.min_read_len, max_read_len=cfg.max_read_len)
    asm = batch.BatchAssembler(cfg, store, [0xFFFFFFFF], device="cpu",
                               ref=ConsensusRef(genome, capacity=6 * L))
    splits = rounds.Splits(batch)
    splits.install()
    try:
        _, consumed = asm._commit_host(batch.CandidateBatch(**cands),
                                       [(0, [0, 1]), (1, [2]), (2, [3]), (3, [4])])
    finally:
        splits.remove()
    assert splits.n == 1
    st = asm.ref.state_dict()
    program = {k: st[k] for k in ("codes", "sel", "sup", "total", "beg", "end")}

    codes = np.concatenate(seqs)
    lengths = np.array([len(s) for s in seqs])
    reads = ref_engine.Reads(codes, np.cumsum(lengths) - lengths, lengths, 100, 20_000)
    zeros = np.zeros(len(rows), np.int64)
    got = {}
    for pc in (True, False):
        ref = Consensus.from_read(genome)
        done, split = ref_engine.commit(ref, reads, np.arange(4), cands, np.ones(len(rows), bool),
                                        zeros, zeros, zeros, zeros, dict(eng, parallel_commit=pc),
                                        "cpu")
        assert split == pc
        got[pc] = (done, ref.state())
    assert got[True][0] == sorted(consumed) == [1, 2, 3]
    assert rounds.state_diff(program, got[True][1]) == 0
    assert got[False][0] == [0, 2, 3]
    assert rounds.state_diff(program, got[False][1]) > 0
    # a round that accepts nothing (a stall) commits nothing and takes no split
    none = np.zeros(len(rows), bool)
    assert ref_engine.commit(Consensus.from_read(genome), reads, np.arange(4), cands, none, zeros,
                             zeros, zeros, zeros, dict(eng, parallel_commit=True), "cpu") == ([], False)
