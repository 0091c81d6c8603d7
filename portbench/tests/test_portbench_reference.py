"""The plain reference against the port's CPU path, on tiny stores.

A `grow` run on the CPU drives the engine's rounds with the kernels' plain
versions; its check replays sampled rounds with the reference and compares
every stage exactly. A `locate` run compares the rows of sampled reads.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import run_cell, tiny
from portbench.reference import engine, store


def reads_of(d):
    return [d["codes"][o: o + n].tobytes() for o, n in zip(d["offsets"], d["lengths"])]


# engine settings that keep every read, and the engine's first draw among them
KEEP_ALL = {"rng_seed": 7, "min_read_len": 0, "max_read_len": 10**9}


def test_store_is_made_from_the_seed():
    conf, _ = tiny("ecoli_clr15.grow")
    a = store.generate(conf["store"], 2**40 + 3, "cpu", engine=KEEP_ALL)
    b = store.generate(conf["store"], 2**40 + 3, "cpu", engine=KEEP_ALL)
    c = store.generate(conf["store"], 2**40 + 4, "cpu", engine=KEEP_ALL)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    first = int(np.random.default_rng(7).integers(0, len(a["lengths"])))
    # another run seed: the same genome and reads in another order, the first read in place
    assert np.array_equal(a["genome"], c["genome"])
    ra, rc = reads_of(a), reads_of(c)
    assert sorted(ra) == sorted(rc) and ra != rc and ra[first] == rc[first]
    # with a fixed span: the reads near the first read keep their positions, the others move
    d = store.generate(conf["store"], 2**40 + 3, "cpu", engine=KEEP_ALL, fixed_span=3000)
    e = store.generate(conf["store"], 2**40 + 4, "cpu", engine=KEEP_ALL, fixed_span=3000)
    rd, re_ = reads_of(d), reads_of(e)
    same = [i for i in range(len(rd)) if rd[i] == re_[i]]
    assert sorted(rd) == sorted(re_) and first in same and 1 < len(same) < len(rd) // 2
    other = store.generate(dict(conf["store"], seed=12), 2**40 + 3, "cpu")
    assert not np.array_equal(a["genome"], other["genome"])
    lens = a["lengths"]
    n = int(conf["store"]["coverage"] * conf["store"]["genome_len"] / conf["store"]["mean_read_len"])
    assert len(lens) == n and lens.sum() == len(a["codes"])
    # the records hold the same codes: [u32 length][4 codes a byte, first in bits 7-6]
    buf, off = a["records"], 0
    for i in range(n):
        ln = int(buf[off: off + 4].view(np.uint32)[0])
        assert ln == lens[i]
        packed = buf[off + 4: off + 4 + (ln + 3) // 4]
        codes = np.stack([(packed >> s) & 3 for s in (6, 4, 2, 0)], 1).reshape(-1)[:ln]
        o = int(a["offsets"][i])
        assert np.array_equal(codes, a["codes"][o: o + ln])
        off += 4 + (ln + 3) // 4
    assert off == len(buf)


def test_reads_the_engine_drops_keep_their_place():
    """The engine numbers only the reads its length filter keeps; those it
    drops stay in place, so under two seeds its first read, and the reads
    whose middles lie within the fixed span of it, are the same reads."""
    conf, _ = tiny("ecoli_clr15.grow")
    eng = dict(conf["engine"], max_read_len=1200)  # drops about a fifth of the tiny store
    d, e = (store.generate(conf["store"], s, "cpu", engine=eng, fixed_span=3000)
            for s in (2**40 + 3, 2**40 + 4))
    dropped = d["lengths"] >= eng["max_read_len"]
    assert dropped.any() and np.array_equal(dropped, e["lengths"] >= eng["max_read_len"])
    kd, ke = (engine.Reads(x["codes"], x["offsets"], x["lengths"], eng["min_read_len"],
                           eng["max_read_len"]) for x in (d, e))
    first = int(np.random.default_rng(eng["rng_seed"]).integers(0, len(kd)))
    assert np.array_equal(kd.codes(first), ke.codes(first))
    same = sum(np.array_equal(kd.codes(i), ke.codes(i)) for i in range(len(kd)))
    assert 1 < same < len(kd)


def test_error_profile_rates():
    """The CLR profile's insertions outnumber its deletions and substitutions."""
    conf, _ = tiny("ecoli_clr15.grow")
    s = dict(conf["store"], genome_len=50_000)
    d = store.generate(s, 5, "cpu")
    n = int(s["coverage"] * s["genome_len"] / s["mean_read_len"])
    drawn = np.clip(d["lengths"], 1, None)
    sub, ins, dele = store.error_rates(s["error_rate"], s["error_profile"])
    # expected growth of a read: 1 - del + ins
    assert abs(drawn.sum() / (s["mean_read_len"] * n) - (1 - dele + ins)) < 0.03
    assert ins > dele > sub


# the end-to-end metrics of each grow cell: the CLR cell's round tail is read per layer
GROW_E2E = {"ecoli_clr15.grow": {"assembled_reads_per_s", "setup_s"},
            "ecoli_3pct.grow": {"assembled_reads_per_s", "round_s_p90", "setup_s"}}


@pytest.mark.parametrize("cell", ["ecoli_clr15.grow", "ecoli_3pct.grow"])
def test_grow_rounds_equal_the_reference(cell):
    conf, mix = tiny(cell)
    rc, res = run_cell(cell, 2**31 + 11, 2.0, config=conf, mix=mix)
    assert rc == 0 and res is not None
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == GROW_E2E[cell]


def test_traced_clr_run_reads_the_round_tail_and_the_saves_per_layer():
    conf, mix = tiny("ecoli_clr15.grow")
    rc, res = run_cell("ecoli_clr15.grow", 2**31 + 13, 2.0, trace=1, config=conf, mix=mix)
    assert rc == 0 and res["correct"], res["checks"]
    got = res["metrics"]
    assert "round_s_p90" not in got and "checkpoint_ms" not in got
    assert got["round_s_p90.rate"]["value"] > 0 and got["round_s_p90.rate"]["unit"] == "s"
    assert got["checkpoint_ms.rate"]["value"] > 0


def test_round_tail_and_save_readers():
    from portbench import harness

    tail = harness.load_module("metrics", "round_s_p90.rate")
    saves = harness.load_module("metrics", "checkpoint_ms.rate")
    assert tail.read({}) is None and saves.read({"checkpoint_s": []}) is None
    times = [0.1 * (i + 1) for i in range(10)]
    assert tail.read({"round_s": times}) == pytest.approx(float(np.percentile(times, 90)))
    assert saves.read({"checkpoint_s": [0.5, 0.7]}) == pytest.approx(600.0)


def test_locate_rows_equal_the_reference():
    conf, mix = tiny("ecoli_3pct.locate")
    rc, res = run_cell("ecoli_3pct.locate", 2**33 + 1, 1.0, config=conf, mix=mix)
    assert rc == 0 and res["correct"], res["checks"]
    assert set(res["metrics"]) == {"mapped_reads_per_s", "setup_s"}


def test_reference_round_from_a_fresh_start():
    """The reference's start equals a consensus of one read with one vote a base."""
    conf, _ = tiny("ecoli_3pct.grow")
    d = store.generate(conf["store"], 9, "cpu")
    reads = engine.Reads(d["codes"], d["offsets"], d["lengths"], 500, 20_000)
    st, _ = engine.initial_state(reads, 7)
    assert st["beg"] == 0 and st["end"] == len(st["codes"])
    assert (st["total"] == 1).all() and (st["sel"].sum(1) == 1).all()
    assert (st["sel"].argmax(1) == st["codes"]).all()


def test_plain_dp_equals_the_aligner():
    """The frozen row DP and the frozen host aligner agree on accept, matlens and cost."""
    from portbench.reference import aligner, rowdp

    rng = np.random.default_rng(1)
    base = rng.integers(0, 4, 400).astype(np.uint8)
    pairs = []
    for k in range(24):
        b = base[: 200 + 7 * k].copy()
        flip = rng.random(len(b)) < 0.05 * (k % 4)
        b[flip] = (b[flip] + 1) % 4
        pairs.append((base[: 260 + 5 * k], b))
    LA = max(len(a) for a, _ in pairs)
    LB = max(len(b) for _, b in pairs)
    A = np.zeros((len(pairs), LA), np.uint8)
    Bm = np.zeros((len(pairs), LB), np.uint8)
    for q, (a, b) in enumerate(pairs):
        A[q, : len(a)], Bm[q, : len(b)] = a, b
    la = torch.tensor([len(a) for a, _ in pairs], dtype=torch.int32)
    lb = torch.tensor([len(b) for _, b in pairs], dtype=torch.int32)
    s = rowdp.score(torch.from_numpy(A), la, torch.from_numpy(Bm), lb, la_max=LA,
                    w_max=1 + int(LA * 0.3), ratio=0.3)
    for q, (a, b) in enumerate(pairs):
        res = aligner.align(a, b, 0.3)
        assert bool(s.accept[q]) == (res is not None), q
        if res is not None:
            assert (int(s.matlen_a[q]), int(s.matlen_b[q]), int(s.cost[q])) == res[:3]
