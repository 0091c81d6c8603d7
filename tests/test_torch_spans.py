"""Port: the span recorder (utils/metrics.py::span, recording) in the round
loop, the checkpoint and the locator, on the CPU.

Three rounds of the batch engine on a small simulated store (a checkpoint
every second round, the prefilter forced on) run once under `recording()`;
the locator maps the first reads of tests/data/synth_reads.txt onto
tests/data/synth_genome.txt, once under the operator's profiler
(`profiled`).
The span tree has the parents and root ids the code gives it, each child
lies inside its parent, each phase_s value is its span's duration, the
profiler's trace carries every span as a user_annotation, and outside
`recording()` and `profiled()` a span appends nothing and never enters
record_function.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from pacbioassembly_tpu_torch.assemble import ReadStore
from pacbioassembly_tpu_torch.assemble.batch import PREFILTER_CHUNK, SCREEN_CHUNK, BatchAssembler
from pacbioassembly_tpu_torch.assemble.checkpoint import save_checkpoint
from pacbioassembly_tpu_torch.codec import binary_io, dna
from pacbioassembly_tpu_torch.config import AssemblyConfig
from pacbioassembly_tpu_torch.tools import locate
from pacbioassembly_tpu_torch.tools.simulate import SimConfig, simulate
from pacbioassembly_tpu_torch.utils import metrics
from pacbioassembly_tpu_torch.utils.metrics import profiled, recording, span

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
ROUNDS = 3
PATTERN = dna.parse_pattern("1111111111111111")

# each span's parent, as the code opens them
PARENT = {
    "round.seedmap": "round", "round.expand": "round", "round.screen": "round",
    "round.commit": "round", "round.evolve": "round",
    "round.expand.lookup": "round.expand", "round.expand.hits": "round.expand",
    "round.expand.seeds": "round.expand.lookup", "round.expand.probe": "round.expand.lookup",
    "round.screen.prefilter": "round.screen", "round.screen.full": "round.screen",
    "round.commit.traceback": "round.commit", "round.commit.host": "round.commit",
    "round.commit.elect": "round.commit", "round.commit.host.align": "round.commit.host",
    "launch.pf": "round.screen.prefilter", "launch.fs": "round.screen.full",
    "launch.tbp": "round.commit.traceback", "launch.elect": "round.commit.elect",
    "checkpoint.save": "round", "checkpoint.state": "checkpoint.save",
    "checkpoint.write": "checkpoint.save",
    "locate.index": "locate.map_reads", "locate.triples": "locate.map_reads",
    "locate.fill": "locate.map_reads", "locate.score": "locate.map_reads",
    "locate.select": "locate.map_reads",
}
# phase_s keys and the spans they time
PHASE_SPANS = {
    "seedmap_s": "round.seedmap", "expand_s": "round.expand", "screen_s": "round.screen",
    "commit_s": "round.commit", "evolve_s": "round.evolve", "lookup_s": "round.expand.lookup",
    "expand_rest_s": "round.expand.hits", "prefilter_s": "round.screen.prefilter",
    "fullscreen_s": "round.screen.full", "tb_s": "round.commit.traceback",
    "host_commit_s": "round.commit.host", "elect_s": "round.commit.elect",
}
# the keys phase_s had before the spans, less slow_launch_kind, _s and _shape, plus
# expand_device (0 here: the expansion runs on the host for a CPU engine)
PHASE_KEYS = set(PHASE_SPANS) | {"retreats", "prefilter_kept", "launches", "fullscreen_n",
                                 "host_aligns", "device_commits", "expand_device"}


def store(tmp) -> ReadStore:
    sim = SimConfig(genome_len=12_000, coverage=10.0, mean_read_len=800, min_read_len=600,
                    max_read_len=1000, sub_rate=0.02, ins_rate=0.02, del_rate=0.02, seed=8)
    _, reads, _ = simulate(sim)
    path = os.path.join(tmp, "reads.bin")
    with open(path, "wb") as fh:
        binary_io.write_records(fh, reads)
    return ReadStore.from_file(path, AssemblyConfig())


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    """Three recorded rounds: (records, each round's phase_s, the
    checkpoint's path, each round's launch log, each round's candidates)."""
    tmp = str(tmp_path_factory.mktemp("spans"))
    cfg = AssemblyConfig(engine="batch", rng_seed=3, pattern_schedule="roundrobin",
                         max_round=ROUNDS, prefilter_min_batch=1, checkpoint_every=2,
                         checkpoint_path=os.path.join(tmp, "ck.npz"))
    asm = BatchAssembler(cfg, store(tmp), [PATTERN], device="cpu")
    phases, logs, cands = [], [], []
    real = asm.run_round

    def run_round(log=None):
        stats = real(log=log)
        phases.append(dict(asm.phase_s))
        logs.append(list(asm.launch_log))
        cands.append(stats.ntrials)
        return stats

    asm.run_round = run_round
    with recording() as recs:
        asm.run()
    return recs, phases, cfg.checkpoint_path, logs, cands


def by_name(recs, name):
    return [r for r in recs if r["name"] == name]


def test_round_spans_have_their_parents_and_root_ids(rounds):
    recs = rounds[0]
    roots = [r for r in recs if r["parent"] is None]
    # the three rounds, then the run's closing save at round 3
    assert [(r["name"], r["root"]) for r in roots] == (
        [("round", k) for k in range(1, ROUNDS + 1)] + [("checkpoint.save", ROUNDS)])
    for r in recs:
        if r["parent"] is None:
            continue
        parent = recs[r["parent"]]
        assert parent["name"] == PARENT[r["name"]], r
        assert r["root"] == parent["root"], r
    for name in ("round.seedmap", "round.expand", "round.screen", "round.commit", "round.evolve"):
        assert [r["root"] for r in by_name(recs, name)] == list(range(1, ROUNDS + 1)), name
    # launch.fs_host needs the host-packed path: not on this store
    for name in set(PARENT) - {"checkpoint.save"}:
        if not name.startswith("locate."):
            assert by_name(recs, name), name
    # the cadence save of round 2 runs inside its round
    inner = [r for r in by_name(recs, "checkpoint.save") if r["parent"] is not None]
    assert [r["root"] for r in inner] == [2]


def test_children_lie_inside_their_parent(rounds):
    recs = rounds[0]
    for r in recs:
        assert r["start_ns"] <= r["end_ns"], r
        if r["parent"] is not None:
            p = recs[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] and r["end_ns"] <= p["end_ns"], r
    # the commit's three intervals follow each other inside round.commit
    for commit in by_name(recs, "round.commit"):
        kids = [r for r in recs if r["parent"] == commit["id"]]
        assert [k["name"] for k in kids] == ["round.commit.traceback", "round.commit.host",
                                            "round.commit.elect"]
        assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(kids, kids[1:]))


def test_phase_s_values_are_their_spans_durations(rounds):
    recs, phases, _, logs, cands = rounds
    assert len(phases) == ROUNDS
    for k, ph in enumerate(phases, start=1):
        assert set(ph) == PHASE_KEYS, k
        assert ph["expand_device"] == 0, k
        for key, name in PHASE_SPANS.items():
            got = [r for r in by_name(recs, name) if r["root"] == k]
            assert len(got) == 1, (k, name)
            want = round((got[0]["end_ns"] - got[0]["start_ns"]) / 1e9, 4)
            if name == "round.expand.hits" and cands[k - 1] == 0:
                want = 0.0  # no candidate: the phase stays at 0
            assert ph[key] == want, (k, key)
        launches = [r["name"] for r in recs if r["name"].startswith("launch.") and r["root"] == k]
        assert ph["launches"] == len(launches) == len(logs[k - 1]), k
        # the launch log keeps each launch's kind and shape, no seconds
        assert [f"launch.{e['kind']}" for e in logs[k - 1]] == launches, k
        assert all(set(e) == {"kind", "shape"} for e in logs[k - 1]), k
        align = [r for r in by_name(recs, "round.commit.host.align") if r["root"] == k]
        assert ph["host_aligns"] == len(align), k


def test_counts_of_the_expansion_and_the_screen(rounds):
    """One launch a chunk in each screening pass; the round's spans carry
    no count (only the locator's triples and calls do)."""
    recs, phases, cands = rounds[0], rounds[1], rounds[4]
    for k, ph in enumerate(phases, start=1):
        assert cands[k - 1] > 0
        pf = [r for r in by_name(recs, "launch.pf") if r["root"] == k]
        assert len(pf) == -(-cands[k - 1] // PREFILTER_CHUNK)
        fs = [r for r in by_name(recs, "launch.fs") if r["root"] == k]
        assert len(fs) == -(-ph["fullscreen_n"] // SCREEN_CHUNK)
    assert all(r["n"] is None for r in recs)


def test_checkpoint_save_has_its_two_children(rounds, tmp_path):
    recs, path = rounds[0], rounds[2]
    for save in by_name(recs, "checkpoint.save"):
        kids = [r for r in recs if r["parent"] == save["id"]]
        assert [k["name"] for k in kids] == ["checkpoint.state", "checkpoint.write"]
    # the closing save's write is the run's last span, after the file exists
    assert recs[-1]["name"] == "checkpoint.write" and os.path.getsize(path) > 0
    # a save outside any span is a root, at the engine's round
    from types import SimpleNamespace

    from pacbioassembly_tpu_torch.consensus import ConsensusRef

    eng = SimpleNamespace(ref=ConsensusRef(np.zeros(8, np.uint8), capacity=600),
                          rng=np.random.default_rng(0), surviving=[1, 2], nround=7, nfailure=0)
    with recording() as alone:
        save_checkpoint(str(tmp_path / "alone"), eng)
    assert [(r["name"], r["parent"], r["root"]) for r in alone] == [
        ("checkpoint.save", None, 7), ("checkpoint.state", 0, 7), ("checkpoint.write", 0, 7)]
    assert os.path.exists(tmp_path / "alone.npz")


def reads_and_contig(n):
    genome = dna.text_to_codes(open(os.path.join(DATA, "synth_genome.txt")).read().strip())
    words = open(os.path.join(DATA, "synth_reads.txt")).read().split()
    return genome, [dna.text_to_codes(w) for w in words[:n]]


def test_locate_spans_and_counts(monkeypatch):
    genome, seqs = reads_and_contig(6)
    scored = []
    real = locate.score_batch

    def score_spy(a, la, b, lb, **kw):
        scored.append(len(la))
        return real(a, la, b, lb, **kw)

    monkeypatch.setattr(locate, "score_batch", score_spy)
    with recording() as recs:
        rows1, n1 = locate.map_reads(genome, PATTERN, seqs[:3], 0.15, device="cpu")
        rows2, n2 = locate.map_reads(genome, PATTERN, seqs[3:], 0.15, device="cpu")
    calls = by_name(recs, "locate.map_reads")
    assert [c["parent"] for c in calls] == [None, None]
    assert calls[1]["root"] == calls[0]["root"] + 1
    assert [c["n"] for c in calls] == [n1, n2]
    for c in calls:
        kids = [r for r in recs if r["parent"] == c["id"]]
        names = [k["name"] for k in kids]
        assert names[:2] == ["locate.index", "locate.triples"] and names[-1] == "locate.select"
        assert set(names[2:-1]) == {"locate.fill", "locate.score"}
        for k in kids:
            assert k["root"] == c["root"]
            assert c["start_ns"] <= k["start_ns"] <= k["end_ns"] <= c["end_ns"]
    # the triples counted are the triples scored; one fill and one score a chunk
    assert sum(r["n"] for r in by_name(recs, "locate.triples")) == sum(scored) > 0
    assert len(by_name(recs, "locate.fill")) == len(by_name(recs, "locate.score")) == len(scored)
    assert [r["n"] for r in recs if r["n"] is not None and r["name"] != "locate.triples"] == [
        n1, n2]
    assert rows1 and rows2


def test_profiled_trace_carries_every_span(tmp_path):
    genome, seqs = reads_and_contig(1)
    with profiled(str(tmp_path)):
        # the operator's trace names the spans and keeps no records
        assert metrics._ON and metrics._REC is None
        with span("alone") as alone:
            pass
        assert alone._rec is None and metrics._REC is None
        with recording() as recs:  # nested: these are kept as well
            locate.map_reads(genome, PATTERN, seqs, 0.15, device="cpu")
        assert metrics._ON and metrics._REC is None
    assert not metrics._ON
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    names = sorted(e["name"] for e in events if e.get("cat") == "user_annotation")
    assert names == sorted(["alone"] + [r["name"] for r in recs]) and "locate.score" in names


def test_off_appends_nothing_and_enters_no_record_function(monkeypatch, tmp_path):
    def refuse(*a, **k):
        raise AssertionError("record_function entered outside recording()")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    genome, seqs = reads_and_contig(2)
    rows, n = locate.map_reads(genome, PATTERN, seqs, 0.15, device="cpu")
    assert n == 2
    cfg = AssemblyConfig(engine="batch", rng_seed=3, pattern_schedule="roundrobin", max_round=1,
                         prefilter_min_batch=1, checkpoint_path=str(tmp_path / "ck.npz"))
    asm = BatchAssembler(cfg, store(str(tmp_path)), [PATTERN], device="cpu")
    asm.run()
    assert asm.nround == 1 and asm.phase_s["screen_s"] > 0
    assert os.path.exists(tmp_path / "ck.npz")
    assert metrics._REC is None and not metrics._ON
    with span("x") as sp:
        pass
    assert sp.s >= 0 and sp._rec is None
    # the patch holds: inside recording() the same span would enter it
    with pytest.raises(AssertionError, match="record_function"):
        with recording():
            with span("x"):
                pass
    assert metrics._REC is None and not metrics._ON


def test_spans_of_the_two_thread_commit_are_roots():
    """A span opened on a thread with no open span of its own is a root;
    on its own thread it is the parent of what it opens."""
    from concurrent.futures import ThreadPoolExecutor

    def work():
        with span("round.commit.host.align"), span("inner"):
            pass

    with recording() as recs:
        with span("round", root=5), span("round.commit"), span("round.commit.host"):
            with ThreadPoolExecutor(max_workers=2) as ex:
                for f in [ex.submit(work) for _ in range(4)]:
                    f.result()
    aligns = by_name(recs, "round.commit.host.align")
    assert len(aligns) == 4
    assert all(a["parent"] is None and a["root"] is None for a in aligns)
    assert sorted(recs[r["parent"]]["id"] for r in by_name(recs, "inner")) == sorted(
        a["id"] for a in aligns)
    assert sorted(r["id"] for r in recs) == list(range(len(recs)))

