"""The span readers and the idle-gap labeller (portbench/spans.py) on hand-made spans and
trace events, and a traced run of each tiny cell with the program's spans recorded.
"""

from __future__ import annotations

import io
import json
from contextlib import redirect_stdout

import pytest
from conftest import tiny
from portbench import harness, spans

MS = 1_000_000  # ns


def rec(i, name, parent, start, end, n=None, root=1):
    return {"id": i, "name": name, "parent": parent, "root": root, "start_ns": start * MS,
            "end_ns": end * MS, "n": n}


# two rounds and a save between them; two locate calls (counts as the program gives them:
# on locate.triples and locate.map_reads alone)
SPANS = [
    rec(0, "round", None, 0, 100, root=1),
    rec(1, "round.expand", 0, 0, 40),
    rec(2, "round.expand.lookup", 1, 0, 30),
    rec(3, "round.expand.seeds", 2, 0, 10),
    rec(4, "round.expand.probe", 2, 10, 25),
    rec(5, "round.commit", 0, 40, 90),
    rec(6, "round.commit.host", 5, 45, 85),
    rec(7, "round.commit.host.align", 6, 50, 60),
    rec(8, "round.commit.host.align", 6, 60, 64),
    rec(9, "checkpoint.save", None, 100, 160, root=1),
    rec(10, "checkpoint.state", 9, 100, 110, root=1),
    rec(11, "checkpoint.write", 9, 110, 158, root=1),
    rec(12, "round", None, 200, 260, root=2),
    rec(13, "round.expand", 12, 200, 220, root=2),
    rec(14, "round.expand.lookup", 13, 200, 215, root=2),
    rec(15, "round.expand.seeds", 14, 200, 204, root=2),
    rec(16, "round.expand.probe", 14, 204, 213, root=2),
    rec(17, "locate.map_reads", None, 300, 400, n=10, root=1),
    rec(18, "locate.index", 17, 300, 340, root=1),
    rec(19, "locate.triples", 17, 340, 350, n=250, root=1),
    rec(20, "locate.fill", 17, 350, 370, root=1),
    rec(21, "locate.score", 17, 370, 380, root=1),
    rec(22, "locate.fill", 17, 380, 385, root=1),
    rec(23, "locate.score", 17, 385, 390, root=1),
    rec(24, "locate.map_reads", None, 400, 500, n=30, root=2),
    rec(25, "locate.index", 24, 400, 450, root=2),
    rec(26, "locate.triples", 24, 450, 460, n=350, root=2),
]
WANT = {
    "probe_ms": (15 + 9) / 2, "expand_seeds_ms": (10 + 4) / 2, "host_align_ms": 14 / 2,
    "checkpoint_write_ms": 48.0, "locate_index_ms": 45.0, "locate_triples_ms": 10.0,
    "locate_fill_ms": 25 / 2, "locate_score_ms": 15 / 2, "locate_triples_per_read": 600 / 40,
}


@pytest.mark.parametrize("name", spans.READERS)
def test_reader_is_none_without_spans_and_reads_hand_made_spans(name):
    reader = harness.load_module("metrics", name)
    assert reader.read({}) is None
    assert reader.read({"spans": []}) is None
    assert reader.read({"phases": [{"lookup_s": 0.3}], "trace": None}) is None
    assert reader.read({"spans": SPANS}) == pytest.approx(WANT[name])


def test_split_and_counts():
    split = spans.split_ms(SPANS)
    assert split["round"] == 80.0 and split["checkpoint.save"] == 60.0
    assert split["round.expand.lookup"] == 22.5 and split["locate.index"] == 45.0
    assert spans.span_n({"spans": SPANS}, "locate.triples") == 600
    assert spans.span_n({"spans": SPANS}, "locate.fill") is None
    assert spans.span_ms({"spans": SPANS}, "round.commit.host.align") == 7.0  # per round


def ann(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "void k()", "ts": ts, "dur": dur}


# a window of 100 µs: kernels at 10-20 and 60-70; a round 5-75 whose expansion
# (25-55, its probe 30-50) holds most of the gap 20-60; no program span over 75-100
EVENTS = [ann(harness.WINDOW, 0, 100), ann(harness.STEP, 0, 100), ann("round", 5, 70),
          ann("round.expand", 25, 30), ann("round.expand.probe", 30, 20),
          kernel(10, 10), kernel(60, 10)]


def test_innermost_segments():
    segs = spans.innermost(spans.program_spans(EVENTS))
    assert segs == [(5, 25, "round"), (25, 30, "round.expand"), (30, 50, "round.expand.probe"),
                    (50, 55, "round.expand"), (55, 75, "round")]


def test_labeller_names_a_gap_by_its_span_and_falls_back_outside():
    label = spans.span_labeller(EVENTS, lambda host, t: "fallback")
    gaps = spans.device_gaps(EVENTS)
    assert gaps == [(0, 10), (20, 60), (70, 100)]
    assert label([], 40) == "round.expand.probe"  # 20 of the gap's 40 µs
    assert label([], 5) == "round"  # 0-10: the round covers 5 of it, nothing else does
    assert label([], 85) == "round"  # 70-100: the round covers 70-75
    only = [ann(harness.WINDOW, 0, 100), kernel(10, 10)]
    assert spans.span_labeller(only, lambda host, t: "fallback")([], 60) == "fallback"
    # read_trace takes it as its label and keeps its own gaps
    tr = harness.read_trace(EVENTS, label)
    assert [g[0] for g in tr["idle_gaps"]] == ["round.expand.probe", "round", "round"]


def test_idle_by_span():
    idle = spans.idle_by_span(EVENTS)
    assert idle["idle_s"] == pytest.approx(80e-6)
    assert idle["by_span_s"] == pytest.approx({"round.expand.probe": 20e-6, "round": 20e-6,
                                               "round.expand": 10e-6})
    assert idle["uncovered_s"] == pytest.approx(30e-6)
    assert idle["below_root_pct"] == pytest.approx(100 * 30 / 80)
    assert idle["idle_gaps"][0] == ["round.expand.probe", pytest.approx(40e-6)]


@pytest.mark.parametrize("cell", ["ecoli_3pct.grow", "ecoli_3pct.locate"])
def test_traced_run_with_the_spans_recorded(cell):
    conf, mix = tiny(cell)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = spans.traced(["--workload", cell, "--seed", "7", "--seconds", "0.5"], device="cpu",
                          config=conf, mix=mix)
    assert rc == 0
    result, got = (json.loads(x) for x in out.getvalue().strip().splitlines()[-2:])
    assert result["correct"]
    vals = got["span_metrics"]
    if cell.endswith("grow"):
        assert set(vals) >= {"probe_ms", "expand_seeds_ms", "host_align_ms"}
        # the phase readers read phase_s, rounded to 0.1 ms a round
        phase = {k: v["value"] for k, v in result["metrics"].items()}
        assert vals["probe_ms"] + vals["expand_seeds_ms"] <= phase["lookup_ms"] + 0.05
        assert vals["host_align_ms"] <= phase["host_commit_ms"] + 0.05
        assert "round" in got["split_ms"]
    else:
        assert set(vals) == {k for k in spans.READERS if k.startswith("locate_")}
        assert 0.5 < got["sums"]["locate_parts_over_call"] <= 1.0
        assert vals["locate_triples_per_read"] > 0
    assert got["idle"]["idle_s"] > 0
