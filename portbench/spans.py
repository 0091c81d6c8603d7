"""The program's spans (pacbioassembly_tpu_torch/utils/metrics.py::span) in the benchmark.

What the span readers (portbench/metrics/<name>.py) share, a labeller of
the device's idle gaps by the program's own spans, and a traced run with
the spans recorded:

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs the cell as `run.py --trace 1` does, with the program's
`recording()` open inside the window's trace. It prints the run's result
line, then one JSON line: the span readers' values, each span's ms per
root (per round, per save, per call), the window's device-idle seconds
named by the innermost program span, the share of them that no program
span covers, the ten longest idle gaps by that name, and the sums that
tie the span readers to the phase readers. `--cost` times a span instead:
off, recording, and recording under torch.profiler.

The records a reader gets are `readings["spans"]`: dicts with name, id,
parent (the id of the innermost open span, or None for a root), root (the
root's id: the round number, the locator's call number), start_ns, end_ns
and n (the span's count, or None). A reader returns None where it finds
no span to read.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

# the span readers and the spans they read
READERS = ("probe_ms", "expand_seeds_ms", "host_align_ms", "checkpoint_write_ms",
           "locate_index_ms", "locate_triples_ms", "locate_fill_ms", "locate_score_ms",
           "locate_triples_per_read")
# root spans: time attributed to them alone is not below the root
ROOTS = ("round", "locate.map_reads")


def _root_name(spans: list[dict], rec: dict) -> str:
    while rec["parent"] is not None:
        rec = spans[rec["parent"]]
    return rec["name"]


def span_ms(readings: dict, name: str, per: str | None = None):
    """The total of the spans `name`, in ms per span `per` (by default the
    root of the first of them: ms a round, ms a call)."""
    spans = readings.get("spans") or []
    got = [s for s in spans if s["name"] == name]
    if not got:
        return None
    per = per or _root_name(spans, got[0])
    count = sum(1 for s in spans if s["name"] == per)
    if not count:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in got) / 1e6 / count


def span_n(readings: dict, name: str):
    """The sum of the counts `n` of the spans `name`."""
    got = [s["n"] for s in readings.get("spans") or []
           if s["name"] == name and s["n"] is not None]
    return sum(got) if got else None


def split_ms(spans: list[dict]) -> dict:
    """Every span name's ms per root of its tree's root name."""
    roots: dict[str, int] = {}
    total: dict[str, float] = {}
    for s in spans:
        if s["parent"] is None:
            roots[s["name"]] = roots.get(s["name"], 0) + 1
        total[s["name"]] = total.get(s["name"], 0.0) + (s["end_ns"] - s["start_ns"]) / 1e6
    out = {}
    for name, ms in total.items():
        rec = next(s for s in spans if s["name"] == name)
        out[name] = ms / max(roots.get(_root_name(spans, rec), 1), 1)
    return dict(sorted(out.items()))


# ---------------------------------------------------------------- idle gaps

def program_spans(events: list[dict]) -> list[tuple[float, float, str]]:
    """The trace's program spans: user annotations not named portbench.*."""
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
            for e in events if e.get("cat") == "user_annotation"
            and not e.get("name", "").startswith("portbench.")]


def innermost(spans: list[tuple[float, float, str]]) -> list[tuple[float, float, str]]:
    """The time the spans cover, cut into segments each named by the
    innermost span open there (a span clipped to its parent's end)."""
    out, stack, t = [], [], None

    def advance(upto):
        nonlocal t
        while stack and stack[-1][0] <= upto:
            end, name = stack.pop()
            if end > t:
                out.append((t, end, name))
                t = end
        if stack and upto > t:
            out.append((t, upto, stack[-1][1]))
        t = max(t, upto)

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        if t is None:
            t = a
        advance(a)
        stack.append((min(b, stack[-1][0]) if stack else b, name))
    if stack:
        advance(stack[0][0])
    return out


def device_gaps(events: list[dict]) -> list[tuple[float, float]]:
    """The window's idle gaps (µs on the trace's clock): harness.read_trace's,
    every one of them, in time order (read_trace labels its ten longest
    only)."""
    win = [e for e in events
           if e.get("cat") == "user_annotation" and e.get("name") == harness.WINDOW]
    if not win:
        return []
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    busy = sorted((max(lo, float(e["ts"])), min(hi, float(e["ts"]) + float(e.get("dur", 0.0))))
                  for e in events if e.get("cat") in harness.DEVICE_CATS)
    gaps, edge = [], lo
    for a, b in busy:
        if b <= a:
            continue
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if hi > edge:
        gaps.append((edge, hi))
    return gaps


def attributed_gaps(events: list[dict]) -> list[tuple[float, float, dict]]:
    """Each idle gap with its seconds by the innermost program span over
    them: [(a, b, {name: s})]."""
    segments = innermost(program_spans(events))
    starts = [s[0] for s in segments]
    out = []
    for a, b in device_gaps(events):
        got: dict[str, float] = {}
        k = max(bisect.bisect_right(starts, a) - 1, 0)
        while k < len(segments) and segments[k][0] < b:
            sa, sb, name = segments[k]
            w = min(b, sb) - max(a, sa)
            if w > 0:
                got[name] = got.get(name, 0.0) + w / 1e6
            k += 1
        out.append((a, b, got))
    return out


def span_labeller(events: list[dict], fallback):
    """A gap labeller for harness.read_trace: a gap is named by the
    innermost program span that covers most of it; a gap no program span
    covers takes `fallback(host, t)`, the entry's own label."""
    gaps = attributed_gaps(events)
    mids = [(a + b) / 2 for a, b, _ in gaps]

    def label(host, t):
        k = bisect.bisect_left(mids, t)
        for a, b, got in gaps[max(k - 1, 0):k + 1]:
            if a <= t <= b and got:
                return max(got.items(), key=lambda kv: kv[1])[0]
        return fallback(host, t)
    return label


def idle_by_span(events: list[dict]) -> dict:
    """The window's idle seconds by the innermost program span; those no
    program span covers; the share below a root span; read_trace's ten
    longest gaps, each named by span_labeller."""
    gaps = attributed_gaps(events)
    by: dict[str, float] = {}
    for _, _, got in gaps:
        for k, v in got.items():
            by[k] = by.get(k, 0.0) + v
    idle = sum(b - a for a, b, _ in gaps) / 1e6
    covered = sum(by.values())
    below = sum(v for k, v in by.items() if k not in ROOTS)
    tr = harness.read_trace(events, span_labeller(events, lambda host, t: "no program span"))
    return {"idle_s": idle, "by_span_s": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "uncovered_s": idle - covered,
            "uncovered_pct": 100.0 * (idle - covered) / idle if idle else None,
            "below_root_pct": 100.0 * below / idle if idle else None,
            "idle_gaps": tr["idle_gaps"] if tr else []}


# ---------------------------------------------------------------- the runs

def recording_trace(metrics):
    """harness.Trace with the program's recording() open inside it; the
    class keeps the last traced window's events and span records as
    `last`."""
    class RecordingTrace(harness.Trace):
        last: tuple = ([], [])

        def __enter__(self):
            super().__enter__()
            self._rec = metrics.recording() if self.on else contextlib.nullcontext([])
            self._spans = self._rec.__enter__()
            return self

        def __exit__(self, *exc):
            self._rec.__exit__(*exc)
            out = super().__exit__(*exc)
            if self.on:
                RecordingTrace.last = (self.events, self._spans)
            return out
    return RecordingTrace


def traced(argv, **kw) -> int:
    """run.py --trace 1 with the spans recorded, then the span readings
    (`kw` goes to run.main: device, config, mix)."""
    from portbench import run
    from portbench.entries import locate, rounds
    from pacbioassembly_tpu_torch.utils import metrics

    cls = recording_trace(metrics)
    real = rounds.Trace, locate.Trace
    rounds.Trace = locate.Trace = cls
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = run.main(argv + ["--trace", "1"], **kw)
    finally:
        rounds.Trace, locate.Trace = real
    sys.stdout.write(out.getvalue())
    if rc != 0:
        return rc
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    events, spans = cls.last
    readings = {"spans": spans}
    values = {}
    for name in READERS:
        v = harness.load_module("metrics", name).read(readings)
        if v is not None:
            values[name] = v
    idle = idle_by_span(events)
    for name, s in list(idle["by_span_s"].items())[:12]:
        harness.log(f"idle {s:.3f} s in {name}")
    harness.log(f"idle {idle['uncovered_s']:.3f} s of {idle['idle_s']:.3f} s in no program "
                f"span ({idle['uncovered_pct']:.2f}%); below a root {idle['below_root_pct']:.2f}%")
    m = {k: v["value"] for k, v in result.get("metrics", {}).items()}
    win = [e for e in events if e.get("name") == harness.WINDOW]
    window_s = float(win[0]["dur"]) / 1e6 if win else None
    calls = sum(1 for s in spans if s["name"] == "locate.map_reads")
    sums = {}
    if "lookup_ms" in m and "probe_ms" in values:
        sums["probe_plus_seeds_over_lookup"] = (
            (values["probe_ms"] + values.get("expand_seeds_ms", 0.0)) / m["lookup_ms"])
    if "host_commit_ms" in m and "host_align_ms" in values:
        sums["host_align_over_host_commit"] = values["host_align_ms"] / m["host_commit_ms"]
    if "checkpoint_ms" in m and "checkpoint_write_ms" in values:
        sums["checkpoint_write_over_checkpoint"] = (
            values["checkpoint_write_ms"] / m["checkpoint_ms"])
    if calls and window_s:
        parts = sum(values.get(k, 0.0) for k in ("locate_index_ms", "locate_triples_ms",
                                                   "locate_fill_ms", "locate_score_ms"))
        sums["locate_parts_over_call"] = parts / (1000.0 * window_s / calls)
    print(json.dumps({"span_metrics": values, "sums": sums, "split_ms": split_ms(spans),
                      "idle": idle, "records": len(spans), "window_s": window_s,
                      "calls": calls}), flush=True)
    return 0


def cost(n: int) -> int:
    """ns a span takes: off, recording, recording under torch.profiler."""
    import torch
    from pacbioassembly_tpu_torch.utils.metrics import recording, span

    def timed():
        t = time.perf_counter_ns()
        for _ in range(n):
            with span("round.expand"):
                pass
        return (time.perf_counter_ns() - t) / n

    def clocks():
        t = time.perf_counter_ns()
        for _ in range(n):
            time.perf_counter_ns()
            time.perf_counter_ns()
        return (time.perf_counter_ns() - t) / n

    P = torch.profiler
    acts = [P.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(P.ProfilerActivity.CUDA)
    out = {"two_clock_reads_ns": min(clocks() for _ in range(5)),
           "off_ns": min(timed() for _ in range(5))}
    with recording():
        out["recording_ns"] = min(timed() for _ in range(5))
    with P.profile(activities=acts), recording():
        out["profiled_ns"] = min(timed() for _ in range(5))
    out["n"] = n
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cost", type=int, default=0, help="time this many spans instead")
    args, rest = ap.parse_known_args(argv)
    if args.cost:
        return cost(args.cost)
    return traced(rest)


if __name__ == "__main__":
    sys.exit(main())
