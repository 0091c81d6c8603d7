"""Structured metrics, spans and profiling.

Replaces the reference's stderr LOG counters (_ntrials, per-round seedmap
size / ref length / match lines — spaced_seed.cpp:413-442, SURVEY.md §5)
with JSONL round records plus an optional torch.profiler trace context.
`span` names an interval of the program's host code (the round's phases,
each device launch, the checkpoint, the locator's steps); inside
`recording()` or `profiled()` they appear in the profiler's trace, and
inside `recording()` they are also kept.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from time import perf_counter_ns
from typing import Optional, TextIO

# True inside recording() or profiled(): the one flag a span checks
_ON = False
# the records of the open recording(), or None (under profiled() alone
# the spans only annotate the trace)
_REC: Optional[list] = None
_TLS = threading.local()
_LOCK = threading.Lock()


class span:
    """A named interval of host code, timed on perf_counter_ns:

        with span("round.expand") as sp:
            ...
        seconds = sp.s

    Outside `recording()` and `profiled()` a span takes its two clock
    reads and checks one flag. Inside either, it enters
    torch.profiler.record_function(name), which puts it in the profiler's
    trace as a user_annotation on the clock of the device's kernels,
    copies and memsets. Inside `recording()` it also appends a record:
    name, id, the id of the innermost span open on its thread as
    `parent`, the id of its root, start_ns, end_ns and the count `n`. A
    span opened with no open parent on its thread is a root, with `root`
    as its root id (the round number, a call number); a child takes its
    parent's. `n`, a count of the span's work, may be set inside the
    span (None by default)."""

    __slots__ = ("name", "n", "root", "t0", "t1", "_rec")

    def __init__(self, name: str, root=None):
        self.name = name
        self.n: Optional[int] = None
        self.root = root
        self._rec = None

    def __enter__(self) -> "span":
        if _ON:
            self._open()
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        self.t1 = perf_counter_ns()
        if self._rec is not None:
            self._close()
        return False

    @property
    def s(self) -> float:
        """The span's seconds."""
        return (self.t1 - self.t0) / 1e9

    def _open(self) -> None:
        import torch

        rec = stack = None
        records = _REC
        if records is not None:
            stack = getattr(_TLS, "stack", None)
            if stack is None:
                stack = _TLS.stack = []
            top = stack[-1] if stack else None
            rec = {"name": self.name, "parent": None if top is None else top["id"],
                   "root": self.root if top is None else top["root"],
                   "start_ns": 0, "end_ns": 0, "n": None}
            with _LOCK:
                rec["id"] = len(records)
                records.append(rec)
            stack.append(rec)
        fn = torch.profiler.record_function(self.name)
        fn.__enter__()
        self._rec = (rec, stack, fn)

    def _close(self) -> None:
        rec, stack, fn = self._rec
        self._rec = None
        if rec is not None:
            rec.update(start_ns=self.t0, end_ns=self.t1, n=self.n)
            stack.pop()
        fn.__exit__(None, None, None)


@contextlib.contextmanager
def recording():
    """Keep every span opened inside; yields the list of their records, in
    the order the spans opened (a record's id is its index). Nested, it
    yields the open recording's list."""
    global _ON, _REC
    if _REC is not None:
        yield _REC
        return
    was_on = _ON
    records: list = []
    _TLS.stack = []
    _REC, _ON = records, True
    try:
        yield records
    finally:
        _REC, _ON = None, was_on


class MetricsLogger:
    """Per-round JSONL metrics: one line per round with timing, throughput
    (cells/s, reads/s), match counts, and reference growth."""

    def __init__(self, stream: Optional[TextIO] = None, path: Optional[str] = None):
        self.stream = stream
        self.fh = open(path, "a") if path else None
        self._t0 = time.time()
        self._round_t = self._t0

    def round(self, stats, extra: Optional[dict] = None) -> dict:
        now = time.time()
        rec = {
            "event": "round",
            "t": round(now - self._t0, 3),
            "round_s": round(now - self._round_t, 3),
        }
        rec.update(dataclasses.asdict(stats))
        if stats.dp_cells and rec["round_s"] > 0:
            rec["dp_cells_per_s"] = round(stats.dp_cells / rec["round_s"], 1)
        if extra:
            rec.update(extra)
        self._round_t = now
        self._emit(rec)
        return rec

    def event(self, name: str, **kw) -> None:
        self._emit({"event": name, "t": round(time.time() - self._t0, 3), **kw})

    def _emit(self, rec: dict) -> None:
        line = json.dumps(rec)
        if self.stream:
            self.stream.write(line + "\n")
            self.stream.flush()
        if self.fh:
            self.fh.write(line + "\n")
            self.fh.flush()

    def close(self) -> None:
        if self.fh:
            self.fh.close()


@contextlib.contextmanager
def profiled(trace_dir: Optional[str]):
    """torch.profiler trace into trace_dir/trace.json, the spans named in
    it (no-op when trace_dir is None). The JAX package's copy wraps
    jax.profiler.trace instead."""
    if not trace_dir:
        yield
        return
    import os

    import torch

    os.makedirs(trace_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    global _ON
    was_on = _ON
    with torch.profiler.profile(activities=acts) as prof:
        _ON = True
        try:
            yield
        finally:
            _ON = was_on
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
