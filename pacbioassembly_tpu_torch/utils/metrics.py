"""Structured metrics and profiling.

Replaces the reference's stderr LOG counters (_ntrials, per-round seedmap
size / ref length / match lines — spaced_seed.cpp:413-442, SURVEY.md §5)
with JSONL round records plus an optional torch.profiler trace context.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Optional, TextIO


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
    """torch.profiler trace into trace_dir/trace.json (no-op when trace_dir
    is None). The JAX package's copy wraps jax.profiler.trace instead."""
    if not trace_dir:
        yield
        return
    import os

    import torch

    os.makedirs(trace_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
