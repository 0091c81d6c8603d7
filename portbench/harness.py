"""What every cell shares: finding its files by name, the device, the trace, the result line.

A cell of BENCHMARK.json names a configuration (portbench/configs/<name>.json),
a traffic mix (portbench/mixes/<name>.json, whose "entry" names the general
code in portbench/entries/ that drives it) and, through the per-layer
metrics that list it, the readers portbench/metrics/<metric>.py. A new
configuration, mix or metric is a new file found by its name.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import os
import re
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "pacbioassembly_tpu")
WINDOW, STEP, CHECKPOINT = "portbench.window", "portbench.step", "portbench.checkpoint"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
KERNEL_CLASSES = (("K1", r"bitwave"), ("K2", r"tbwave"), ("W", r"walk_kernel"), ("K3", r"wavefront"))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def load_json(kind: str, name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, kind, f"{name}.json")) as fh:
        return json.load(fh)


def load_module(kind: str, name: str, root: str = HERE):
    """portbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(root, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(man: dict, cell: str, section: str) -> list[dict]:
    """The metrics of `section` a cell reports: those that list it, and
    those without a list that move (or, end to end, are) a metric the cell
    reports."""
    e2e = [m for m in man["end_to_end"] if cell in m.get("workloads", [cell])]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if ((cell in m["workloads"]) if "workloads" in m else (m["moves"] in names))]


def forbidden_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def device_info(torch, dev, count: int) -> dict:
    return {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": count}


class Trace:
    """torch.profiler over the measured window (CPU and CUDA activity);
    `span(name)` marks host spans that the reading of the trace uses: the
    window, each step and each checkpoint save."""

    def __init__(self, torch, on: bool):
        self.torch, self.on, self.prof, self.events = torch, on, None, []

    def __enter__(self):
        if self.on:
            P = self.torch.profiler
            acts = [P.ProfilerActivity.CPU]
            if self.torch.cuda.is_available():
                acts.append(P.ProfilerActivity.CUDA)
            self.prof = P.profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is None:
            return False
        self.prof.__exit__(*exc)
        if exc[0] is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self.prof.export_chrome_trace(path)
                with open(path) as fh:
                    raw = json.load(fh)["traceEvents"]
            finally:
                os.remove(path)
            self.events = [e for e in raw if e.get("ph") == "X" and "ts" in e]
        self.prof = None
        return False

    def span(self, name: str):
        if not self.on:
            import contextlib

            return contextlib.nullcontext()
        return self.torch.profiler.record_function(name)


def kernel_class(name: str) -> str:
    for cls, pat in KERNEL_CLASSES:
        if re.search(pat, name):
            return cls
    return "other"


def short_name(e: dict) -> str:
    """A kernel's name without its return type, namespaces and arguments."""
    if e.get("cat") != "kernel":
        return e.get("cat")
    name = e.get("name", "").replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name).split("(")[0]
    return re.sub(r"^(\w+::)+", "", name)[:80] or "kernel"


def read_trace(events: list[dict], label) -> dict | None:
    """Device view of the window: busy seconds (the union of kernel, copy
    and memset spans inside the window's own bounds), the window's length,
    device seconds by kernel class and by name, and the idle gaps labelled
    by `label(host span list, t_us)` with what the host was doing."""
    win = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not win:
        return None
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    spans, by_class, by_name = [], {}, {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = max(lo, float(e["ts"]))
        b = min(hi, float(e["ts"]) + float(e.get("dur", 0.0)))
        if b <= a:
            continue
        spans.append((a, b))
        s = (b - a) / 1e6
        if e["cat"] == "kernel":
            c = kernel_class(e.get("name", ""))
            by_class[c] = by_class.get(c, 0.0) + s
        n = short_name(e)
        by_name[n] = by_name.get(n, 0.0) + s
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                  if e.get("cat") == "user_annotation" and e.get("name") in (STEP, CHECKPOINT))
    spans.sort()
    busy, gaps, cur = 0.0, [], None
    edge = lo
    for a, b in spans:
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            if a > edge:
                gaps.append((edge, a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
        edge = max(edge, cur[1])
    if cur is not None:
        busy += cur[1] - cur[0]
    if hi > edge:
        gaps.append((edge, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "busy_s": busy / 1e6,
        "window_s": (hi - lo) / 1e6,
        "kernel_s": by_class,
        "device_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:10],
        "idle_gaps": [[label(host, (a + b) / 2), (b - a) / 1e6] for a, b in gaps[:10]],
    }


def host_phase(steps: list[dict], names: tuple[str, ...]):
    """A gap labeller: inside the i-th step span, the phase that holds the
    moment, from the step's phase seconds in `steps[i]` (consecutive from
    the step's start, in the order of `names`); a checkpoint span; or
    between steps."""
    def label(host, t):
        starts = [h[0] for h in host]
        k = bisect.bisect_right(starts, t) - 1
        if k < 0 or t > host[k][1]:
            return "between steps"
        if host[k][2] == CHECKPOINT:
            return "checkpoint"
        i = sum(1 for h in host[:k] if h[2] == STEP)
        at = host[k][0]
        for n in names if i < len(steps) else ():
            at += 1e6 * steps[i].get(n, 0.0)
            if t <= at:
                return n.removesuffix("_s")
        return "rest of the step"
    return label


def checks_ok(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def emit(result: dict) -> None:
    """The checks as the last lines of standard error; the result as the
    last line of standard output, the checks last in it."""
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)


class Clock:
    """Seconds since the process started the harness."""

    def __init__(self, t0: float | None = None):
        self.t0 = time.perf_counter() if t0 is None else t0

    def __call__(self) -> float:
        return time.perf_counter() - self.t0
