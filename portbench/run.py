"""The benchmark of the PyTorch and CUDA port (pacbioassembly_tpu_torch).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json on the card this process finds: set-up
(the inputs made from the seed, the engine built and warmed up), then a
measured window of `--seconds`, then the check of what the window produced
against the plain reference (portbench/reference/). It prints the checks
as the last lines of standard error and one JSON result as the last line
of standard output: with `--trace 0` the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read under torch.profiler. It exits
non-zero, with no result, without enough CUDA cards, and when the JAX
package or JAX is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402
from portbench.reference.engine import encode_seeds  # noqa: E402

# the control: each screening launch scored on the first bases of its b side only
CONTROL_PREFIX = 128


def pattern_mask(p: str) -> int:
    """A spaced-seed pattern ('1' = care) as the uint32 mask of its 16 codes."""
    import numpy as np

    codes = np.array([3 if c == "1" else 0 for c in p.strip()[:16].ljust(16, "*")], np.uint8)
    return int(encode_seeds(codes, np.zeros(1, np.int64))[0])


class Run:
    """What an entry gets: the inputs of the run and the harness's hooks."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def log(self, *a):
        harness.log(*a)


def install_control(torch):
    """Wrap the program's K1 wrapper so that every screening launch scores
    only the first CONTROL_PREFIX bases of its b side (the prefilter's
    window) at the launch's own ratio."""
    from pacbioassembly_tpu_torch.align import bitwave

    real = bitwave.batch_score_bitwave

    def truncated(a, la, b, lb, **kw):
        return real(a, la, b, lb.clamp(max=CONTROL_PREFIX), **kw)

    bitwave.batch_score_bitwave = truncated
    return lambda: setattr(bitwave, "batch_score_bitwave", real)


def main(argv=None, *, device=None, config=None, mix=None, control=False) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    clock = harness.Clock(T0 if device is None else None)

    man = harness.manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if args.workload not in cells:
        harness.log(f"no workload {args.workload!r} in BENCHMARK.json ({sorted(cells)})")
        return 2
    cell = cells[args.workload]
    conf = config or harness.load_json("configs", cell["config"])
    mixd = mix or harness.load_json("mixes", cell["traffic"])

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            harness.log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                        f"torch.cuda.is_available() = {torch.cuda.is_available()}")
            return 2
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device(device)
    import pacbioassembly_tpu_torch  # noqa: F401  (the program under test)

    undo = []
    try:
        return measure(args, man, cell, conf, mixd, torch, dev, clock,
                       lambda: undo.append(install_control(torch)) if control else None)
    finally:
        for u in undo:
            u()


def measure(args, man, cell, conf, mixd, torch, dev, clock, open_window) -> int:
    """Run the cell's entry and print its result; `open_window` is called
    as the measured window opens (it installs the control, if any)."""
    peak = {}

    def close_window():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            peak["bytes"] = int(torch.cuda.max_memory_allocated(dev))
        bad = harness.forbidden_modules()
        if bad:
            harness.log(f"loaded once the window closed: {bad}")
            raise SystemExit(3)

    r = Run(torch=torch, dev=dev, config=conf, mix=mixd, seed=args.seed, seconds=args.seconds,
            trace=bool(args.trace), clock=clock, open_window=open_window,
            close_window=close_window,
            patterns=[pattern_mask(p) for p in conf["patterns"]])
    entry = importlib.import_module(f"portbench.entries.{mixd['entry']}")
    out = entry.run(r)

    device_out = harness.device_info(torch, dev, cell["chips"])
    device_out["memory_peak_bytes"] = peak.get("bytes", 0)
    readings = out["readings"]
    result = {"correct": harness.checks_ok(out["checks"]), "attempted": out["attempted"],
              "failed": out["failed"]}
    if args.trace:
        metrics = {}
        for m in harness.cell_metrics(man, args.workload, "per_layer"):
            v = harness.load_module("metrics", m["name"]).read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        tr = readings.get("trace") or {}
        device_out.update(busy_s=tr.get("busy_s", 0.0), window_s=tr.get("window_s", 0.0))
        result.update(metrics=metrics, device=device_out)
        result["breakdown"] = {"device_ops": tr.get("device_ops", []),
                               "idle_gaps": tr.get("idle_gaps", [])}
    else:
        values = dict(out["end_to_end"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in harness.cell_metrics(man, args.workload, "end_to_end")}
        result.update(metrics=metrics, device=device_out)
    result["checks"] = out["checks"]
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"loaded once the window closed: {bad}")
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
