"""Shared by the benchmark's tests: the checkout on sys.path, tiny cells on the CPU.

    python -m pytest portbench/tests -q -p no:cacheprovider          # CPU
    python -m pytest portbench/tests -q -p no:cacheprovider -m gpu   # on the card
"""

from __future__ import annotations

import io
import json
import os
import sys
from contextlib import redirect_stdout

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness, run  # noqa: E402

# the cells' own configurations and mixes, cut to a size the plain CPU path holds
TINY_STORE = dict(genome_len=12_000, coverage=8.0, mean_read_len=1000, max_read_len=2500)
TINY_ENGINE = dict(prefilter_min_batch=4, edge_retreat_min_len=1500, max_seq_len=60_000,
                   checkpoint_every=2)


def tiny(cell: str) -> tuple[dict, dict]:
    man = harness.manifest()
    w = next(w for w in man["workloads"] if w["name"] == cell)
    conf = harness.load_json("configs", w["config"])
    mix = harness.load_json("mixes", w["traffic"])
    conf["store"].update(TINY_STORE)
    conf["engine"].update(TINY_ENGINE)
    if mix["entry"] == "rounds":
        mix["check"].update(rounds=1, span=0.0)  # the window's first round: a tiny window has few
        mix.update(warm_contig_len=2000, fixed_span=4000)
    else:
        mix.update(reads_per_call=30, check_reads=1000)  # every read of the window
    return conf, mix


def run_cell(cell: str, seed: int, seconds: float, *, trace=0, device="cpu", config=None,
             mix=None, control=False) -> tuple[int, dict | None]:
    """Run a cell in this process; (exit code, its result line or None)."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device=device, config=config, mix=mix,
                      control=control)
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if rc == 0 and lines else None
