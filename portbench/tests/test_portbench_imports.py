"""What the benchmark loads and opens.

A tiny run in a fresh process, under an audit hook: no module whose
top-level name is jax, jaxlib, flax or pacbioassembly_tpu (compared whole,
so pacbioassembly_tpu_torch does not match), and no file opened under
benchmarks/ or bench.py. The reference alone loads nothing of the port.
In a directory that holds only BENCHMARK.json and portbench/, a run exits
non-zero without a result.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

PROBE = r"""
import json, os, sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" and args
                 and isinstance(args[0], (str, bytes, os.PathLike)) else None)
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, os.path.join(sys.argv[1], "portbench", "tests"))
from conftest import run_cell, tiny
cell = sys.argv[2]
conf, mix = tiny(cell)
rc, res = run_cell(cell, 3, 0.5, trace=int(sys.argv[3]), config=conf, mix=mix)
print(json.dumps({"rc": rc, "correct": res and res["correct"],
                  "modules": sorted({m.split(".")[0] for m in sys.modules}),
                  "opened": sorted(set(opened))}))
"""


def probe(cell, trace=0):
    out = subprocess.run([sys.executable, "-c", PROBE, ROOT, cell, str(trace)], capture_output=True,
                         text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_runs_load_no_jax_and_open_no_old_benchmark():
    for cell, trace in (("ecoli_3pct.grow", 1), ("ecoli_3pct.locate", 0)):
        got = probe(cell, trace)
        assert got["rc"] == 0 and got["correct"]
        assert not set(got["modules"]) & {"jax", "jaxlib", "flax", "pacbioassembly_tpu"}
        assert "pacbioassembly_tpu_torch" in got["modules"]
        old = (os.path.join(ROOT, "benchmarks"), os.path.join(ROOT, "bench.py"))
        assert not [p for p in got["opened"] if os.path.abspath(p).startswith(old)]


def test_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import pkgutil, importlib, portbench.reference as r; "
            "[importlib.import_module('portbench.reference.' + m.name) for m in pkgutil.iter_modules(r.__path__)]; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True, check=True)
    mods = set(eval(out.stdout))
    assert not mods & {"jax", "jaxlib", "flax", "pacbioassembly_tpu", "pacbioassembly_tpu_torch"}


def test_sources_name_no_old_benchmark_path():
    here = os.path.join(ROOT, "portbench")
    for dirpath, _, files in os.walk(here):
        if os.path.basename(dirpath) in ("tests", "__pycache__"):
            continue
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                assert "benchmarks/" not in text and "bench.py" not in text, f


def test_alone_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); from portbench import run; "
            "sys.exit(run.main(['--workload', 'ecoli_3pct.locate', '--seed', '1', '--seconds', '1'], "
            "device='cpu'))")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    # and the command itself, here without a card
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ecoli_3pct.locate",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
