"""Port: the package never imports jax (checked in a fresh interpreter,
since this test process has jax loaded), chip_smoke.py reaches the shared
host layers only through the port, and nothing falls back silently:
asking for a GPU without one, a device type the port does not run on, or
a kernel build without nvcc raises."""

import os
import subprocess
import sys

import pytest
import torch

from pacbioassembly_tpu_torch import _build
from pacbioassembly_tpu_torch.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import io, os, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
import pacbioassembly_tpu_torch
from pacbioassembly_tpu_torch import _build, device
from pacbioassembly_tpu_torch.align import bitwave, scan, screen, tbwave
from pacbioassembly_tpu_torch.assemble import batch, gather
from pacbioassembly_tpu_torch.consensus import elect
from pacbioassembly_tpu_torch.tools import cli
from pacbioassembly_tpu_torch.host import (
    AssemblyConfig, ReadStore, SimConfig, binary_io, dna, simulate,
)
import chip_smoke

_, reads, _ = simulate(SimConfig(genome_len=6000, coverage=8.0, mean_read_len=700,
                                 min_read_len=600, max_read_len=900, seed=2,
                                 sub_rate=0.02, ins_rate=0.02, del_rate=0.02))
path = os.path.join(tempfile.mkdtemp(), "r.bin")
with open(path, "wb") as fh:
    binary_io.write_records(fh, reads)
cfg = AssemblyConfig(engine="batch", rng_seed=1, pattern_schedule="roundrobin", max_round=2)
asm = batch.BatchAssembler(cfg, ReadStore.from_file(path, cfg),
                           [dna.parse_pattern("1111111111111111")], device="cpu")
asm.run(out=io.StringIO())
assert asm.nround == 2 and asm.ref.length() > 0
print("JAX_LOADED", "jax" in sys.modules, "PALLAS", any(m.startswith("jax") for m in sys.modules))
"""


def test_port_never_imports_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_LOADED False PALLAS False" in proc.stdout, proc.stdout


def test_chip_smoke_imports_only_the_port():
    """Every import in chip_smoke.py is the standard library, numpy, torch
    or the port itself: never jax, never the JAX package directly."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
    roots = {m.split(".")[0] for m in mods}
    assert "pacbioassembly_tpu_torch" in roots
    assert roots <= set(sys.stdlib_module_names) | {"numpy", "torch", "pacbioassembly_tpu_torch"}, roots


def test_device_resolution_is_explicit(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda:1")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No toolkit, no kernels: the build raises (nothing runs in their
    place). Importing the package compiled nothing."""
    assert _build._lib is None
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))  # holds no bin/nvcc
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_sources_cover_the_three_kernels():
    names = sorted(os.path.basename(s) for s in _build.sources())
    assert names == ["bitwave.cu", "common.cuh", "tbwave.cu", "walk.cu"]
    assert set(_build.KERNELS) | set(_build.PLAIN) == set(_build.LAUNCHES)
