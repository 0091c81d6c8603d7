"""Port: the package imports neither jax nor anything of the JAX package
(checked in a fresh interpreter, since this test process has both loaded,
and by parsing every source; the fresh interpreter also drives multi-contig
assembly, its dedupe and read accounting, the coverage evaluation, the
FASTA parser, the engine on a 2-shard mesh and the device twins), it exports the JAX package's names, chip_smoke.py imports
only the port, and
nothing falls back silently: asking for a GPU without one, a device type
the port does not run on, or a kernel build without nvcc raises."""

import ast
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
from pacbioassembly_tpu_torch.align import (bitparallel, bitscan, bitwave, scan, screen,
                                             tbwave, traceback, wavefront)
from pacbioassembly_tpu_torch.assemble import ReadStore, batch, gather
from pacbioassembly_tpu_torch.codec import binary_io, dna
from pacbioassembly_tpu_torch.config import AssemblyConfig
from pacbioassembly_tpu_torch.consensus import elect
from pacbioassembly_tpu_torch.consensus import device as consensus_device
from pacbioassembly_tpu_torch.index import device as index_device
from pacbioassembly_tpu_torch.parallel import make_mesh
from pacbioassembly_tpu_torch.tools import cli, coverage, fastx, locate, postprocess
from pacbioassembly_tpu_torch.tools.simulate import SimConfig, simulate
import chip_smoke
assert pacbioassembly_tpu_torch.AssemblyConfig is AssemblyConfig

genome, reads, _ = simulate(SimConfig(genome_len=6000, coverage=8.0, mean_read_len=700,
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
mesh_asm = batch.BatchAssembler(cfg, ReadStore.from_file(path, cfg),
                                [dna.parse_pattern("1111111111111111")], device="cpu",
                                mesh=make_mesh(devices=["cpu"] * 2))
mesh_asm.run(out=io.StringIO())
assert mesh_asm.ref.text().tolist() == asm.ref.text().tolist()
consensus_device.evolve_on_device(mesh_asm.ref, device="cpu")
idx = index_device.device_build_seedmap(torch.from_numpy(mesh_asm.ref.text().copy()),
                                        mesh_asm.ref.length(), 0xFFFFFFFF)
assert int(idx.n_entries) > 0 and bitparallel.bp_score(genome[:200], genome[:200]) is not None
rows, n = locate.map_reads(genome, dna.parse_pattern("1111111111111111"), reads[:6], 0.15,
                           device="cpu", screen_kernel="rowdp")
assert n == 6 and len(rows) >= 3
contigs, left = batch.assemble_contigs(cfg, ReadStore.from_file(path, cfg),
                                       [dna.parse_pattern("1111111111111111")], 2, device="cpu")
assert len(contigs) >= 1 and len(left) < len(reads)
acct = postprocess.classify_reads([c.codes for c in contigs], [reads[i] for i in left[:4]],
                                  dna.parse_pattern("1111111111111111"), 0.3, min_contig=500,
                                  device="cpu")
assert acct["total"] == len(left[:4])
assert coverage.evaluate_assembly(genome, [c.codes for c in contigs])["genome_len"] == 6000
assert [r[1] for r in fastx.parse_fastx(io.StringIO(">a\nACGT\n"))] == ["ACGT"]
print("JAX_LOADED", "jax" in sys.modules, "PALLAS", any(m.startswith("jax") for m in sys.modules),
      "JAX_PACKAGE", sorted(m for m in sys.modules if m.split(".")[0] == "pacbioassembly_tpu"))
"""


def test_port_exports_the_jax_packages_names():
    import pacbioassembly_tpu
    import pacbioassembly_tpu_torch
    from pacbioassembly_tpu_torch.config import AssemblyConfig, Constants

    assert set(pacbioassembly_tpu.__all__) <= set(pacbioassembly_tpu_torch.__all__)
    assert pacbioassembly_tpu_torch.AssemblyConfig is AssemblyConfig
    assert pacbioassembly_tpu_torch.Constants is Constants


def test_port_never_imports_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_LOADED False PALLAS False JAX_PACKAGE []" in proc.stdout, proc.stdout


def _imports(path):
    """Absolute module names imported anywhere in one source file."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_the_jax_package():
    """No module of the port, and not chip_smoke.py, imports anything whose
    root is pacbioassembly_tpu (nor jax): the port keeps its own copies."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "pacbioassembly_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 25
    bad = [(os.path.relpath(p, REPO), m) for p in paths for m in _imports(p)
           if m.split(".")[0] in ("pacbioassembly_tpu", "jax")]
    assert bad == []


def test_chip_smoke_imports_only_the_port():
    """Every import in chip_smoke.py is the standard library, numpy, torch
    or the port itself: never jax, never the JAX package directly."""
    roots = {m.split(".")[0] for m in _imports(os.path.join(REPO, "chip_smoke.py"))}
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
    assert names == ["bitwave.cu", "common.cuh", "tbwave.cu", "walk.cu", "wavefront.cu"]
    assert set(_build.KERNELS) | set(_build.PLAIN) == set(_build.LAUNCHES)
