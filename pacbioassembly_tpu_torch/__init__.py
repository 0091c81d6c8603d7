"""pacbioassembly_tpu_torch — the batch assembly engine on PyTorch + CUDA.

A port of `pacbioassembly_tpu`'s main path (`assemble --engine batch`, one
device, one contig) to PyTorch, with the Pallas TPU kernels rewritten as
hand-written CUDA C++ kernels for Hopper (`csrc/`, built with nvcc for
sm_90a at first use). The JAX package stays the reference: on the same
inputs this package makes the same integer decisions, the same edit
streams, the same vote deltas and the same contig bytes.

Host layers that import no JAX are shared, not copied: config, codec/,
index/seedmap, consensus/state, align/{banded,dispatch,types}, native/,
assemble/{reads,driver,checkpoint}, tools/simulate and utils/metrics come
from `pacbioassembly_tpu` unchanged, all through `host.py`. This package
never imports jax.

Layers (JAX module -> port module):
  align/scan.py      plain torch row DP: the screening oracle
  align/screen.py    batch ladders, size buckets
  align/bitwave.py   screening kernel K1 (csrc/bitwave.cu)
  align/tbwave.py    parent kernel K2 (csrc/tbwave.cu) + walk W (csrc/walk.cu)
  assemble/gather.py device read matrix + batch gather
  consensus/elect.py scatter-add vote delta (parallel/sharded.py elect)
  assemble/batch.py  BatchAssembler round loop
  tools/cli.py       `python -m pacbioassembly_tpu_torch assemble ...`
"""

__version__ = "0.1.0"

from .device import resolve_device

__all__ = ["resolve_device", "__version__"]
