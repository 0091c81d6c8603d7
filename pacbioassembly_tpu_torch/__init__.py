"""pacbioassembly_tpu_torch — the assembly engine on PyTorch + CUDA.

A port of `pacbioassembly_tpu` to PyTorch, with the Pallas TPU kernels
rewritten as hand-written CUDA C++ kernels for Hopper (`csrc/`, built with
nvcc for sm_90a at first use). The JAX package stays the reference: on the
same inputs this package makes the same integer decisions, the same edit
streams, the same vote deltas and the same contig bytes. It imports
neither jax nor anything of `pacbioassembly_tpu`.

Host layers, copied from the JAX package with only their imports (and the
profiler context and the native build directory) changed: config,
codec/{dna,binary_io}, align/{types,banded,dispatch,bitparallel}, native/pbcore (the
AVX2 host aligner, built at first use into build/), index/seedmap,
consensus/state, assemble/{reads,checkpoint,driver}, tools/{simulate,
coverage,fastx} and utils/metrics; tools/postprocess (contig dedupe and
read accounting) is a copy whose read mapping runs on the port's locator. A checkpoint written by either engine resumes in the other.

Device layers (JAX module -> port module):
  align/scan.py      plain torch row DP: the screening oracle
  align/screen.py    screening kernel choice (PBTPU_SCREEN_BACKEND), ladders, buckets
  align/bitwave.py   screening kernel K1 (csrc/bitwave.cu)
  align/wavefront.py screening kernel K3, the row DP (csrc/wavefront.cu)
  align/tbwave.py    parent kernel K2 (csrc/tbwave.cu) + walk W (csrc/walk.cu)
  align/traceback.py scores + edit streams: the screen, K2 and W chained
  align/bitscan.py   word-array Myers screen in torch ops (K1's algebra)
  assemble/gather.py device read matrix + batch gather
  consensus/elect.py scatter-add vote delta (parallel/sharded.py elect)
  consensus/device.py evolve on a device (the host evolve's twin)
  index/device.py    boundary seed index built and searched on a device
  parallel/          the dp mesh (mesh.py; gloo across processes), the
                     sharded screen and summed elect (sharded.py)
  assemble/batch.py  BatchAssembler round loop (single-device, or over a
                     mesh), multi-contig assemble_contigs
  tools/locate.py    batched read -> contig locator
  tools/cli.py       `python -m pacbioassembly_tpu_torch <command>`: every
                     command of the JAX CLI (convert, assemble, import,
                     simulate, locate, visualize, quality, stat-hash)
"""

__version__ = "0.1.0"

from .config import AssemblyConfig, Constants
from .device import resolve_device

__all__ = ["AssemblyConfig", "Constants", "resolve_device", "__version__"]
