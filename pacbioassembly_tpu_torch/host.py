"""The host layers this package shares with pacbioassembly_tpu.

These modules import no JAX, so the port uses them unchanged instead of
copying them: the configuration, the 2-bit codec and read records, the
spaced-seed index, the consensus state, the exact host aligner (the AVX2
core in native/), the read store, round statistics, checkpoints, the read
simulator and the metrics log. Every module of the port, and chip_smoke.py,
reaches them through here, so this is the one module that names the JAX
package. tests/test_torch_imports.py checks, in a fresh process, that
loading them leaves jax out of sys.modules.
"""

from pacbioassembly_tpu.align import exact_align
from pacbioassembly_tpu.align.types import DELETE, INSERT, MATCH
from pacbioassembly_tpu.assemble.checkpoint import load_checkpoint, save_checkpoint
from pacbioassembly_tpu.assemble.driver import Assembler, RoundStats, init_reference
from pacbioassembly_tpu.assemble.reads import ReadStore
from pacbioassembly_tpu.codec import binary_io, dna
from pacbioassembly_tpu.config import AssemblyConfig, Constants
from pacbioassembly_tpu.consensus import ConsensusRef
from pacbioassembly_tpu.index import SeedIndex, build_seedmap
from pacbioassembly_tpu.native import pbcore
from pacbioassembly_tpu.tools.simulate import SimConfig, cmd_simulate, mutate_read, simulate
from pacbioassembly_tpu.utils.metrics import MetricsLogger

__all__ = [
    "exact_align", "DELETE", "INSERT", "MATCH", "load_checkpoint", "save_checkpoint",
    "Assembler", "RoundStats", "init_reference", "ReadStore", "binary_io", "dna",
    "AssemblyConfig", "Constants", "ConsensusRef", "SeedIndex", "build_seedmap", "pbcore",
    "SimConfig", "cmd_simulate", "mutate_read", "simulate", "MetricsLogger",
]
