"""Banded alignment: the host aligner (types, banded, dispatch: copies of the
JAX package's modules) and, in submodules imported by name, the plain row DP
and the CUDA kernels. Importing this package loads neither torch nor a
kernel."""

from .types import MATCH, INSERT, DELETE, AlignResult, AlignParams
from .banded import align_banded, compute_band_params
from .dispatch import exact_align
