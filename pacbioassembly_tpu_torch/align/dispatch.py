"""Backend dispatch for exact (host) alignment.

exact_align() runs the sequential-parity banded DP. It prefers the native
C++ core (native/pbcore.cpp) and falls back to the vectorized numpy
implementation (banded.py); both produce identical results (verified by
the differential tests in tests/test_aligner.py).
"""

from __future__ import annotations

import os

import numpy as np

from ..config import Constants
from .banded import align_banded
from .types import AlignResult

_native_lib = None
_native_checked = False


def _get_native():
    global _native_lib, _native_checked
    if not _native_checked:
        _native_checked = True
        if os.environ.get("PBTPU_DISABLE_NATIVE"):
            _native_lib = None
        else:
            try:
                from ..native import pbcore

                _native_lib = pbcore.load(optional=True)
            except Exception:
                _native_lib = None
    return _native_lib


def exact_align(
    a: np.ndarray,
    b: np.ndarray,
    ratio: float = Constants.MAXR,
    maxn: int = Constants.ALIGNER_MAXN,
    maxm: int = Constants.ALIGNER_MAXM,
    quirk_stale_dp: bool = False,
) -> AlignResult | None:
    lib = _get_native()
    if lib is not None:
        from ..native import pbcore

        return pbcore.align(lib, a, b, ratio, maxn, maxm, quirk=quirk_stale_dp)
    if quirk_stale_dp:
        raise RuntimeError(
            "quirk_stale_dp parity mode requires the native core (libpbcore.so)"
        )
    return align_banded(a, b, ratio, maxn, maxm)


def quirk_dp_reset() -> None:
    """Reset the persistent quirk DP matrix to the fresh-process state."""
    lib = _get_native()
    if lib is not None:
        from ..native import pbcore

        pbcore.quirk_reset(lib)
