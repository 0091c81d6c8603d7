"""ctypes bindings for the native host core (libpbcore.so).

The library is built on demand the first time it is needed, with the
flags of the JAX package's native/Makefile, into the port's git-ignored
build/ directory (never next to the JAX copy, whose library the port never
loads). A library older than its source is rebuilt. A file lock makes
concurrent processes (pytest-xdist workers) build it once. Set
PBTPU_DISABLE_NATIVE=1 to force the pure numpy fallbacks.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..align.types import AlignResult
from ..config import Constants

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libpbcore.so")
_SRC_PATH = os.path.join(_HERE, "pbcore.cpp")
# the JAX package's native/Makefile: CXX ?= g++, CXXFLAGS ?= ...
_CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")
_build_lock = threading.Lock()
_lib_cache: Optional[ctypes.CDLL] = None


def _fresh() -> bool:
    return os.path.exists(_LIB_PATH) and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(
        _SRC_PATH
    )


def _ensure_built() -> bool:
    if _fresh():
        return True
    with _build_lock:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        with open(_LIB_PATH + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if _fresh():
                return True
            tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
            try:
                subprocess.run(
                    [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", tmp, _SRC_PATH],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, _LIB_PATH)
                return True
            except Exception:
                return False


def load(optional: bool = False) -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library."""
    global _lib_cache
    if _lib_cache is not None:
        return _lib_cache
    if not _ensure_built():
        if optional:
            return None
        raise RuntimeError("failed to build libpbcore.so")
    lib = ctypes.CDLL(_LIB_PATH)

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)

    lib.pb_align.restype = ctypes.c_int
    lib.pb_align.argtypes = [
        u8p, ctypes.c_int, u8p, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, ctypes.c_int,
        i32p, u8p, u8p, ctypes.c_int64,
    ]
    lib.pb_align_quirk.restype = ctypes.c_int
    lib.pb_align_quirk.argtypes = lib.pb_align.argtypes
    # reference scalar row loop, exported for SIMD differential fuzzing
    lib.pb_align_scalar.restype = ctypes.c_int
    lib.pb_align_scalar.argtypes = lib.pb_align.argtypes
    lib.pb_quirk_reset.restype = None
    lib.pb_quirk_reset.argtypes = []
    lib.pb_scan_records.restype = ctypes.c_int64
    lib.pb_scan_records.argtypes = [u8p, ctypes.c_int64, i64p, i64p, ctypes.c_int64]
    lib.pb_pack.restype = None
    lib.pb_pack.argtypes = [u8p, ctypes.c_int64, u8p]
    lib.pb_unpack.restype = None
    lib.pb_unpack.argtypes = [u8p, ctypes.c_int64, u8p]

    _lib_cache = lib
    return lib


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def quirk_reset(lib: ctypes.CDLL) -> None:
    """Zero the persistent quirk DP matrix (fresh-process emulation)."""
    lib.pb_quirk_reset()


def align(
    lib: ctypes.CDLL,
    a: np.ndarray,
    b: np.ndarray,
    ratio: float = Constants.MAXR,
    maxn: int = Constants.ALIGNER_MAXN,
    maxm: int = Constants.ALIGNER_MAXM,
    quirk: bool = False,
    scalar: bool = False,
) -> Optional[AlignResult]:
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    cap = len(a) + len(b) + 2
    meta = np.zeros(5, dtype=np.int32)
    ops = np.empty(cap, dtype=np.uint8)
    vals = np.empty(cap, dtype=np.uint8)
    fn = (
        lib.pb_align_quirk
        if quirk
        else (lib.pb_align_scalar if scalar else lib.pb_align)
    )
    rc = fn(
        _u8ptr(a), len(a), _u8ptr(b), len(b),
        ctypes.c_double(ratio), maxn, maxm,
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _u8ptr(ops), _u8ptr(vals), cap,
    )
    if rc == 0:
        return None
    if rc < 0:
        raise RuntimeError(f"pb_align failed with rc={rc}")
    nedit = int(meta[3])
    from ..align.banded import compute_band_params

    p = compute_band_params(len(a), len(b), ratio, maxn, maxm)
    return AlignResult(
        matlen_a=int(meta[0]),
        matlen_b=int(meta[1]),
        cost=int(meta[2]),
        ops=ops[:nedit].copy(),
        vals=vals[:nedit].copy(),
        len_a=p.len_a,
        len_b=p.len_b,
        max_dst=p.max_dst,
        diag_cost=int(meta[4]),
    )


def scan_records(lib: ctypes.CDLL, buf: np.ndarray):
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    n = lib.pb_scan_records(_u8ptr(buf), len(buf), None, None, 0)
    offsets = np.empty(n, dtype=np.int64)
    lengths = np.empty(n, dtype=np.int64)
    lib.pb_scan_records(
        _u8ptr(buf),
        len(buf),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
    )
    return offsets, lengths
