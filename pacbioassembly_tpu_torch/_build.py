"""Build, load and call the hand-written CUDA kernels.

The sources in `csrc/*.cu` have a plain C interface. At first use they are
compiled with nvcc for Hopper (sm_90a) into one shared library under
`build/` (git-ignored), named by a hash of the sources and flags so an
edited source rebuilds, and loaded with ctypes. Building happens only when
a CUDA tensor reaches a kernel wrapper; importing this module compiles
nothing, so the CPU tests import every module without a toolkit.

Every C entry point returns `cudaGetLastError()` after its launch and
`check()` raises on anything but 0: a refused launch never passes
silently. Kernels launch on PyTorch's current stream, do not
synchronise, and allocate nothing (the wrappers allocate with torch).

Launch counters: every kernel wrapper adds one to its entry in `LAUNCHES`
where it launches its kernel, and nowhere else; every plain version adds
one to its own entry where it runs. A run can reset them, drive the main
path, and show which kernels carried it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES: dict[str, int] = {
    # kernels (wrapper-side, only where the kernel is launched)
    "bitwave_prefilter": 0,
    "bitwave_fullscreen": 0,
    "tbwave": 0,
    "walk": 0,
    # plain PyTorch versions (counted where they run)
    "plain_batch_score": 0,
    "plain_parents": 0,
    "plain_walk": 0,
}

KERNELS = ("bitwave_prefilter", "bitwave_fullscreen", "tbwave", "walk")
PLAIN = ("plain_batch_score", "plain_parents", "plain_walk")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's build (None = cached)


def count(name: str) -> None:
    LAUNCHES[name] += 1


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sources() -> list[str]:
    return sorted(
        os.path.join(CSRC_DIR, f)
        for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): cannot build the CUDA kernels")


def _digest(srcs: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _build(so_path: str, srcs: list[str]) -> None:
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *[s for s in srcs if s.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, so_path)
    build_seconds = time.perf_counter() - t0


def _declare(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pb_bitwave.argtypes = [
        P, I, P, I, P, P, I,      # a, LA, b, LB, la, lb, B
        P, P, P, I,               # early_thr, accept_min, band_tab, tab_len
        I, I, I, I,               # la_max, w_max, maxn, maxm
        P, I, P, P,               # peq scratch, PW, out, stream
    ]
    lib.pb_bitwave.restype = I
    lib.pb_tbwave.argtypes = [
        P, I, P, I,               # a, LA, b, LB
        P, P, P, P, I,            # lb, md, len_a, len_b, B
        I, I, I, P, P,            # w_max, S, NRB, out, stream
    ]
    lib.pb_tbwave.restype = I
    lib.pb_walk.argtypes = [
        P, I, I, P, I,            # parents, NRB, S, b, LB
        P, P, P, P, P, I,         # len_b, md, ma, mb, acc, B
        I, I, P, P, P, P,         # w_max, E, ops, vals, nedit, stream
    ]
    lib.pb_walk.restype = I
    lib.pb_error_string.argtypes = [I]
    lib.pb_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The kernel library, built from csrc/ on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        so_path = os.path.join(BUILD_DIR, f"libpbtorch_{_digest(srcs)}.so")
        if not os.path.exists(so_path):
            _build(so_path, srcs)
        lib = ctypes.CDLL(so_path)
        _declare(lib)
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.pb_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {what} failed: error {err} ({msg})")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check_tensor(t, dtype, shape, name: str, device=None) -> None:
    """Raise unless `t` has this dtype and shape (and device, when given)."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or (
        device is not None and t.device != device
    ):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)}"
            f"{'' if device is None else f' on {device}'}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
        )
