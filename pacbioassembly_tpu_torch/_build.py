"""Build, load and call the hand-written CUDA kernels.

The sources in `csrc/*.cu` have a plain C interface. At first use they are
compiled with nvcc for Hopper (sm_90a), one nvcc per source, all started
together, and linked into one shared library under `build/` (git-ignored),
named by a hash of the sources and flags so an edited source rebuilds, and
loaded with ctypes. Building happens only when a CUDA tensor reaches a
kernel wrapper; importing this module compiles nothing, so the CPU tests
import every module without a toolkit. Each build prints ptxas's report
(`-Xptxas -v`: registers, shared memory, stack and spills per kernel) to
stderr and keeps it in `ptxas_report`.

Every C entry point returns `cudaGetLastError()` after its launch and
`check()` raises on anything but 0: a refused launch never passes
silently. Kernels launch on the current stream of their tensors' card,
with that card made current (`launching`), do not synchronise, and
allocate nothing (the wrappers allocate with torch).

Launch counters: every kernel wrapper adds one to its entry in `LAUNCHES`
where it launches its kernel, and nowhere else; every plain version adds
one to its own entry where it runs. A run can reset them, drive the main
path, and show which kernels carried it.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernels (wrapper-side, counted only where the kernel is launched): the
# screening kernels K1 (bitwave) and K3 (rowdp) by launch kind, the parent
# kernel K2 (tbwave) and the walk W
KERNELS = (
    "bitwave_prefilter", "bitwave_fullscreen", "bitwave_locate",
    "rowdp_prefilter", "rowdp_fullscreen", "rowdp_locate",
    "tbwave", "walk",
)
# plain PyTorch versions (counted where they run)
PLAIN = ("plain_batch_score", "plain_parents", "plain_walk")

LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS + PLAIN, 0)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's build (None = cached)
ptxas_report: list[str] = []  # one line per kernel of this process's build


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + ARCH).encode())
    for s in srcs:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _ptxas_kernels(stderr: str) -> list[tuple[str, dict]]:
    """(mangled name, properties) per kernel from ptxas's -v report:
    registers, shared memory, stack frame and spill bytes."""
    out: list[tuple[str, dict]] = []
    pats = (("registers", r"Used (\d+) registers"), ("smem", r"(\d+) bytes smem"),
            ("stack", r"(\d+) bytes stack frame"), ("spill_stores", r"(\d+) bytes spill stores"),
            ("spill_loads", r"(\d+) bytes spill loads"))
    for line in stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            out.append((m.group(1), {}))
        elif out:
            for key, pat in pats:
                m = re.search(pat, line)
                if m:
                    out[-1][1][key] = int(m.group(1))
    return out


def _short_names(names: list[str], nvcc: str) -> list[str]:
    """Demangled kernel names without namespaces and arguments
    (`tbwave_kernel<8>`), where the toolkit has cu++filt."""
    tool = shutil.which("cu++filt") or os.path.join(os.path.dirname(nvcc), "cu++filt")
    if not names or not os.path.exists(tool):
        return names
    proc = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    full = proc.stdout.splitlines()
    if proc.returncode != 0 or len(full) != len(names):
        return names
    full = [re.sub(r"\((?:anonymous namespace|int|bool)\)", "", f) for f in full]
    return [f.split("(")[0].split("::")[-1] for f in full]


def _build(so_path: str, srcs: list[str]) -> None:
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    report = []
    try:
        for src in (s for s in srcs if s.endswith(".cu")):
            obj = f"{tmp}.{os.path.basename(src)}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.PIPE, text=True,
                                                    start_new_session=True)))
        for cmd, _, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
            report += _ptxas_kernels(err)
        cmd = [nvcc, *ARCH, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, so_path)
    finally:
        # a failed compile stops the others (nvcc and the tools it started);
        # no object or partial library stays
        for _, obj, proc in jobs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            proc.stdout.close()
            proc.stderr.close()
            if os.path.exists(obj):
                os.remove(obj)
        if os.path.exists(tmp):
            os.remove(tmp)
    build_seconds = time.perf_counter() - t0
    names = _short_names([name for name, _ in report], nvcc)
    ptxas_report[:] = [f"{n}: {props}" for n, (_, props) in zip(names, report)]
    for line in ptxas_report:
        print(f"[ptxas] {line}", file=sys.stderr, flush=True)


def _declare(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pb_bitwave.argtypes = [
        P, I, P, I, P, P, I,      # a, LA, b, LB, la, lb, B
        P, P, P, I,               # early_thr, accept_min, band_tab, tab_len
        I, I, I, I,               # la_max, w_max, maxn, maxm
        P, I, I, I, P, P,         # warp path's peq scratch (or null), PW, path, pairs, out, stream
    ]
    lib.pb_bitwave.restype = I
    lib.pb_bitwave_thread_smem.argtypes = [I, I, I, I]  # LA, LB, tab_len, pairs
    lib.pb_bitwave_thread_smem.restype = ctypes.c_longlong
    lib.pb_wavefront.argtypes = [
        P, I, P, I, P, P, I,      # a, LA, b, LB, la, lb, B
        P, P, P, I,               # early_thr, accept_min, band_tab, tab_len
        I, I, I, I,               # la_max, w_max, maxn, maxm
        I, I, P, P,               # warp path, lanes, out, stream
    ]
    lib.pb_wavefront.restype = I
    lib.pb_tbwave.argtypes = [
        P, I, P, I,               # a, LA, b, LB
        P, P, P, I,               # md, len_a, len_b, B
        I, I, I, I, P, P,         # w_max, S, NRB, lanes, out, stream
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


@contextlib.contextmanager
def launching(t):
    """Make `t`'s card the current CUDA device while a wrapper launches its
    kernel there, and yield that card's current stream (a handle for the C
    entry point). The runtime calls of a launch (`cudaFuncSetAttribute`,
    the launch itself) act on the current device, so a tensor on another
    card than the current one would otherwise be handed a stream of a
    device its launch does not run on."""
    import torch

    with torch.cuda.device(t.device):
        yield torch.cuda.current_stream(t.device).cuda_stream


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
