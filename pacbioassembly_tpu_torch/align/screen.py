"""Screening selection and batch geometry.

Port of pacbioassembly_tpu/align/screen.py. `screen_kernel` reads the JAX
package's own variable, PBTPU_SCREEN_BACKEND, with the JAX names: unset or
`bitpallas` picks the bit-parallel kernel K1 (align/bitwave.py), `pallas`
the row-DP kernel K3 (align/wavefront.py), and `scan` the plain row DP
(align/scan.py), which only a CPU device runs. Any other value raises; the
JAX package falls back to `scan` instead. The variable is read once, by the
CLI: the engine and the locator take the kernel as an argument
(`screen_kernel="bitwave" | "rowdp"`), and `score_batch` routes each launch
to that kernel's wrapper. A wrapper launches its kernel on CUDA tensors and
runs the plain row DP on CPU tensors, so on a CPU device every name runs
the scan.
"""

from __future__ import annotations

import os

import numpy as np

from ..config import Constants

SCREEN_KERNELS = ("bitwave", "rowdp")
# PBTPU_SCREEN_BACKEND (the JAX package's names) -> screening kernel
BACKENDS = {"bitpallas": "bitwave", "pallas": "rowdp", "scan": "bitwave"}


def screen_kernel(device, environ=None) -> str:
    """The screening kernel PBTPU_SCREEN_BACKEND names for `device`
    (`cuda`, `cuda:N` or `cpu`); raises on an unknown name, and on `scan`
    for any device but the CPU."""
    name = (os.environ if environ is None else environ).get("PBTPU_SCREEN_BACKEND") or "bitpallas"
    if name not in BACKENDS:
        raise ValueError(
            f"unknown PBTPU_SCREEN_BACKEND {name!r} (expected one of {sorted(BACKENDS)})"
        )
    if name == "scan" and str(device).split(":")[0] != "cpu":
        raise ValueError(
            f"PBTPU_SCREEN_BACKEND=scan is the plain row DP, which runs only on the CPU "
            f"(device {device!r}); use bitpallas (K1) or pallas (K3) on the card"
        )
    return BACKENDS[name]


def score_batch(
    a, la, b, lb, *, screen_kernel: str, kind: str, la_max: int, w_max: int,
    ratio: float = Constants.MAXR,
    maxn: int = Constants.ALIGNER_MAXN,
    maxm: int = Constants.ALIGNER_MAXM,
):
    """Score one batch with the chosen screening kernel's wrapper
    (BatchScores; `kind` names the launch counter)."""
    from . import bitwave, wavefront

    if screen_kernel == "bitwave":
        fn = bitwave.batch_score_bitwave
    elif screen_kernel == "rowdp":
        fn = wavefront.batch_score_rowdp
    else:
        raise ValueError(f"unknown screening kernel {screen_kernel!r} (expected {SCREEN_KERNELS})")
    return fn(a, la, b, lb, la_max=la_max, w_max=w_max, ratio=ratio, maxn=maxn, maxm=maxm,
              kind=kind)


# Batch quantum: batches pad up a geometric ladder (quantum, 2*quantum, ...)
# so a run sees a handful of launch shapes; padding rows carry la=lb=1.
BATCH_QUANTUM = 64


def ladder_size(B: int, quantum: int = BATCH_QUANTUM) -> int:
    """Smallest quantum * 2^k >= B (>= quantum)."""
    n = -(-max(B, 1) // quantum)  # ceil units
    return quantum * (1 << (n - 1).bit_length())


def pad_batch(arrs_2d, la, lb, quantum: int = BATCH_QUANTUM, ladder: bool = True):
    """Pad the leading batch dim of (a, b) + length vectors to a ladder step
    (or plain multiple when ladder=False). Pad rows get la=lb=1 (cheap,
    rejected, sliced off by the caller)."""
    B0 = len(la)
    target = ladder_size(B0, quantum) if ladder else B0 + ((-B0) % quantum)
    pad = target - B0
    if pad == 0:
        return arrs_2d, la, lb, B0
    arrs_2d = [np.pad(x, ((0, pad), (0, 0))) for x in arrs_2d]
    la = np.pad(la, (0, pad), constant_values=1)
    lb = np.pad(lb, (0, pad), constant_values=1)
    return arrs_2d, la, lb, B0


def size_bucket(lb: int, ratio: float, buckets=(256, 512, 1024, 2048, 4096, 8192, 16384, 20001)):
    """Static (LB, la_max, w_max) bucket for a segment of length lb."""
    for cap in buckets:
        if lb <= cap:
            w = 1 + int(cap * ratio)
            return cap, cap + w + 1, w
    cap = buckets[-1]
    w = 1 + int(cap * ratio)
    return cap, cap + w + 1, w
