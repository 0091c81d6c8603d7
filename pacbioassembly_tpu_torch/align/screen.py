"""Screening batch geometry: batch ladders and static size buckets.

Port of pacbioassembly_tpu/align/screen.py's shape helpers. The JAX
module also picks a screening backend by name; the port has no such name.
The tensors' device picks it in align/bitwave.py::batch_score_bitwave:
CUDA tensors go to the kernel (csrc/bitwave.cu), CPU tensors to the plain
row DP (align/scan.py), and any other device raises.
"""

from __future__ import annotations

import numpy as np

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
