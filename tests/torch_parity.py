"""Helpers for the PyTorch port's tests (imports no jax, so the GPU tests
can use it on a machine without JAX)."""

from __future__ import annotations

import numpy as np
import torch

FIELDS = ("accept", "cost", "matlen_a", "matlen_b", "diag_cost", "dp_rows")


def T(x) -> torch.Tensor:
    """numpy -> CPU tensor (a private, writable copy)."""
    return torch.from_numpy(np.array(x))


def batch_tensors(A, las, Bm, lbs, device="cpu"):
    return tuple(T(x).to(device) for x in (A, las, Bm, lbs))


def assert_scores_match(port, ref, *, dp_rows: bool = True) -> int:
    """The screening contract: accept (and dp_rows) on every pair, the
    value fields on every accepted pair. Returns the accepted count."""
    acc = np.asarray(ref.accept).astype(bool)
    np.testing.assert_array_equal(port.accept.cpu().numpy(), acc, "accept")
    for f in ("cost", "matlen_a", "matlen_b", "diag_cost"):
        np.testing.assert_array_equal(
            getattr(port, f).cpu().numpy()[acc], np.asarray(getattr(ref, f))[acc], f
        )
    if dp_rows:
        np.testing.assert_array_equal(
            port.dp_rows.cpu().numpy(), np.asarray(ref.dp_rows), "dp_rows"
        )
    return int(acc.sum())


def overlap_cases(rng, n, *, src_len, seg_lo, seg_hi, err, a_lo, a_hi):
    """(a, b) pairs: b = a noisy copy of a prefix of a random source (rate
    `err` of substitutions, insertions and deletions in thirds), a = a
    prefix of the source of random length in [a_lo, a_hi)."""
    cases = []
    for _ in range(n):
        src = rng.integers(0, 4, src_len).astype(np.uint8)
        seg = src[: int(rng.integers(seg_lo, seg_hi))].copy()
        k = len(seg)
        sub = rng.random(k) < err / 3
        seg[sub] = (seg[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        keep = rng.random(k) >= err / 3
        ins = rng.random(k) < err / 3
        out = []
        for c, kp, it in zip(seg, keep, ins):
            if kp:
                out.append(int(c))
            if it:
                out.append(int(rng.integers(0, 4)))
        cases.append((src[: int(rng.integers(a_lo, a_hi))].copy(), np.array(out, np.uint8)))
    return cases


def random_cases(rng, n, *, a_hi, b_hi):
    """Unrelated random pairs (mostly early-failure rejects)."""
    return [
        (
            rng.integers(0, 4, int(rng.integers(1, a_hi))).astype(np.uint8),
            rng.integers(0, 4, int(rng.integers(1, b_hi))).astype(np.uint8),
        )
        for _ in range(n)
    ]


def pack(cases, LA, LB):
    """(A, la, B, lb): zero-padded code matrices and int32 lengths, with
    each side clipped to its matrix width."""
    n = len(cases)
    A = np.zeros((n, LA), np.uint8)
    Bm = np.zeros((n, LB), np.uint8)
    las = np.zeros(n, np.int32)
    lbs = np.zeros(n, np.int32)
    for i, (a, b) in enumerate(cases):
        a, b = a[:LA], b[:LB]
        A[i, : len(a)] = a
        Bm[i, : len(b)] = b
        las[i] = len(a)
        lbs[i] = len(b)
    return A, las, Bm, lbs
