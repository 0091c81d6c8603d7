"""The roofline's count reads the work, not the implementation.

The frozen least-work count (reference/bound.py) gives the same bytes and
operations for a batch of pairs whether K1's wrapper, the row-DP kernel's
wrapper (both their plain paths on the CPU) or the reference's row DP
scored them.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import bound, rowdp


def pairs(B=48, LA=700, LB=520, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, (B, LA)).astype(np.uint8)
    b = a[:, :LB].copy()
    for q in range(B):
        if q % 3 == 0:
            b[q] = rng.integers(0, 4, LB)        # random pair: fails early
        else:
            flip = rng.random(LB) < 0.02 * (q % 5)
            b[q, flip] = (b[q, flip] + 1) % 4
    la = rng.integers(300, LA + 1, B).astype(np.int32)
    lb = rng.integers(200, LB + 1, B).astype(np.int32)
    return [torch.from_numpy(x) for x in (a, la, b, lb)]


def test_same_count_whatever_scored_the_pairs():
    from pacbioassembly_tpu_torch.align import bitwave, wavefront

    a, la, b, lb = pairs()
    kw = dict(la_max=700, w_max=1 + int(700 * 0.3), ratio=0.3)
    counts = []
    for scored in (bitwave.batch_score_bitwave(a, la, b, lb, **kw, kind="fullscreen"),
                   wavefront.batch_score_rowdp(a, la, b, lb, **kw, kind="fullscreen"),
                   rowdp.score(a, la, b, lb, **kw)):
        counts.append(bound.screen_work(la, lb, a.shape, b.shape, scored.dp_rows, **kw))
    assert counts[0] == counts[1] == counts[2]
    nbytes, ops = counts[0]
    assert nbytes == a.numel() + b.numel() + 32 * len(la)
    assert ops > 0


def test_least_time_is_the_larger_bound():
    assert bound.least_seconds(3.35e12, 0) == 1.0
    assert bound.least_seconds(0, bound.INT32_OPS_PER_S) == 1.0
