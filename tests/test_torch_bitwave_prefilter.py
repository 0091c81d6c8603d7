"""Port: the screening prefilter geometry (LB=128, W=58, LA=187, R=0.45,
assemble/batch.py::_prefilter) on CPU tensors against the JAX
bit-parallel Pallas kernel in interpret mode. Integer fields, no
tolerance."""

import numpy as np
import torch

from pacbioassembly_tpu.align.bitwave import batch_score_bitpallas
from pacbioassembly_tpu_torch.align.bitwave import batch_score_bitwave

from test_scan import pack
from torch_parity import assert_scores_match, batch_tensors, overlap_cases, random_cases

torch.set_num_threads(1)


def test_prefilter_geometry():
    """The prefilter launch: LB=128 (segments truncated to 128 bases),
    W=58, LA=187 at R=0.45 — true overlaps at 3% and 15% error, random
    collisions."""
    rng = np.random.default_rng(12)
    LB, ratio = 128, 0.45
    W = 1 + int(LB * ratio)
    LA = LB + W + 1
    cases = overlap_cases(rng, 12, src_len=400, seg_lo=128, seg_hi=300, err=0.03, a_lo=60, a_hi=400)
    cases += overlap_cases(rng, 12, src_len=400, seg_lo=128, seg_hi=300, err=0.15, a_lo=60, a_hi=400)
    cases += random_cases(rng, 16, a_hi=400, b_hi=300)
    cases = [(a[:LA], b[:LB]) for a, b in cases]
    A, las, Bm, lbs = pack(cases, LA, LB)
    ref = batch_score_bitpallas(
        A, las, Bm, lbs, la_max=LA, w_max=W, ratio=ratio, interpret=True
    )
    port = batch_score_bitwave(
        *batch_tensors(A, las, Bm, lbs), la_max=LA, w_max=W, ratio=ratio, kind="prefilter"
    )
    n_acc = assert_scores_match(port, ref, dp_rows=False)
    assert 8 <= n_acc < len(cases)
    # the launch kind names only the kernel's counter: same scores
    full = batch_score_bitwave(
        *batch_tensors(A, las, Bm, lbs), la_max=LA, w_max=W, ratio=ratio, kind="fullscreen"
    )
    for x, y in zip(full, port):
        assert torch.equal(x, y)
