"""Port on the card: each CUDA kernel (csrc/) against its plain PyTorch
version on the same CUDA tensors, bit for bit, and the engine on `cuda`
against the engine on `cpu`. Marked `gpu`; skips without CUDA. Imports
no jax, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import io
import os
import tempfile

import numpy as np
import pytest
import torch

from pacbioassembly_tpu_torch import _build
from pacbioassembly_tpu_torch.align.bitwave import batch_score_bitwave
from pacbioassembly_tpu_torch.align.scan import batch_score
from pacbioassembly_tpu_torch.align.screen import size_bucket
from pacbioassembly_tpu_torch.align.tbwave import (
    batch_parents,
    batch_parents_plain,
    walk_parents,
    walk_parents_plain,
)
from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler
from pacbioassembly_tpu_torch.consensus.elect import elect_packed
from pacbioassembly_tpu_torch.host import (
    AssemblyConfig,
    ReadStore,
    SimConfig,
    binary_io,
    dna,
    simulate,
)

from torch_parity import batch_tensors, overlap_cases, pack, random_cases

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _cases(seed, LB, ratio, n=48):
    rng = np.random.default_rng(seed)
    hi = max(LB, 64)
    cases = overlap_cases(rng, n // 3, src_len=2 * hi, seg_lo=hi // 2, seg_hi=hi, err=0.03,
                          a_lo=hi // 4, a_hi=2 * hi)
    cases += overlap_cases(rng, n // 3, src_len=2 * hi, seg_lo=hi // 2, seg_hi=hi, err=0.15,
                           a_lo=hi // 4, a_hi=2 * hi)
    cases += random_cases(rng, n - 2 * (n // 3), a_hi=2 * hi, b_hi=hi)
    LB_, LA, W = size_bucket(LB, ratio)
    return pack(cases, LA, LB_), LA, LB_, W


@pytest.mark.parametrize(
    "LB, ratio",
    [(128, 0.45), (256, 0.3), (1024, 0.3), (1024, 0.15), (4096, 0.3), (8192, 0.3)],
)
def test_bitwave_kernel_equals_plain(cuda, LB, ratio):
    (A, las, Bm, lbs), LA, LB, W = _cases(LB, LB, ratio)
    args = batch_tensors(A, las, Bm, lbs, device=cuda)
    before = _build.LAUNCHES["bitwave_fullscreen"]
    k = batch_score_bitwave(*args, la_max=LA, w_max=W, ratio=ratio)
    p = batch_score(*args, la_max=LA, w_max=W, ratio=ratio)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bitwave_fullscreen"] == before + 1
    for f in range(6):
        assert torch.equal(k[f].to(torch.int32), p[f].to(torch.int32)), f
    assert 0 < int(p.accept.sum()) < len(las)


@pytest.mark.parametrize(
    "LB, rows_max, E",
    [(256, None, None), (1024, None, None), (1024, 512, 200), (4096, None, None)],
)
def test_parent_and_walk_kernels_equal_plain(cuda, LB, rows_max, E):
    (A, las, Bm, lbs), LA, LB, W = _cases(LB + 1, LB, 0.3, n=32)
    args = batch_tensors(A, las, Bm, lbs, device=cuda)
    pk, mdk, lbk = batch_parents(*args, la_max=LA, w_max=W, ratio=0.3, rows_max=rows_max)
    pp, mdp, lbp = batch_parents_plain(*args, la_max=LA, w_max=W, ratio=0.3, rows_max=rows_max)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp) and torch.equal(mdk, mdp) and torch.equal(lbk, lbp)
    sc = batch_score(*args, la_max=LA, w_max=W, ratio=0.3)
    E = E or pk.shape[1] * 16 + W + 2 + 32
    goal = (sc.matlen_a, sc.matlen_b, sc.accept)
    wk = walk_parents(pk, args[2], lbk, mdk, *goal, w_max=W, e_max=E)
    wp = walk_parents_plain(pp, args[2], lbp, mdp, *goal, w_max=W, e_max=E)
    torch.cuda.synchronize()
    for x, y in zip(wk, wp):
        assert torch.equal(x, y)
    assert int(sc.accept.sum()) > 0


def test_elect_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(4)
    N, E, L = 16, 40, 300
    ops = rng.choice([1, 1, 1, 2, 3], size=(N, E)).astype(np.uint8)
    ops[:, 0] = 1
    vals = rng.integers(0, 4, (N, E)).astype(np.uint8)
    start = rng.integers(60, 240, N).astype(np.int32)
    fwd = rng.integers(0, 2, N).astype(bool)
    en = np.ones(N, bool)
    ts = [torch.from_numpy(x) for x in (ops, vals, start, fwd, en)]
    cpu = elect_packed(*ts, L)
    gpu = elect_packed(*(t.to(cuda) for t in ts), L)
    assert torch.equal(gpu.cpu(), cpu)


def test_engine_on_card_equals_cpu(cuda):
    _, reads, _ = simulate(SimConfig(genome_len=8000, coverage=10.0, mean_read_len=800,
                                     min_read_len=600, max_read_len=1000, seed=5,
                                     sub_rate=0.03, ins_rate=0.03, del_rate=0.03))
    path = os.path.join(tempfile.mkdtemp(), "r.bin")
    with open(path, "wb") as fh:
        binary_io.write_records(fh, reads)
    cfg = AssemblyConfig(engine="batch", rng_seed=3, pattern_schedule="roundrobin",
                         max_round=4, prefilter_min_batch=1)
    pats = [dna.parse_pattern("1111111111111111")]
    runs = {}
    for dev in ("cuda", "cpu"):
        _build.reset_counts()
        asm = BatchAssembler(cfg, ReadStore.from_file(path, cfg), pats, device=dev)
        out = io.StringIO()
        asm.run(out=out)
        runs[dev] = (asm, out.getvalue(), dict(_build.LAUNCHES))
    g, c = runs["cuda"], runs["cpu"]
    assert g[1] == c[1] and g[0].history == c[0].history and g[0].surviving == c[0].surviving
    assert all(g[2][k] > 0 for k in _build.KERNELS)
    assert all(g[2][k] == 0 for k in _build.PLAIN)
    assert all(c[2][k] == 0 for k in _build.KERNELS)
