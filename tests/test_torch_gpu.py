"""Port on the card: each CUDA kernel (csrc/) against its plain PyTorch
version on the same CUDA tensors, bit for bit, and the engine, multi-contig
assembly, read accounting and `assemble --contigs` on `cuda` against the
same on `cpu`; the engine on a 2-shard mesh on the card against its
single-device round, the two-process collectives, the traceback, the
word-array screen and the device twins; the multi-device dry run's mesh
paths (retreat, multi-contig, checkpoint) on a 2-shard mesh of the card and
the engine's `-l`, `-d` and device_traceback=False branches against the
cpu. Marked `gpu`; skips without CUDA. Imports
no jax, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import dataclasses
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
from pacbioassembly_tpu_torch.align.wavefront import batch_score_rowdp
from pacbioassembly_tpu_torch.assemble import ReadStore
from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler, assemble_contigs
from pacbioassembly_tpu_torch.codec import binary_io, dna
from pacbioassembly_tpu_torch.config import AssemblyConfig
from pacbioassembly_tpu_torch.consensus.elect import elect_packed
from pacbioassembly_tpu_torch.tools import cli
from pacbioassembly_tpu_torch.tools.locate import map_reads
from pacbioassembly_tpu_torch.tools.postprocess import classify_reads
from pacbioassembly_tpu_torch.tools.simulate import SimConfig, simulate

from torch_contigs import CONFIG, SEEDS, write_two_segments

from torch_parity import (
    WALK_W,
    batch_tensors,
    k1_thread_edge_cases,
    overlap_cases,
    pack,
    random_cases,
    walk_batch,
    walk_edge_cases,
    zero_band_tables,
)

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
    "LB, ratio",
    [(128, 0.45), (256, 0.3), (1024, 0.3), (1024, 0.15), (4096, 0.3), (8192, 0.3)],
)
def test_rowdp_kernel_equals_plain_and_bitwave(cuda, LB, ratio):
    (A, las, Bm, lbs), LA, LB, W = _cases(LB + 2, LB, ratio)
    args = batch_tensors(A, las, Bm, lbs, device=cuda)
    before = _build.LAUNCHES["rowdp_fullscreen"]
    k = batch_score_rowdp(*args, la_max=LA, w_max=W, ratio=ratio)
    p = batch_score(*args, la_max=LA, w_max=W, ratio=ratio)
    k1 = batch_score_bitwave(*args, la_max=LA, w_max=W, ratio=ratio)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["rowdp_fullscreen"] == before + 1
    for f in range(6):
        assert torch.equal(k[f].to(torch.int32), p[f].to(torch.int32)), f
        assert torch.equal(k[f].to(torch.int32), k1[f].to(torch.int32)), f
    assert 0 < int(p.accept.sum()) < len(las)


def test_locate_on_card_equals_cpu(cuda):
    """The locator's geometry (roles flipped, R=0.15, b as wide as
    cap + w + 1) through both screening kernels, against the CPU."""
    genome, reads, _ = simulate(SimConfig(genome_len=20_000, coverage=3.0, mean_read_len=900,
                                          min_read_len=600, max_read_len=1800, seed=6,
                                          sub_rate=0.01, ins_rate=0.01, del_rate=0.01))
    pattern = dna.parse_pattern("1111111111111111")
    want = map_reads(genome, pattern, reads, 0.15, device="cpu")
    for kernel in ("bitwave", "rowdp"):
        before = _build.LAUNCHES[f"{kernel}_locate"]
        got = map_reads(genome, pattern, reads, 0.15, device=cuda, screen_kernel=kernel)
        assert got == want
        assert _build.LAUNCHES[f"{kernel}_locate"] > before
    assert len(want[0]) > len(reads) // 2


def test_screening_kernels_at_the_locators_widest_band(cuda):
    """The locator's last bucket (cap 40,000, R=0.15: W=6,001): K1 at 188
    words per stripe and K3 at 144 KB of shared memory, against the plain
    row DP, on a long overlap, a transposed pair and an unrelated pair."""
    from pacbioassembly_tpu_torch.tools.locate import MAXM, MAXN

    rng = np.random.default_rng(11)
    cap, ratio = 40_000, 0.15
    W = 1 + int(cap * ratio)
    src = rng.integers(0, 4, 30_000).astype(np.uint8)
    seg = src[:21_000].copy()
    flip = rng.random(len(seg)) < 0.02
    seg[flip] = (seg[flip] + 1) % 4
    cases = [
        (seg, src),                                    # read segment onto a longer contig suffix
        (seg, src[:20_500]),                           # contig suffix shorter than the segment
        (rng.integers(0, 4, 20_200).astype(np.uint8), src),  # unrelated: fails early
    ]
    A, las, Bm, lbs = pack(cases, cap, cap + W + 1)
    args = batch_tensors(A, las, Bm, lbs, device=cuda)
    kw = dict(la_max=cap, w_max=W, ratio=ratio, maxn=MAXN, maxm=MAXM)
    k1 = batch_score_bitwave(*args, kind="locate", **kw)
    k3 = batch_score_rowdp(*args, kind="locate", **kw)
    p = batch_score(*args, **kw)
    from pacbioassembly_tpu_torch.align.wavefront import launch_shape

    assert launch_shape(W) == ("block", 16)  # K3's widest build: 768 threads of 16 lanes
    torch.cuda.synchronize()
    for f in range(6):
        assert torch.equal(k1[f].to(torch.int32), p[f].to(torch.int32)), f
        assert torch.equal(k3[f].to(torch.int32), p[f].to(torch.int32)), f
    assert p.accept.tolist() == [True, True, False]


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


def _md_of(n, ratio=0.3):
    return 1 + int(np.floor(n * ratio))


def _length_for_md(md, ratio=0.3):
    """The shortest length whose band half-width is md."""
    n = int((md - 1) / ratio)
    while _md_of(n, ratio) < md:
        n += 1
    return n


@pytest.mark.parametrize("B", [1, 33])
def test_parent_kernel_edges_equal_plain(cuda, B):
    """K2 at its edges, every lanes-per-thread shape against the plain
    plane: a pair whose md is the launch's W, len_b < md (an empty b),
    len_a past rows_max, all-padding pairs (length 0), the engine's pad
    rows (la = lb = 1); B=1 and B=33 pairs a launch."""
    from pacbioassembly_tpu_torch.align.tbwave import _launch_parents

    rng = np.random.default_rng(B)
    W = 150
    n = _length_for_md(W)
    src = rng.integers(0, 4, n + 400).astype(np.uint8)
    seg = src[:n].copy()
    sub = rng.random(n) < 0.05
    seg[sub] = (seg[sub] + 1) % 4
    edges = [
        (src[: n + 40], seg),                        # md = W, swapped (len_a > len_b)
        (src[:n], src[: n + 30]),                    # md = W, len_b > len_a
        (src[:200], np.zeros(0, np.uint8)),          # len_b = 0 < md = 1
        (np.zeros(0, np.uint8), np.zeros(0, np.uint8)),
        (src[:1], src[:1]),
    ]
    cases = (edges * B)[:B] if B < len(edges) else edges + overlap_cases(
        rng, B - len(edges), src_len=n + 100, seg_lo=50, seg_hi=n, err=0.1, a_lo=20, a_hi=n + 60)
    LA, LB = n + 60, n + 40
    A, las, Bm, lbs = pack(cases, LA, LB)
    args = batch_tensors(A, las, Bm, lbs, device=cuda)
    for rows_max in (None, 256):  # 256 < len_a: rows cut at the plane
        kw = dict(la_max=LA, w_max=W, ratio=0.3, rows_max=rows_max)
        want = batch_parents_plain(*args, **kw)
        before = _build.LAUNCHES["tbwave"]
        got = [batch_parents(*args, **kw)]
        got += [_launch_parents(*args, lanes=lanes, **kw) for lanes in (4, 8, 16)]
        torch.cuda.synchronize()
        assert _build.LAUNCHES["tbwave"] == before + 4
        assert B == 1 or int(want[1].max()) == W
        for g in got:
            assert all(torch.equal(x, y) for x, y in zip(g, want))
        assert bool((want[0] != 0).any())


def _k1_width_cases(rng, nw):
    """Pairs for a launch of exactly nw words per stripe (w_max = 32 nw - 1,
    capped by maxm - 1): two at the launch's widest band (one swapped), an
    unrelated pair that fails early, a far row with two equal minima, n = 1."""
    from pacbioassembly_tpu_torch.config import Constants

    w_max = min(32 * nw - 1, Constants.ALIGNER_MAXM - 1)
    n = _length_for_md(w_max)
    src = rng.integers(0, 4, n + 200).astype(np.uint8)
    seg = src[:n].copy()
    sub = rng.random(n) < 0.02
    seg[sub] = (seg[sub] + 1) % 4
    x = rng.integers(0, 4, 120).astype(np.uint8)
    cases = [
        (src[: n + 60], seg),                                   # swapped: len_a > len_b
        (seg, src[: n + 60]),                                   # not swapped
        (rng.integers(0, 4, 400).astype(np.uint8), rng.integers(0, 4, 400).astype(np.uint8)),
        (np.append(x, 1).astype(np.uint8), np.append(x, [2, 1]).astype(np.uint8)),  # D(n, n) = D(n, n+1)
        (x[:1], x[:3]),                                         # n = 1
    ]
    return cases, w_max, n + 60, n + 60


@pytest.mark.parametrize("nw", [2, 3, 32, 33, 64, 65, 96, 97, 188])
def test_bitwave_paths_at_each_words_per_lane_edge(cuda, nw):
    """K1's warp path (and its thread path at 2 words, the one width it is
    built for), and the wrapper's own choice, against the plain row DP at
    stripe widths on each side of every words-per-lane step of the warp
    path (1..6 words a lane)."""
    from pacbioassembly_tpu_torch.align import bitwave

    rng = np.random.default_rng(nw)
    cases, W, LA, LB = _k1_width_cases(rng, nw)
    A, las, Bm, lbs = pack(cases, LA, LB)
    args = batch_tensors(A, las, Bm, lbs, device=cuda)
    kw = dict(la_max=LA, w_max=W, ratio=0.3)
    assert bitwave.stripe_words(W, bitwave.Constants.ALIGNER_MAXM) == nw
    p = batch_score(*args, **kw)
    lim = dict(maxn=bitwave.Constants.ALIGNER_MAXN, maxm=bitwave.Constants.ALIGNER_MAXM)
    paths = ("thread", "warp") if nw < bitwave.WARP_MIN_WORDS else ("warp",)
    runs = [batch_score_bitwave(*args, **kw)] + [
        bitwave._launch(*args, kind="fullscreen", path=path, **kw, **lim) for path in paths
    ]
    torch.cuda.synchronize()
    for k in runs:
        for f in range(6):
            assert torch.equal(k[f].to(torch.int32), p[f].to(torch.int32)), f
    assert p.accept.tolist()[:4] == [True, True, False, True]
    assert int(p.diag_cost[0]) == -1 and int(p.diag_cost[1]) >= 0  # swapped, then not
    assert int(p.dp_rows[2]) <= 20                                  # failed early
    assert int(p.matlen_b[3]) == len(cases[3][0])                    # the first of two minima


def test_bitwave_warp_path_with_the_peq_in_global_memory(cuda):
    """Rows wider than a warp's shared PEQ can hold (4 x PW words, PW from
    the widest row): the warp path builds it in the global scratch."""
    from pacbioassembly_tpu_torch.align import bitwave

    (A, las, Bm, lbs), LA, _, W = _cases(1024, 1024, 0.3, n=12)
    LB = 470_000  # 32 * PW bytes > SMEM_LIMIT
    assert 32 * ((LB + 63) // 64 + 1) > bitwave.SMEM_LIMIT
    wide = np.zeros((len(las), LB), np.uint8)
    wide[:, : Bm.shape[1]] = Bm
    args = batch_tensors(A, las, wide, lbs, device=cuda)
    kw = dict(la_max=LA, w_max=W, ratio=0.3)
    assert bitwave.stripe_words(W, bitwave.Constants.ALIGNER_MAXM) >= bitwave.WARP_MIN_WORDS
    k = batch_score_bitwave(*args, **kw)
    p = batch_score(*args, **kw)
    torch.cuda.synchronize()
    for f in range(6):
        assert torch.equal(k[f].to(torch.int32), p[f].to(torch.int32)), f
    assert 0 < int(p.accept.sum()) < len(las)


def test_bitwave_fails_at_row_eleven(cuda):
    """Pairs whose first failure is at row 11, the first row that can fail,
    through both paths."""
    from pacbioassembly_tpu_torch.align import bitwave

    rng = np.random.default_rng(7)
    cases = [(rng.integers(0, 4, 200).astype(np.uint8), rng.integers(0, 4, 200).astype(np.uint8))
             for _ in range(64)]
    A, las, Bm, lbs = pack(cases, 200, 200)
    args = batch_tensors(A, las, Bm, lbs, device=cuda)
    for W in (63, 250):  # md 61: 2 words (thread path) and 8 words (warp path)
        kw = dict(la_max=200, w_max=W, ratio=0.3)
        p = batch_score(*args, **kw)
        k = batch_score_bitwave(*args, **kw)
        torch.cuda.synchronize()
        for f in range(6):
            assert torch.equal(k[f].to(torch.int32), p[f].to(torch.int32)), f
        assert (p.dp_rows == 11).any() and not p.accept.any()


def _thread_and_auto(args, kw, **launch):
    """K1's thread path (forced) and the wrapper's own choice, prefilter kind."""
    from pacbioassembly_tpu_torch.align import bitwave

    lim = dict(maxn=bitwave.Constants.ALIGNER_MAXN, maxm=bitwave.Constants.ALIGNER_MAXM)
    return [bitwave._launch(*args, kind="prefilter", path="thread", **kw, **lim, **launch),
            batch_score_bitwave(*args, kind="prefilter", **kw)]


@pytest.mark.parametrize("name", sorted(k1_thread_edge_cases()))
def test_bitwave_thread_path_edges_equal_plain(cuda, name, monkeypatch):
    """The thread path on tests/torch_parity.py's edge batches: md 0, 1
    and 63, swapped pairs, failure at row 11, m - n = md, reads past a
    row's width."""
    from pacbioassembly_tpu_torch.align import bitwave, scan

    A, las, Bm, lbs, kw, zero_band = k1_thread_edge_cases()[name]
    if zero_band:
        fake = zero_band_tables(scan.threshold_tensors)
        monkeypatch.setattr(scan, "threshold_tensors", fake)
        monkeypatch.setattr(bitwave, "threshold_tensors", fake)
    args = batch_tensors(A, las, Bm, lbs, device=cuda)
    p = batch_score(*args, **kw)
    before = _build.LAUNCHES["bitwave_prefilter"]
    runs = _thread_and_auto(args, kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bitwave_prefilter"] == before + 2
    for k in runs:
        for f in range(6):
            assert torch.equal(k[f].to(torch.int32), p[f].to(torch.int32)), f


@pytest.mark.parametrize("B", [1, 33, 4097])
@pytest.mark.parametrize("LB", [128, 50])  # LA = LB + W + 1: 187 and 74, not multiples of 16
def test_bitwave_thread_path_ragged_batches_equal_plain(cuda, B, LB):
    """Batches that end inside a block, rows whose spans start off a
    16-byte boundary (and a batch whose first row does: a view one row
    in), at 16, 32 and 64 pairs a block."""
    rng = np.random.default_rng(B + LB)
    ratio = 0.45
    W = 1 + int(LB * ratio)
    LA = LB + W + 1
    n = B + 1
    cases = overlap_cases(rng, n // 2, src_len=2 * LA, seg_lo=LB // 2, seg_hi=LB + 40, err=0.05,
                          a_lo=LB // 3, a_hi=LA + 30)
    cases += random_cases(rng, n - n // 2, a_hi=LA + 30, b_hi=LB + 30)
    A, las, Bm, lbs = pack([cases[i] for i in rng.permutation(n)], LA, LB)
    full = batch_tensors(A, las, Bm, lbs, device=cuda)
    kw = dict(la_max=LA, w_max=W, ratio=ratio)
    for args in (tuple(t[:B] for t in full), tuple(t[1:] for t in full)):
        p = batch_score(*args, **kw)
        runs = _thread_and_auto(args, kw)
        runs += [_thread_and_auto(args, kw, pairs=pairs)[0] for pairs in (16, 64)]
        torch.cuda.synchronize()
        for k in runs:
            for f in range(6):
                assert torch.equal(k[f].to(torch.int32), p[f].to(torch.int32)), f
    if B > 1:
        assert 0 < int(p.accept.sum()) < B


def test_bitwave_rows_too_wide_to_stage_take_the_warp_path(cuda):
    """Two-word stripes whose block of rows does not fit in shared memory:
    the thread path refuses them and the wrapper sends them to the warp
    path, equal to the plain row DP."""
    from pacbioassembly_tpu_torch.align import bitwave

    rng = np.random.default_rng(3)
    LA = LB = 4000
    cases = overlap_cases(rng, 6, src_len=2 * LA, seg_lo=100, seg_hi=500, err=0.01,
                          a_lo=100, a_hi=1000)
    cases += random_cases(rng, 4, a_hi=1000, b_hi=900)
    A, las, Bm, lbs = pack(cases, LA, LB)
    args = batch_tensors(A, las, Bm, lbs, device=cuda)
    kw = dict(la_max=LA, w_max=58, ratio=0.1)
    lim = dict(maxn=bitwave.Constants.ALIGNER_MAXN, maxm=bitwave.Constants.ALIGNER_MAXM)
    assert bitwave.stripe_words(58, lim["maxm"]) == 2
    with pytest.raises(ValueError, match="no K1 'thread' path"):
        bitwave._launch(*args, kind="fullscreen", path="thread", **kw, **lim)
    k = batch_score_bitwave(*args, **kw)
    p = batch_score(*args, **kw)
    torch.cuda.synchronize()
    for f in range(6):
        assert torch.equal(k[f].to(torch.int32), p[f].to(torch.int32)), f
    assert 0 < int(p.accept.sum()) < len(las)


def test_bitwave_thread_path_takes_no_peq_scratch(cuda, monkeypatch):
    """A thread-path launch allocates only its output, and pb_bitwave
    refuses a PEQ scratch pointer on path 1 (the thread path)."""
    from pacbioassembly_tpu_torch.align import bitwave

    A, las, Bm, lbs, kw, _ = k1_thread_edge_cases()["swap"]
    args = batch_tensors(A, las, Bm, lbs, device=cuda)
    B = len(las)
    bitwave._launch(*args, kind="prefilter", path="thread", **kw,
                    maxn=bitwave.Constants.ALIGNER_MAXN, maxm=bitwave.Constants.ALIGNER_MAXM)
    shapes = []
    real_empty = torch.empty

    def spy(*size, **k):
        shapes.append(tuple(size[0]) if len(size) == 1 else size)
        return real_empty(*size, **k)

    monkeypatch.setattr(torch, "empty", spy)
    k = batch_score_bitwave(*args, kind="prefilter", **kw)
    monkeypatch.undo()
    assert shapes == [(6, B)]

    a, la, b, lb, tab_len, et, am, bt = bitwave.screen_inputs(*args, kw["la_max"], kw["ratio"])
    LA, LB = a.shape[1], b.shape[1]
    PW = (max(LA, LB) + 63) // 64 + 1
    scratch = torch.zeros((B, 4, PW), dtype=torch.int64, device=cuda)
    out = torch.full((6, B), -7, dtype=torch.int32, device=cuda)
    lib = _build.library()

    def launch(peq):
        with _build.launching(a) as stream:
            return lib.pb_bitwave(
                a.data_ptr(), LA, b.data_ptr(), LB, la.data_ptr(), lb.data_ptr(), B,
                et.data_ptr(), am.data_ptr(), bt.data_ptr(), tab_len, kw["la_max"], kw["w_max"],
                bitwave.Constants.ALIGNER_MAXN, bitwave.Constants.ALIGNER_MAXM, peq, PW, 1,
                bitwave.THREAD_PAIRS, out.data_ptr(), stream)

    assert launch(scratch.data_ptr()) == 1  # cudaErrorInvalidValue, nothing launched
    torch.cuda.synchronize()
    assert (out == -7).all()
    assert launch(None) == 0
    torch.cuda.synchronize()
    for f in range(6):
        assert torch.equal(out[f], k[f].to(torch.int32)), f


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


@pytest.mark.parametrize("screen_kernel", ["bitwave", "rowdp"])
def test_engine_on_card_equals_cpu(cuda, screen_kernel):
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
        asm = BatchAssembler(cfg, ReadStore.from_file(path, cfg), pats, device=dev,
                             screen_kernel=screen_kernel)
        out = io.StringIO()
        asm.run(out=out)
        runs[dev] = (asm, out.getvalue(), dict(_build.LAUNCHES))
    g, c = runs["cuda"], runs["cpu"]
    assert g[1] == c[1] and g[0].history == c[0].history and g[0].surviving == c[0].surviving
    used = {f"{screen_kernel}_prefilter", f"{screen_kernel}_fullscreen", "tbwave", "walk"}
    assert {k for k in _build.KERNELS if g[2][k] > 0} == used
    assert all(g[2][k] == 0 for k in _build.PLAIN)
    assert all(c[2][k] == 0 for k in _build.KERNELS)


def test_expansion_on_card_equals_cpu_round_for_round(cuda, monkeypatch):
    """Six engine rounds: the card's candidate expansion (expand_device 1)
    gives the CPU engine's candidates and dropped count, round for round."""
    from pacbioassembly_tpu_torch.assemble import batch

    _, reads, _ = simulate(SimConfig(genome_len=8000, coverage=10.0, mean_read_len=800,
                                     min_read_len=600, max_read_len=1000, seed=5,
                                     sub_rate=0.03, ins_rate=0.03, del_rate=0.03))
    path = os.path.join(tempfile.mkdtemp(), "r.bin")
    with open(path, "wb") as fh:
        binary_io.write_records(fh, reads)
    cfg = AssemblyConfig(engine="batch", rng_seed=3, pattern_schedule="roundrobin",
                         max_round=6, prefilter_min_batch=1)
    pats = dna.load_patterns(SEEDS)
    real = batch.expand_candidates
    rounds = {}

    def kept(*a, **k):
        out = real(*a, **k)
        c, dropped, phase = out
        got.append(([getattr(c, f).copy() for f in ("read", "j", "forward", "r_offset", "rank")],
                     dropped, phase["expand_device"]))
        return out

    monkeypatch.setattr(batch, "expand_candidates", kept)
    for dev in ("cuda", "cpu"):
        got = rounds[dev] = []
        asm = BatchAssembler(cfg, ReadStore.from_file(path, cfg), pats, device=dev)
        asm.run()
    g, c = rounds["cuda"], rounds["cpu"]
    assert len(g) == len(c) == 6
    assert sum(len(fields[0]) for fields, _, _ in c) > 0
    for k, ((gf, gd, ge), (cf, cd, ce)) in enumerate(zip(g, c)):
        assert (ge, ce) == (1, 0), k
        assert gd == cd, k
        for a, b in zip(gf, cf):
            assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_restarts_share_one_device_copy_of_the_trial_seeds(cuda, monkeypatch, tmp_path):
    """assemble_contigs on the card: every engine after the first reuses
    the trial-seed cache's device copy; it is uploaded once."""
    from pacbioassembly_tpu_torch.assemble import batch

    uploads = []
    real = batch.TrialSeedCache._upload

    def upload(self, device):
        uploads.append(device)
        return real(self, device)

    monkeypatch.setattr(batch.TrialSeedCache, "_upload", upload)
    store = write_two_segments(tmp_path)
    cfg = AssemblyConfig(**CONFIG)
    contigs, _ = assemble_contigs(cfg, ReadStore.from_file(store, cfg),
                                  dna.load_patterns(SEEDS), 3, device="cuda")
    assert len(contigs) >= 2
    assert uploads == [torch.device("cuda", 0)]


@pytest.mark.parametrize("dedupe", [False, True])
def test_assemble_contigs_on_card_equals_cpu(cuda, dedupe, tmp_path):
    """The two-segment store of tests/test_batch.py::test_multi_contig_assembly,
    4 contigs: equal ContigResults and surviving reads, the card's run
    through the kernels only."""
    store = write_two_segments(tmp_path)
    cfg = AssemblyConfig(**CONFIG)
    pats = dna.load_patterns(SEEDS)
    runs = {}
    for dev in ("cuda", "cpu"):
        _build.reset_counts()
        contigs, surviving = assemble_contigs(cfg, ReadStore.from_file(store, cfg), pats, 4,
                                              dedupe=dedupe, device=dev)
        runs[dev] = ([(c.codes.tolist(), c.nreads, c.nrounds) for c in contigs], surviving,
                     dict(_build.LAUNCHES))
    g, c = runs["cuda"], runs["cpu"]
    assert g[:2] == c[:2]
    assert sum(len(codes) > 6000 for codes, _, _ in g[0]) == 2
    used = {k for k in _build.KERNELS if g[2][k] > 0}
    assert {"bitwave_fullscreen", "tbwave", "walk"} <= used
    assert used <= {"bitwave_prefilter", "bitwave_fullscreen", "tbwave", "walk"}
    assert all(g[2][k] == 0 for k in _build.PLAIN)


def test_classify_reads_on_card_equals_cpu(cuda):
    """Reads of a genome, half of its 60 kb region assembled into a contig
    and some junk, accounted for on the card and on the CPU."""
    genome, reads, _ = simulate(SimConfig(genome_len=80_000, coverage=1.0, mean_read_len=1500,
                                          min_read_len=300, max_read_len=2500, seed=7,
                                          sub_rate=0.02, ins_rate=0.02, del_rate=0.02))
    rng = np.random.default_rng(8)
    reads += [rng.integers(0, 4, 1200).astype(np.uint8) for _ in range(5)]
    contigs = [genome[:60_000].copy(), genome[62_000:70_000].copy()]
    pattern = dna.parse_pattern("1111111111111111")
    want = classify_reads(contigs, reads, pattern, 0.3, device="cpu")
    before = _build.LAUNCHES["bitwave_locate"]
    got = classify_reads(contigs, reads, pattern, 0.3, device=cuda)
    assert _build.LAUNCHES["bitwave_locate"] > before
    assert torch.equal(torch.from_numpy(got.pop("categories")), torch.from_numpy(want.pop("categories")))
    assert got == want
    assert want["mapped"] > 0 and want["unseedable"] >= 5
    assert sum(want[k] for k in ("mapped", "seeded_only", "unseedable", "too_short")) == len(reads)


def test_contigs_cli_on_card_equals_cpu(cuda, tmp_path, capsys):
    store = write_two_segments(tmp_path)
    argv = ["assemble", store, SEEDS, "--engine", "batch", "--schedule", "roundrobin",
            "--rng-seed", "1", "-m", "40", "--contigs", "2", "--device"]
    outs = []
    for dev in ("cuda", "cpu"):
        assert cli.main(argv + [dev]) == 0
        outs.append(capsys.readouterr())
    assert outs[0].out == outs[1].out and outs[0].err == outs[1].err
    assert outs[0].out.count(">contig_") == 2


def _k3_edge_cases(rng, W):
    """Pairs for a K3 launch of band half-width W at R=0.3: md = W swapped
    and not, unrelated pairs (early failures, some at row 11), a far column
    and a final row each with two equal minima, n = 1, an empty side each
    way, and a size-rejected pair (md > W)."""
    n = _length_for_md(W)
    src = rng.integers(0, 4, n + 400).astype(np.uint8)
    seg = src[:n].copy()
    sub = rng.random(n) < 0.03
    seg[sub] = (seg[sub] + 1) % 4
    x = rng.integers(0, 4, 120).astype(np.uint8)
    big = _length_for_md(W + 3)
    return [
        (src[: n + 40], seg),                                           # swapped, md = W
        (seg, src[: n + 60]),                                           # md = W
        (np.append(x, [2, 1]).astype(np.uint8), np.append(x, 1).astype(np.uint8)),  # far-column tie
        (np.append(x, 1).astype(np.uint8), np.append(x, [2, 1]).astype(np.uint8)),  # final-row tie
        (x[:1], x[:1]),
        (x[:5], np.zeros(0, np.uint8)),
        (np.zeros(0, np.uint8), x[:5]),
        (src[:big], src[: big + 10]),                                   # md > W: size-rejected
    ] + [(rng.integers(0, 4, m).astype(np.uint8), rng.integers(0, 4, m).astype(np.uint8))
         for m in [min(200, n)] * 25]


@pytest.mark.parametrize("W", [58, 250])  # the prefilter's band (117 lanes), and 501 lanes
def test_rowdp_shapes_at_their_edges_equal_plain(cuda, W):
    """K3 at every build that holds the band, on both sides of the
    warp/block cutover (W = 58: the warp path's band, where every build
    runs; W = 250: the block path's), and the wrapper's own choice, against
    the plain row DP: B = 1 (each edge pair alone) and B = 33 (all
    together)."""
    from pacbioassembly_tpu_torch.align import wavefront
    from pacbioassembly_tpu_torch.config import Constants

    rng = np.random.default_rng(W)
    cases = _k3_edge_cases(rng, W)
    LA = LB = max(max(len(a), len(b)) for a, b in cases)
    kw = dict(la_max=LA, w_max=W, ratio=0.3)
    lim = dict(maxn=Constants.ALIGNER_MAXN, maxm=Constants.ALIGNER_MAXM)
    shapes = wavefront.shapes(W)
    assert shapes[0] == wavefront.launch_shape(W) == (("warp", 4) if W == 58 else ("block", 8))
    assert shapes == list(wavefront.BUILDS if W == 58 else wavefront.BUILDS[1:])
    for batch in [cases[:33]] + [[c] for c in cases[:8]]:
        args = batch_tensors(*pack(batch, LA, LB), device=cuda)
        p = batch_score(*args, **kw)
        before = _build.LAUNCHES["rowdp_fullscreen"]
        runs = [batch_score_rowdp(*args, **kw)] + [
            wavefront._launch(*args, kind="fullscreen", path=path, lanes=L, **kw, **lim)
            for path, L in shapes
        ]
        torch.cuda.synchronize()
        assert _build.LAUNCHES["rowdp_fullscreen"] == before + 1 + len(shapes)
        for k in runs:
            for f in range(6):
                assert torch.equal(k[f].to(torch.int32), p[f].to(torch.int32)), f
        if len(batch) == 33:
            acc = p.accept.tolist()
            assert acc[:5] == [True, True, True, True, True] and not any(acc[5:8])
            assert int(p.matlen_a[2]) == len(cases[2][1])   # the first of two far-column minima
            assert int(p.matlen_b[3]) == len(cases[3][0])   # the first of two final-row minima
            assert int(p.diag_cost[0]) == -1 and int(p.diag_cost[1]) >= 0
            assert int(p.dp_rows[7]) == 0 and (p.dp_rows[8:] == 11).any()


@pytest.mark.parametrize("name", sorted(walk_edge_cases()))
def test_walk_kernel_on_edge_planes_equals_plain(cuda, name):
    """W on the synthetic edge planes (tests/torch_parity.py): a run longer
    than the tile's half-width each way, rows cut at the plane, k clamped
    to 0 and to S - 1, zero parents, E too small, accept = 0; B = 1."""
    args, E = walk_batch([walk_edge_cases()[name]], device=cuda)
    want = walk_parents_plain(*args, w_max=WALK_W, e_max=E)
    before = _build.LAUNCHES["walk"]
    got = walk_parents(*args, w_max=WALK_W, e_max=E)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["walk"] == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_walk_kernel_on_a_batch_of_edge_planes_equals_plain(cuda):
    """The edge planes with one E, in one launch."""
    cases = [c for c in walk_edge_cases().values() if c[7] == 512]
    args, E = walk_batch(cases, device=cuda)
    want = walk_parents_plain(*args, w_max=WALK_W, e_max=E)
    got = walk_parents(*args, w_max=WALK_W, e_max=E)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert int(want[2].max()) == E


def _two_device_store():
    """chip_smoke.py's cuda == cpu store: 60 kb at 12x, mean read 1,200, 3%
    uniform error, seed 5."""
    from pacbioassembly_tpu_torch.tools.simulate import split_error_rate

    sub, ins, dele = split_error_rate(0.03, "uniform")
    _, reads, _ = simulate(SimConfig(genome_len=60_000, coverage=12.0, mean_read_len=1200,
                                     max_read_len=2000, sub_rate=sub, ins_rate=ins,
                                     del_rate=dele, seed=5))
    path = os.path.join(tempfile.mkdtemp(), "r.bin")
    with open(path, "wb") as fh:
        binary_io.write_records(fh, reads)
    return path


def test_mesh_engine_on_card_equals_single_device(cuda):
    """The engine on a 2-shard mesh on one card (each full screen split
    into two shards, the summed elect) reaches the single-device round's
    RoundStats, contig, votes and surviving reads, through the kernels
    only."""
    from pacbioassembly_tpu_torch.parallel import make_mesh

    path = _two_device_store()
    cfg = AssemblyConfig(engine="batch", rng_seed=7, pattern_schedule="roundrobin",
                         max_round=8, prefilter_min_batch=1)
    pats = dna.load_patterns(SEEDS)
    runs = {}
    for name, mesh in (("single", None), ("mesh", make_mesh(devices=[cuda, cuda]))):
        _build.reset_counts()
        asm = BatchAssembler(cfg, ReadStore.from_file(path, cfg), pats, device=cuda, mesh=mesh)
        kinds = set()
        for _ in range(cfg.max_round):
            asm.run_round()
            kinds |= {e["kind"] for e in asm.launch_log}
        runs[name] = (asm, kinds, dict(_build.LAUNCHES))
    (s, _, _), (m, kinds, counts) = runs["single"], runs["mesh"]
    assert s.mesh.size == 1 and m.mesh.size == 2
    assert np.array_equal(m.ref.text(), s.ref.text()) and m.surviving == s.surviving
    for f in ("sel", "sup", "total"):
        assert np.array_equal(getattr(m.ref, f)[m.ref.beg : m.ref.end],
                              getattr(s.ref, f)[s.ref.beg : s.ref.end]), f
    assert [dataclasses.asdict(x) for x in m.history] == [dataclasses.asdict(x) for x in s.history]
    assert {"pf", "fs", "tbp", "elect"} <= kinds
    assert all(counts[k] > 0 for k in ("bitwave_prefilter", "bitwave_fullscreen", "tbwave", "walk"))
    assert all(counts[k] == 0 for k in _build.PLAIN)


def test_traceback_on_card_equals_cpu(cuda):
    from pacbioassembly_tpu_torch.align.traceback import batch_align_traceback

    (A, las, Bm, lbs), LA, LB, W = _cases(11, 1024, 0.3, n=32)
    kw = dict(la_max=LA, w_max=W, ratio=0.3, rows_max=1536)
    cpu = batch_align_traceback(*batch_tensors(A, las, Bm, lbs), **kw)
    before = dict(_build.LAUNCHES)
    gpu = batch_align_traceback(*batch_tensors(A, las, Bm, lbs, cuda), **kw)
    for f in ("bitwave_fullscreen", "tbwave", "walk"):
        assert _build.LAUNCHES[f] == before[f] + 1, f
    for f in cpu.scores._fields:
        assert torch.equal(getattr(gpu.scores, f).cpu(), getattr(cpu.scores, f)), f
    for f in ("ops", "vals", "nedit"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
    assert int(cpu.scores.accept.sum()) >= 8


def test_bitscan_on_card_equals_k1(cuda):
    from pacbioassembly_tpu_torch.align.bitscan import batch_score_bp

    (A, las, Bm, lbs), LA, LB, W = _cases(12, 256, 0.3)
    x = batch_tensors(A, las, Bm, lbs, cuda)
    got = batch_score_bp(*x, la_max=LA, w_max=W, ratio=0.3)
    want = batch_score_bitwave(*x, la_max=LA, w_max=W, ratio=0.3)
    assert got.accept.device.type == "cuda"
    for f in want._fields:
        assert torch.equal(getattr(got, f).to(torch.int32), getattr(want, f).to(torch.int32)), f
    assert 0 < int(want.accept.sum()) < len(las)


def test_device_twins_on_card_equal_host(cuda):
    from pacbioassembly_tpu_torch.consensus import ConsensusRef
    from pacbioassembly_tpu_torch.consensus.device import evolve_on_device
    from pacbioassembly_tpu_torch.index import build_seedmap
    from pacbioassembly_tpu_torch.index.device import device_build_seedmap, device_lookup

    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, 45_000).astype(np.uint8)
    mask = dna.parse_pattern("111**111*11*1111")
    host, _ = build_seedmap(codes, mask)
    dev = device_build_seedmap(torch.from_numpy(codes).to(cuda), len(codes), mask)
    n = int(dev.n_entries)
    assert n == host.n_entries and dev.keys.device.type == "cuda"
    assert np.array_equal(dev.keys[-n:].cpu().numpy(), host.keys.astype(np.int64))
    assert np.array_equal(dev.positions[-n:].cpu().numpy(), host.positions)
    q = np.concatenate([host.keys[::53], [12345, 0]]).astype(np.int64)
    lo, cnt = device_lookup(dev, torch.from_numpy(q).to(cuda))
    lo_h, cnt_h = host.lookup_batch(q.astype(np.uint32))
    assert np.array_equal(cnt.cpu().numpy(), cnt_h)
    hit = cnt_h > 0
    assert np.array_equal((lo.cpu().numpy() - (len(dev.keys) - n))[hit], lo_h[hit])

    refs = []
    for _ in range(2):
        r = np.random.default_rng(5)
        ref = ConsensusRef(r.integers(0, 4, 3000).astype(np.uint8), capacity=3 * 8192,
                           overlap_min=16)
        k = ref.post - ref.pre
        ref.sel[ref.pre : ref.post] = r.integers(0, 6, (k, 4))
        ref.sup[ref.pre : ref.post] = np.where(r.random((k, 4)) < 0.15, r.integers(1, 6, (k, 4)), 0)
        ref.total[ref.pre : ref.post] = r.integers(1, 8, k)
        ref.mark_dirty(ref.pre, ref.post)
        refs.append(ref)
    refs[0].evolve()
    evolve_on_device(refs[1], device=cuda)
    assert np.array_equal(refs[1].text(), refs[0].text())
    for f in ("sel", "sup", "total"):
        assert np.array_equal(getattr(refs[1], f)[refs[1].pre : refs[1].post],
                              getattr(refs[0], f)[refs[0].pre : refs[0].post]), f


def test_two_process_mesh_on_card_equals_serial(cuda, tmp_path):
    """Two gloo ranks, two shards each on the card: every rank's sharded
    screen and summed elect equal the serial port on the card."""
    from torch_multihost_worker import inputs, run_workers

    r0, r1 = run_workers(tmp_path, device="cuda:0")
    x = inputs()
    ts = [torch.from_numpy(x[k]).to(cuda) for k in ("ops", "vals", "start", "fwd", "en")]
    serial = elect_packed(*ts, x["L"]).cpu().numpy()
    LA = x["a"].shape[1]
    scores = batch_score_bitwave(*batch_tensors(x["a"], x["la"], x["b"], x["lb"], cuda),
                                 la_max=LA, w_max=x["W"], ratio=0.3)
    for r in (r0, r1):
        assert list(r["devices"]) == ["cuda:0"] * 4
        assert np.array_equal(np.concatenate([r["sel"], r["sup"], r["total"][:, None]], 1), serial)
        for f in scores._fields:
            assert np.array_equal(r[f], getattr(scores, f).cpu().numpy()), f


def _engine_state(asm) -> tuple:
    ref = asm.ref
    return ([dataclasses.asdict(s) for s in asm.history], ref.text().tolist(),
            [getattr(ref, f)[ref.beg : ref.end].tolist() for f in ("sel", "sup", "total")],
            list(asm.surviving),
            (asm.nround, asm.nfailure, asm.retreats, asm.fruitless_retreats,
             asm.matches_since_retreat))


def test_stall_retreat_on_card_equals_cpu(cuda, tmp_path):
    """Fixture (a) of tests/torch_retreat.py (the stall store, its retreat
    after round 19): the card's run equals the port's cpu run, round for
    round, retreat and log included, through the kernels only."""
    from torch_retreat import STALL, STALL_ROUNDS, retreat_lines, stall_patterns, stall_records
    from torch_retreat import write_records

    path = write_records(tmp_path, "stall.bin", stall_records())
    cfg = AssemblyConfig(**STALL, max_round=STALL_ROUNDS)
    runs = {}
    for dev in ("cuda", "cpu"):
        _build.reset_counts()
        asm = BatchAssembler(cfg, ReadStore.from_file(path, cfg), stall_patterns(), device=dev)
        log = io.StringIO()
        asm.run(out=io.StringIO(), log=log)
        runs[dev] = (_engine_state(asm), log.getvalue(), dict(_build.LAUNCHES))
    (g, glog, counts), (c, clog, _) = runs["cuda"], runs["cpu"]
    assert g == c and glog == clog
    assert g[4][2] == 1 and len(retreat_lines(glog)) == 1
    assert all(counts[k] > 0 for k in ("bitwave_fullscreen", "tbwave", "walk"))
    assert all(counts[k] == 0 for k in _build.PLAIN)


def test_clr_contigs_on_card_equal_cpu(cuda, tmp_path):
    """tests/torch_clr.py's 15% CLR store with the whole-genome runs' stall
    recovery (RETREAT), 2 contigs run to their ends, the prefilter forced
    on: equal ContigResults, surviving reads and logs (retreat lines
    included) on the card and on the CPU, the card's run through the
    kernels only."""
    from torch_clr import ENGINE, RETREAT, write_clr_store

    store = write_clr_store(tmp_path)
    cfg = AssemblyConfig(**dict(ENGINE, max_round=None, prefilter_min_batch=1, **RETREAT))
    pats = dna.load_patterns(SEEDS)
    runs = {}
    for dev in ("cuda", "cpu"):
        _build.reset_counts()
        log = io.StringIO()
        contigs, surviving = assemble_contigs(cfg, ReadStore.from_file(store, cfg), pats, 2,
                                              log=log, dedupe=False, device=dev)
        runs[dev] = ([(c.codes.tolist(), c.nreads, c.nrounds) for c in contigs], surviving,
                     log.getvalue(), dict(_build.LAUNCHES))
    g, c = runs["cuda"], runs["cpu"]
    assert g[:3] == c[:3]
    assert len(g[0]) == 2 and g[2].count("--- edge retreat") > 2
    assert all(g[3][k] > 0 for k in ("bitwave_prefilter", "bitwave_fullscreen", "tbwave", "walk"))
    assert all(g[3][k] == 0 for k in _build.PLAIN)


def test_engine_on_a_second_card_equals_the_first():
    """3 rounds of the engine with every tensor on cuda:1 while cuda:0 is
    current equal the same rounds on cuda:0: each kernel launches on its
    tensor's card (_build.launching)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (torch.cuda.device_count() >= 2)")
    path = _two_device_store()
    cfg = AssemblyConfig(engine="batch", rng_seed=7, pattern_schedule="roundrobin",
                         max_round=3, prefilter_min_batch=1)
    runs = {}
    with torch.cuda.device(0):
        for dev in ("cuda:0", "cuda:1"):
            _build.reset_counts()
            asm = BatchAssembler(cfg, ReadStore.from_file(path, cfg), dna.load_patterns(SEEDS),
                                 device=dev)
            asm.run(out=io.StringIO())
            runs[dev] = (_engine_state(asm), dict(_build.LAUNCHES))
        assert torch.cuda.current_device() == 0
    (first, _), (second, counts) = runs["cuda:0"], runs["cuda:1"]
    assert second == first and second[4][0] == 3
    assert all(counts[k] > 0 for k in ("bitwave_prefilter", "bitwave_fullscreen", "tbwave", "walk"))
    assert all(counts[k] == 0 for k in _build.PLAIN)


def test_mesh_paths_on_card_equal_cpu(cuda):
    """(a) and (b) of tests/torch_mesh_paths.py: `assemble_contigs(..., 3,
    dedupe=True)` on a 2-shard mesh of the card (its first engine is the
    retreat run) equals the port's one-shard cpu run: ContigResults,
    surviving reads, the log and every engine's RoundStats, contig, votes,
    survivors and retreat counters; the card's run through the kernels
    only, each full screen in two shards."""
    from pacbioassembly_tpu_torch.parallel import make_mesh
    from torch_mesh_paths import contigs_run, records

    data = records()
    _build.reset_counts()
    card = contigs_run(data, make_mesh(devices=[cuda, cuda]), device=cuda)
    counts = dict(_build.LAUNCHES)
    cpu = contigs_run(data, None, device="cpu")
    assert (card["contigs"], card["surviving"], card["log"]) == (
        cpu["contigs"], cpu["surviving"], cpu["log"])
    assert [_engine_state(e) for e in card["engines"]] == [
        _engine_state(e) for e in cpu["engines"]]
    first = card["engines"][0]
    assert (first.nround, first.retreats, first.ref.length()) == (10, 2, 5581)
    assert [len(c[0]) for c in card["contigs"]] == [5581, 5566] and card["surviving"] == []
    fs = sum(e["kind"] == "fs" for rounds in card["launches"].values() for rl in rounds
             for e in rl)
    assert counts["bitwave_fullscreen"] == 2 * fs > 0
    assert all(counts[k] > 0 for k in ("tbwave", "walk"))
    assert all(counts[k] == 0 for k in _build.PLAIN)


def test_mesh_checkpoint_on_card_equals_cpu(cuda, tmp_path):
    """(c) of tests/torch_mesh_paths.py on a 2-shard mesh of the card: 6
    uninterrupted rounds equal the cpu's, and the checkpoint saved at round
    2 and resumed to round 6, on 2 shards and on one, gives their state."""
    from pacbioassembly_tpu_torch.parallel import make_mesh
    from torch_mesh_paths import CHECKPOINT, checkpoint_configs, checkpoint_runs, patterns
    from torch_mesh_paths import port_reads, records

    data = records()
    runs = checkpoint_runs(data, str(tmp_path / "ck.npz"), make_mesh(devices=[cuda, cuda]),
                           device=cuda)
    cpu = BatchAssembler(checkpoint_configs(str(tmp_path / "unused.npz"))["full"],
                         port_reads(data), patterns(), device="cpu")
    cpu.run(out=None)
    want = _engine_state(cpu)
    assert _engine_state(runs["full"]) == want and runs["full"].mesh.size == 2
    saved = CHECKPOINT["saved"]
    for name in ("resumed", "resumed_1"):
        got = _engine_state(runs[name])
        assert got == (want[0][saved:], *want[1:]), name


@pytest.mark.parametrize("case", ["locked", "dump", "host_traceback"])
def test_branches_on_card_equal_cpu(cuda, case):
    """tests/torch_branches.py's `-l`, `-d` and device_traceback=False on
    the card equal the cpu: printed consensus, dump bytes, RoundStats,
    contig, votes and survivors; K2 and W launch only under `-d`."""
    from torch_branches import port_run

    _build.reset_counts()
    card = port_run(case, device=cuda)
    counts = dict(_build.LAUNCHES)
    cpu = port_run(case, device="cpu")
    assert (card["out"], card["dump"]) == (cpu["out"], cpu["dump"])
    assert _engine_state(card["engine"]) == _engine_state(cpu["engine"])
    assert counts["bitwave_fullscreen"] > 0 and all(counts[k] == 0 for k in _build.PLAIN)
    assert (counts["tbwave"] > 0 and counts["walk"] > 0) == (case == "dump")
    assert counts["tbwave"] == counts["walk"]
