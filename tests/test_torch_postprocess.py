"""Port: tools/postprocess.py, contig dedupe and read accounting. The three
cases of tests/test_postprocess.py on the port's functions (classify_reads
mapping through the port's locator on the CPU), then each function against
the JAX package's on the same seeded inputs, exactly."""

import numpy as np
import pytest
import torch

import pacbioassembly_tpu.tools.postprocess as jax_post
from pacbioassembly_tpu.tools.coverage import _unique_anchors as jax_anchors
from pacbioassembly_tpu_torch.tools.coverage import _unique_anchors
from pacbioassembly_tpu_torch.tools.postprocess import (
    classify_reads,
    contig_containment,
    dedupe_contigs,
)

torch.set_num_threads(1)


def _mutate(rng, codes, rate):
    c = codes.copy()
    pos = rng.choice(len(c), int(len(c) * rate), replace=False)
    c[pos] = (c[pos] + rng.integers(1, 4, len(pos))) % 4
    return c


def _dedupe_case():
    rng = np.random.default_rng(7)
    g = rng.integers(0, 4, 200_000).astype(np.uint8)
    big = _mutate(rng, g[10_000:110_000], 0.02)
    contained = _mutate(rng, g[40_000:43_000], 0.03)  # inside big's region
    elsewhere = _mutate(rng, g[150_000:153_000], 0.03)  # not covered
    # 50% overlap with big: must be KEPT (overlap is not containment)
    partial = _mutate(rng, np.concatenate([g[100_000:110_000], g[110_000:120_000]]), 0.02)
    return [big, contained, elsewhere, partial]


def _containment_case():
    rng = np.random.default_rng(8)
    g = rng.integers(0, 4, 100_000).astype(np.uint8)
    inside = _mutate(rng, g[20_000:30_000], 0.03)
    outside = rng.integers(0, 4, 10_000).astype(np.uint8)
    half = np.concatenate([inside[:5_000], outside[:5_000]])
    return g, [inside, outside, half]


def _classify_case():
    rng = np.random.default_rng(9)
    g = rng.integers(0, 4, 80_000).astype(np.uint8)
    contig = _mutate(rng, g[0:60_000], 0.02)
    mapped_read = _mutate(rng, g[20_000:22_000], 0.05)
    junk_read = rng.integers(0, 4, 2_000).astype(np.uint8)
    offcontig_read = _mutate(rng, g[62_000:64_000], 0.05)  # region not assembled
    # head seeds hit, but the read as a whole cannot align
    seeded_only_read = np.concatenate(
        [g[30_000:30_100], rng.integers(0, 4, 1_900).astype(np.uint8)]
    )
    short_read = g[5_000:5_300].copy()
    # head is junk, tail matches: only the BACKWARD pass can map it
    bwd_read = np.concatenate(
        [rng.integers(0, 4, 300).astype(np.uint8), _mutate(rng, g[10_000:11_500], 0.05)]
    )
    reads = [mapped_read, junk_read, offcontig_read, seeded_only_read, short_read, bwd_read]
    return [contig], reads


def test_dedupe_contained_contig_dropped():
    kept, dropped = dedupe_contigs(_dedupe_case())
    assert kept == [0, 2, 3]
    assert len(dropped) == 1
    assert dropped[0]["idx"] == 1 and dropped[0]["into"] == 0
    assert dropped[0]["covered"] > 0.9


def test_containment_fraction():
    g, (inside, outside, half) = _containment_case()
    keys, pos = _unique_anchors(g)
    assert contig_containment(inside, keys, pos) > 0.95
    assert contig_containment(outside, keys, pos) < 0.05
    assert 0.4 < contig_containment(half, keys, pos) < 0.6


def test_classify_reads_categories():
    contigs, reads = _classify_case()
    res = classify_reads(contigs, reads, 0xFFFFFFFF, ratio=0.3, device="cpu")
    cat = res["categories"]
    assert cat[0] == 0, res  # mapped
    assert cat[1] == 2  # unseedable junk
    assert cat[2] == 2  # region not in the contig
    assert cat[3] == 1  # seeded but unalignable
    assert cat[4] == 3  # too short
    assert cat[5] == 0  # mapped by the backward pass
    assert res["total"] == 6 and res["mapped"] == 2 and res["too_short"] == 1


@pytest.mark.parametrize("fn", ["dedupe_contigs", "contig_containment", "classify_reads"])
def test_postprocess_equals_jax(fn):
    if fn == "dedupe_contigs":
        contigs = _dedupe_case()
        # every order of the set, and a stricter cut that also drops `partial`
        for order in ([0, 1, 2, 3], [3, 1, 0, 2], [2, 3, 1, 0]):
            for cut in (0.8, 0.4):
                sel = [contigs[i] for i in order]
                assert dedupe_contigs(sel, cut) == jax_post.dedupe_contigs(sel, cut)
    elif fn == "contig_containment":
        g, smalls = _containment_case()
        keys, pos = _unique_anchors(g)
        jkeys, jpos = jax_anchors(g)
        np.testing.assert_array_equal(keys, jkeys)
        np.testing.assert_array_equal(pos, jpos)
        for s in smalls + [np.zeros(0, np.uint8)]:
            assert contig_containment(s, keys, pos) == jax_post.contig_containment(s, keys, pos)
    else:
        contigs, reads = _classify_case()
        # a short second contig: skipped at min_contig 10,000, mapped onto at 1,000
        contigs = contigs + [contigs[0][40_000:45_000].copy()]
        for min_contig in (10_000, 1_000):
            got = classify_reads(contigs, reads, 0xFFFFFFFF, 0.3, min_contig, device="cpu")
            want = jax_post.classify_reads(contigs, reads, 0xFFFFFFFF, 0.3, min_contig)
            np.testing.assert_array_equal(got.pop("categories"), want.pop("categories"))
            assert got == want
