"""Port: tools/coverage.py (a copy of the JAX package's), genome-fraction /
N50 / misassembly evaluation of an assembly: the eight cases of
tests/test_coverage.py on the port's module.

No reference analogue (the reference only measured locator residual,
doc/final.tex:266-277); this pins the unique-16-mer anchoring method used
by benchmarks/ecoli_scale.py's whole-genome summaries.
"""

import numpy as np

from pacbioassembly_tpu_torch.tools.coverage import (
    _kmers,
    _nx,
    _union_len,
    contig_intervals,
    evaluate_assembly,
)


def test_kmers_and_union():
    codes = np.array([0, 1, 2, 3] * 5, dtype=np.uint8)  # len 20 -> 5 kmers
    km = _kmers(codes)
    assert km.shape == (5,)
    assert km[0] == km[4]  # period-4 sequence: kmers repeat
    assert _union_len([(0, 10), (5, 15), (20, 25)]) == 20
    assert _nx([30, 20, 10], 60) == 30  # 30 >= 30 alone
    assert _nx([30, 20, 10], 90) == 20  # needs 30+20 >= 45
    assert _nx([10], 100) == 0  # never reaches half the denom


def test_evaluate_assembly_coverage_and_noise():
    rng = np.random.default_rng(0)
    g = rng.integers(0, 4, 100_000).astype(np.uint8)
    # contig 1: genome[10k:40k) with 1% substitutions
    c1 = g[10_000:40_000].copy()
    pos = rng.choice(len(c1), len(c1) // 100, replace=False)
    c1[pos] = (c1[pos] + 1) % 4
    # contig 2: genome[60k:90k) exact; contig 3: junk
    c2 = g[60_000:90_000].copy()
    junk = rng.integers(0, 4, 5_000).astype(np.uint8)

    r = evaluate_assembly(g, [c1, c2, junk])
    assert r["genome_len"] == 100_000
    assert r["assembly_len"] == 65_000
    # both real contigs found end to end, junk contributes nothing
    assert r["genome_covered"] == 60_000
    assert r["genome_fraction"] == 0.6
    assert r["per_contig"][0]["intervals"] == [[10_000, 40_000]]
    assert r["per_contig"][1]["intervals"] == [[60_000, 90_000]]
    assert r["per_contig"][2]["intervals"] == []
    assert r["n50"] == 30_000 and r["ng50"] == 30_000


def test_contig_intervals_gap_split():
    rng = np.random.default_rng(1)
    g = rng.integers(0, 4, 50_000).astype(np.uint8)
    from pacbioassembly_tpu_torch.tools.coverage import _unique_anchors

    keys, pos = _unique_anchors(g)
    # a chimeric contig spanning two distant genome regions must yield two
    # intervals, not one bridged span
    chim = np.concatenate([g[5_000:10_000], g[30_000:35_000]])
    iv = contig_intervals(chim, keys, pos)
    assert iv == [(5_000, 10_000), (30_000, 35_000)]


def _mutate(rng, codes, rate):
    c = codes.copy()
    pos = rng.choice(len(c), int(len(c) * rate), replace=False)
    c[pos] = (c[pos] + rng.integers(1, 4, len(pos))) % 4
    return c


def test_chains_clean_contig_one_chain():
    """An error-bearing but correctly ordered contig is ONE collinear
    chain with zero breaks (indel drift and isolated spurious anchors
    must not fragment it)."""
    from pacbioassembly_tpu_torch.tools.coverage import _unique_anchors, contig_chains

    rng = np.random.default_rng(2)
    g = rng.integers(0, 4, 200_000).astype(np.uint8)
    keys, pos = _unique_anchors(g)
    c = _mutate(rng, g[20_000:170_000], 0.03)
    # indels too: delete/duplicate a few bases so the diagonal drifts
    dele = np.sort(rng.choice(len(c), 300, replace=False))
    c = np.delete(c, dele)
    chains, breaks, micro = contig_chains(c, keys, pos)
    assert len(chains) == 1, chains
    assert breaks == []
    glo, ghi = chains[0]["genome"]
    assert abs(glo - 20_000) < 200 and abs(ghi - 170_000) < 500


def test_chains_flag_chimeric_join():
    """A contig fusing two genome regions 100 kb apart must report a
    collinearity break with genome_jump ~ the skipped distance — the
    failure mode contig_intervals is structurally blind to."""
    from pacbioassembly_tpu_torch.tools.coverage import _unique_anchors, contig_chains

    rng = np.random.default_rng(3)
    g = rng.integers(0, 4, 300_000).astype(np.uint8)
    keys, pos = _unique_anchors(g)
    chim = np.concatenate([
        _mutate(rng, g[10_000:60_000], 0.03),
        _mutate(rng, g[160_000:210_000], 0.03),
    ])
    chains, breaks, micro = contig_chains(chim, keys, pos)
    assert len(chains) == 2
    assert len(breaks) == 1
    assert breaks[0]["kind"] == "gap"
    assert abs(breaks[0]["genome_jump"] - 100_000) < 1_000
    assert abs(breaks[0]["contig_pos"] - 50_000) < 500

    ev = evaluate_assembly(g, [chim])
    assert ev["misassemblies"] == 1
    assert ev["per_contig"][0]["n_misassemblies"] == 1
    assert ev["max_break"] > 90_000
    # the old interval view still calls it "covered" — documented blindness
    assert ev["genome_fraction"] > 0.3


def test_chains_flag_shuffled_contig():
    """Genome order reversed inside the contig (B then A) is an "order"
    break, and an exact-duplicate region is flagged too."""
    from pacbioassembly_tpu_torch.tools.coverage import _unique_anchors, contig_chains

    rng = np.random.default_rng(4)
    g = rng.integers(0, 4, 300_000).astype(np.uint8)
    keys, pos = _unique_anchors(g)
    shuf = np.concatenate([g[200_000:260_000], g[20_000:80_000]])
    chains, breaks, micro = contig_chains(shuf, keys, pos)
    assert len(chains) == 2
    assert len(breaks) == 1
    assert breaks[0]["kind"] == "order"
    assert breaks[0]["genome_jump"] < -200_000

    ev = evaluate_assembly(g, [shuf])
    assert ev["misassemblies"] == 1


def test_chains_micro_insert_not_a_chimera():
    """A few hundred foreign bases spliced into an otherwise collinear
    contig (a mis-voted insertion at high error — the r4 CLR headline
    contig has a 28 bp one) must be reported as a micro_insert, NOT as a
    pair of Mb-scale chimeric breaks."""
    from pacbioassembly_tpu_torch.tools.coverage import _unique_anchors, contig_chains

    rng = np.random.default_rng(6)
    g = rng.integers(0, 4, 400_000).astype(np.uint8)
    keys, pos = _unique_anchors(g)
    c = np.concatenate([
        _mutate(rng, g[10_000:100_000], 0.03),
        g[350_000:350_200],               # 200 foreign bases
        _mutate(rng, g[100_000:190_000], 0.03),
    ])
    chains, breaks, micro = contig_chains(c, keys, pos)
    assert len(chains) == 1, chains
    assert breaks == []
    assert len(micro) == 1
    assert abs(micro[0]["contig_pos"] - 90_000) < 300
    assert micro[0]["len"] < 300
    assert abs(micro[0]["source"] - 350_000) < 100

    ev = evaluate_assembly(g, [c])
    assert ev["misassemblies"] == 0
    assert ev["per_contig"][0]["micro_inserts"] == micro


def test_chains_clean_multi_contig_zero_misassemblies():
    from pacbioassembly_tpu_torch.tools.coverage import _unique_anchors  # noqa: F401

    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 150_000).astype(np.uint8)
    c1 = _mutate(rng, g[0:70_000], 0.05)
    c2 = _mutate(rng, g[70_000:150_000], 0.05)
    ev = evaluate_assembly(g, [c1, c2])
    assert ev["misassemblies"] == 0
    assert ev["max_break"] <= 1_000
    assert all(p["n_breaks"] == 0 for p in ev["per_contig"])
