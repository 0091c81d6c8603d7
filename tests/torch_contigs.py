"""The two-segment read store of tests/test_batch.py::test_multi_contig_assembly
(two unrelated 8 kb segments at 10x, reads 600-900, 1% each of
substitutions, insertions and deletions), which forces the batch engine to
restart: one contig per segment, then scraps. Built with the port's own
simulator and codec (equal to the JAX package's, tests/test_torch_host_copies.py),
so that tests/test_torch_gpu.py, which imports no JAX, can use it too."""

from __future__ import annotations

import io
import os

import numpy as np

from pacbioassembly_tpu_torch.codec import binary_io
from pacbioassembly_tpu_torch.tools.simulate import SimConfig, simulate

SEEDS = os.path.join(os.path.dirname(__file__), "data", "seeds.txt")
# the JAX test's engine settings; restarts take rng_seed + contig index
CONFIG = dict(engine="batch", rng_seed=1, pattern_schedule="roundrobin", max_round=40)
# the CPU tests' smaller store and settings, which keep the JAX engine's
# CPU run short: 4 rounds a contig give one contig a segment, then two
# one-read scraps contained in them
SMALL = dict(seg_len=4000, coverage=8.0)
SETTINGS = dict(CONFIG, rng_seed=2, max_round=4)


def two_segment_reads(seg_len=8000, coverage=10.0) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """(segments, reads)."""
    rng = np.random.default_rng(3)
    segs = [rng.integers(0, 4, seg_len).astype(np.uint8) for _ in range(2)]
    reads = []
    for g in segs:
        _, rl, _ = simulate(
            SimConfig(
                genome_len=len(g), coverage=coverage, mean_read_len=700,
                min_read_len=600, max_read_len=900,
                sub_rate=0.01, ins_rate=0.01, del_rate=0.01, seed=5,
            ),
            genome=g,
        )
        reads += rl
    return segs, reads


def write_two_segments(tmp_dir, **kw) -> str:
    """The store as a record file; returns its path."""
    path = os.path.join(str(tmp_dir), "two.bin")
    with open(path, "wb") as fh:
        binary_io.write_records(fh, two_segment_reads(**kw)[1])
    return path


def assemble_contigs_both(store: str, dedupe: bool):
    """The port's `assemble_contigs` on the CPU and the JAX package's on the
    small store with SETTINGS, 4 contigs: asserts equal ContigResults,
    surviving reads and logs, and returns the port's (contigs, surviving).
    The caller pins the JAX engine to one device. (The JAX imports stay in
    here: tests/test_torch_gpu.py imports this module without JAX.)"""
    import difflib
    import io

    import pytest

    from pacbioassembly_tpu.assemble import ReadStore as JaxReads
    from pacbioassembly_tpu.assemble.batch import BatchAssembler as JaxAssembler
    from pacbioassembly_tpu.assemble.batch import assemble_contigs as jax_assemble_contigs
    from pacbioassembly_tpu.config import AssemblyConfig
    from pacbioassembly_tpu_torch.assemble.batch import assemble_contigs
    from pacbioassembly_tpu_torch.codec import dna
    from torch_slice import port_config, port_reads

    cfg = AssemblyConfig(**SETTINGS)
    patterns = dna.load_patterns(SEEDS)
    jlog, plog = io.StringIO(), io.StringIO()
    # The JAX device builder keys its window cache on id(ref). Contigs 2 and
    # 3 here are one-read contigs with equal windows, so a restart whose
    # reference takes the freed previous one's address is served the previous
    # contig's window (seen in a full parallel run: the JAX engine screened
    # contig 3's first round against contig 2's window). Keeping every JAX
    # engine's reference alive for the run keeps the addresses distinct; the
    # port keys its cache on a weak reference (assemble/gather.py).
    kept_refs = []
    real_init = JaxAssembler.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        kept_refs.append(self.ref)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxAssembler, "__init__", init)
        want, want_surv = jax_assemble_contigs(
            cfg, JaxReads.from_file(store, cfg), patterns, 4, log=jlog, dedupe=dedupe
        )
    assert len(kept_refs) == 4
    pcfg = port_config(cfg)
    got, got_surv = assemble_contigs(
        pcfg, port_reads(store, pcfg), patterns, 4, log=plog, dedupe=dedupe, device="cpu"
    )
    assert [(c.codes.tolist(), c.nreads, c.nrounds) for c in got] == [
        (c.codes.tolist(), c.nreads, c.nrounds) for c in want
    ]
    assert got_surv == want_surv
    assert plog.getvalue() == jlog.getvalue(), "\n".join(difflib.unified_diff(
        jlog.getvalue().splitlines(), plog.getvalue().splitlines(), "jax", "port", lineterm=""))
    assert plog.getvalue().count("=== dropping contig") == 2 * dedupe
    return got, got_surv


def boundary_commit_case():
    """tests/test_batch.py::test_parallel_commit_equivalence's reads: on a
    120 kb reference, interior copies near each boundary (half of them
    mutated) and one grower a side, each with its one candidate. Returns
    (L, reference codes, record bytes, candidate rows (read, j, forward,
    r_offset)); the two-thread commit splits it unless a guard holds."""
    rng = np.random.default_rng(5)
    L = 120_000
    genome = rng.integers(0, 4, L + 600).astype(np.uint8)  # 300bp tails
    ref_codes = genome[300 : 300 + L]
    read_list, cand_rows = [], []  # cand_rows: (read_idx, j, forward, r_offset)
    for k in range(6):  # right-region forward reads
        start = L - 2000 - 137 * k
        seg = ref_codes[start : start + 1800].copy()
        if k % 2:
            pos = rng.choice(1800, 18, replace=False)
            seg[pos] = (seg[pos] + 1) % 4
        read_list.append(seg)
        cand_rows.append((len(read_list) - 1, 0, True, start))
    read_list.append(genome[300 + L - 1500 : 300 + L + 300].copy())  # right grower
    cand_rows.append((len(read_list) - 1, 0, True, L - 1500))
    for k in range(6):  # left-region backward reads
        end = 2000 + 141 * k
        seg = ref_codes[end - 1800 : end].copy()
        if k % 2 == 0:
            pos = rng.choice(1800, 18, replace=False)
            seg[pos] = (seg[pos] + 1) % 4
        read_list.append(seg)
        cand_rows.append((len(read_list) - 1, 0, False, end - 1))
    read_list.append(genome[0 : 300 + 1500].copy())  # left grower
    cand_rows.append((len(read_list) - 1, 0, False, 1499))
    buf = io.BytesIO()
    binary_io.write_records(buf, read_list)
    return L, ref_codes, buf.getvalue(), cand_rows
