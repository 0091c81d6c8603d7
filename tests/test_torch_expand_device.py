"""Port: candidate expansion's device path (assemble/batch.py::
_expand_on_device, what a CUDA engine runs) on CPU tensors, against the
numpy expand_candidates (what a CPU engine runs, held to the JAX engine
elsewhere). The five CandidateBatch fields, `dropped`, the phase_s keys and
`expand_device`, and the spans each path opens; small simulated stores, so
the file runs in seconds.
"""

from __future__ import annotations

import dataclasses
import io
from functools import lru_cache

import numpy as np
import pytest
import torch

from pacbioassembly_tpu_torch.assemble import ReadStore
from pacbioassembly_tpu_torch.assemble.batch import (
    TrialSeedCache,
    _expand_on_device,
    expand_candidates,
)
from pacbioassembly_tpu_torch.codec import binary_io, dna
from pacbioassembly_tpu_torch.config import AssemblyConfig
from pacbioassembly_tpu_torch.index import build_seedmap
from pacbioassembly_tpu_torch.tools.simulate import SimConfig, simulate
from pacbioassembly_tpu_torch.utils.metrics import recording

torch.set_num_threads(1)

CPU = torch.device("cpu")
FULL = dna.parse_pattern("1111111111111111")
SPACED = dna.parse_pattern("111*11*1*1*11111")
FIELDS = ("read", "j", "forward", "r_offset", "rank")


@lru_cache(maxsize=None)
def store(seed: int):
    """(genome codes, ReadStore) of a 9 kb genome at 8x, 3% error."""
    genome, reads, _ = simulate(SimConfig(
        genome_len=9000, coverage=8.0, mean_read_len=900, min_read_len=600,
        max_read_len=1200, sub_rate=0.01, ins_rate=0.01, del_rate=0.01, seed=seed))
    buf = io.BytesIO()
    binary_io.write_records(buf, reads)
    return genome, ReadStore(np.frombuffer(buf.getvalue(), np.uint8))


def contig(genome, kind: str) -> np.ndarray:
    """The reference the round indexes: the genome's first 4 kb; its first
    2 kb twice (every key a bucket of two); 4 kb that no read comes from;
    10 bases (an empty index)."""
    if kind == "twice":
        return np.concatenate([genome[:2000], genome[:2000]])
    if kind == "foreign":
        return np.random.default_rng(99).integers(0, 4, 4000).astype(np.uint8)
    if kind == "short":
        return genome[:10].copy()
    return genome[:4000].copy()


# id: (store seed, pattern, config overrides, survivors, contig)
CASES = {
    "seed5-full": (5, FULL, {}, "all", "head"),
    "seed5-spaced": (5, SPACED, {}, "all", "head"),
    "seed9-full": (9, FULL, {}, "all", "head"),
    "seed9-spaced": (9, SPACED, {}, "all", "head"),
    "no-dedupe": (5, SPACED, {"dedupe_diagonals": False}, "all", "head"),
    "buckets-overflow": (5, FULL, {"bucket_max_candidates": 1}, "all", "twice"),
    "buckets-overflow-no-dedupe": (9, SPACED, {"bucket_max_candidates": 1,
                                               "dedupe_diagonals": False}, "all", "twice"),
    "restart-subset": (9, FULL, {}, "subset", "head"),
    "no-survivors": (5, FULL, {}, "none", "head"),
    "no-hits": (5, FULL, {}, "all", "foreign"),
    "empty-index": (5, SPACED, {}, "all", "short"),
    "quirk-seed-at": (9, SPACED, {"quirk_seed_at": True}, "all", "head"),
}


def survivors(n: int, kind: str) -> list[int]:
    if kind == "none":
        return []
    if kind == "subset":  # a restart's survivors: a third of the reads, in no order
        rng = np.random.default_rng(4)
        return rng.permutation(n)[: n // 3].tolist()
    return list(range(n))


def both_paths(case):
    seed, pattern, over, surv, ref = CASES[case]
    genome, reads = store(seed)
    cfg = dataclasses.replace(AssemblyConfig(engine="batch"), **over)
    cache = TrialSeedCache(reads, cfg)
    index, _ = build_seedmap(contig(genome, ref), pattern)
    alive = survivors(len(reads), surv)
    host = expand_candidates(reads, alive, index, pattern, cfg, cache)
    dev = _expand_on_device(alive, index, pattern, cfg, cache, CPU)
    return host, dev


@pytest.mark.parametrize("case", list(CASES))
def test_device_expansion_equals_host(case):
    (hc, hdrop, hph), (dc, ddrop, dph) = both_paths(case)
    for f in FIELDS:
        h, d = getattr(hc, f), getattr(dc, f)
        assert d.dtype == h.dtype and np.array_equal(d, h), (case, f)
    assert ddrop == hdrop, case
    assert set(dph) == set(hph) == {"lookup_s", "expand_rest_s", "expand_device"}
    assert (hph["expand_device"], dph["expand_device"]) == (0, 1)
    # each case is what its name says
    n = len(hc)
    if case == "no-survivors" or case == "no-hits" or case == "empty-index":
        assert n == 0 and hdrop == 0, case
    else:
        assert n > 0 and hc.forward.any() and (~hc.forward).any(), case
    assert (hdrop > 0) == case.startswith("buckets-overflow"), case


def test_device_path_opens_the_host_paths_spans():
    spans = []
    for path in (expand_candidates, _expand_on_device):
        genome, reads = store(5)
        cfg = AssemblyConfig(engine="batch")
        cache = TrialSeedCache(reads, cfg)
        index, _ = build_seedmap(contig(genome, "head"), FULL)
        args = (reads,) if path is expand_candidates else ()
        extra = (CPU,) if path is _expand_on_device else ()
        with recording() as recs:
            path(*args, list(range(len(reads))), index, FULL, cfg, cache, *extra)
        spans.append([(r["name"], None if r["parent"] is None else recs[r["parent"]]["name"])
                      for r in recs])
    assert spans[0] == spans[1] == [
        ("round.expand.lookup", None), ("round.expand.seeds", "round.expand.lookup"),
        ("round.expand.probe", "round.expand.lookup"), ("round.expand.hits", None)]


def test_the_device_copy_is_made_once_a_device():
    _, reads = store(5)
    cache = TrialSeedCache(reads, AssemblyConfig(engine="batch"))
    seeds, valid = cache.on(CPU)
    again = cache.on(torch.device("cpu"))
    assert again[0] is seeds and again[1] is valid
    assert seeds.dtype == torch.int64 and np.array_equal(seeds.numpy(), cache.seeds)
    assert np.array_equal(valid.numpy(), cache.valid)
