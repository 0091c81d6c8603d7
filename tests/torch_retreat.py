"""Read stores and settings of the stall-recovery (edge retreat) fixtures,
built with the port's own simulator and codec (equal to the JAX package's,
tests/test_torch_host_copies.py), so that tests/test_torch_gpu.py, which
imports no JAX, can use them too.

(a) STALL: tests/test_batch.py::test_edge_retreat_recovers_from_stall's
    store (30 kb at 14x, reads 600-1000, 5% each of substitutions,
    insertions and deletions, seed 21) with rng_seed 5, the random pattern
    schedule over tests/data/seeds.txt and edge_retreat 8. Every pattern
    fails from round 12 to round 19, and the stall's weak fringe is trimmed
    after round 19 (103 cells); STALL_ROUNDS stops one round after it.
(b) FRUITLESS: tests/test_batch.py::test_fruitless_retreat_escape's store
    (a 3 kb genome at 3x, reads 600-1200, 1% each, seed 1, plus 3 random
    800-base junk reads) with rng_seed 0, round-robin over one pattern,
    edge_retreat 50, edge_retreat_bite 8, edge_retreat_fruitless 2: the
    contig starts from a junk read, nothing aligns, each stall takes a fixed
    bite (retreat_fixed), and the escape ends the run after three retreats.
(c) STALL with edge_retreat_min_len above the stalled contig's length: the
    retreat (a) takes after round 19 is refused and the run stops there."""

from __future__ import annotations

import io
import os

import numpy as np

from pacbioassembly_tpu_torch.codec import binary_io, dna
from pacbioassembly_tpu_torch.tools.simulate import SimConfig, simulate

SEEDS = os.path.join(os.path.dirname(__file__), "data", "seeds.txt")

STALL = dict(engine="batch", rng_seed=5, pattern_schedule="random", edge_retreat=8)
STALL_RETREAT_ROUND = 19  # the round whose bookkeeping takes the retreat
STALL_ROUNDS = STALL_RETREAT_ROUND + 1
STALL_MIN_LEN = 5000      # (c): above the stalled contig's 4,331 bp
FRUITLESS = dict(engine="batch", rng_seed=0, pattern_schedule="roundrobin",
                 edge_retreat=50, edge_retreat_bite=8, edge_retreat_fruitless=2)
FRUITLESS_PATTERN = "1111111111111111"


def stall_records() -> bytes:
    _, reads, _ = simulate(SimConfig(
        genome_len=30_000, coverage=14.0, mean_read_len=800,
        min_read_len=600, max_read_len=1000,
        sub_rate=0.05, ins_rate=0.05, del_rate=0.05, seed=21,
    ))
    buf = io.BytesIO()
    binary_io.write_records(buf, reads)
    return buf.getvalue()


def fruitless_records() -> bytes:
    rng = np.random.default_rng(0)
    _, reads, _ = simulate(SimConfig(
        genome_len=3000, coverage=3.0, mean_read_len=900,
        min_read_len=600, max_read_len=1200,
        sub_rate=0.01, ins_rate=0.01, del_rate=0.01, seed=1,
    ))
    junk = [rng.integers(0, 4, 800).astype(np.uint8) for _ in range(3)]
    buf = io.BytesIO()
    binary_io.write_records(buf, reads + junk)
    return buf.getvalue()


def write_records(tmp_dir, name: str, records: bytes) -> str:
    path = os.path.join(str(tmp_dir), name)
    with open(path, "wb") as fh:
        fh.write(records)
    return path


def stall_patterns() -> list[int]:
    return dna.load_patterns(SEEDS)


def fruitless_patterns() -> list[int]:
    return [dna.parse_pattern(FRUITLESS_PATTERN)]


def retreat_lines(log: str) -> list[str]:
    return [ln for ln in log.splitlines() if ln.startswith("--- edge retreat")]
