"""The 15% CLR store of tests/test_batch.py::test_prefilter_no_lost_accepts_high_error
(a 25 kb genome at 14x, reads 800-1,200, split_error_rate(0.15, "clr"):
1:12:4 substitutions, insertions, deletions; seed 17) and the settings the
port's tests run on it, built with the port's own simulator and codec
(equal to the JAX package's, tests/test_torch_host_copies.py), so that
tests/test_torch_gpu.py, which imports no JAX, can use them too.

ENGINE is the JAX test's engine (rng_seed 3, round-robin, 8 rounds).
RETREAT is the whole-genome runs' stall recovery (benchmarks/ecoli_scale.py
--edge-retreat 400 --retreat-bite 96 --retreat-min-len 20000
--retreat-fruitless 3) with the minimum length scaled to the 25 kb genome:
uncapped, two contigs on it take 158 rounds and 14 retreats (fixed bites,
and a fruitless escape that ends contig 1). RESTARTS stops each contig
after RESTART_ROUNDS rounds, which keeps the JAX engine's CPU run short."""

from __future__ import annotations

import os

from pacbioassembly_tpu_torch.codec import binary_io
from pacbioassembly_tpu_torch.tools.simulate import SimConfig, simulate, split_error_rate

SEEDS = os.path.join(os.path.dirname(__file__), "data", "seeds.txt")
ENGINE = dict(engine="batch", rng_seed=3, pattern_schedule="roundrobin", max_round=8)
RETREAT = dict(edge_retreat=400, edge_retreat_bite=96, edge_retreat_min_len=2000,
               edge_retreat_fruitless=3)
RESTART_ROUNDS = 3
RESTARTS = dict(ENGINE, max_round=RESTART_ROUNDS, **RETREAT)
MIN_CONTIG = 2000  # classify_reads' mapping targets (10 kb on the 4.6 Mb genome)


def write_clr_store(tmp_dir) -> str:
    """The store as a record file; returns its path."""
    sub, ins, dele = split_error_rate(0.15, "clr")
    _, reads, _ = simulate(SimConfig(
        genome_len=25_000, coverage=14.0, mean_read_len=1000,
        min_read_len=800, max_read_len=1200,
        sub_rate=sub, ins_rate=ins, del_rate=dele, seed=17,
    ))
    path = os.path.join(str(tmp_dir), "pf15.bin")
    with open(path, "wb") as fh:
        binary_io.write_records(fh, reads)
    return path
