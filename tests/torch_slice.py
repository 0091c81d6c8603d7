"""Shared fixture data for the port's slice tests: a 12 kb simulated genome
(tests/test_tbwave.py's batch-engine fixture: 12x coverage, 3% each of
substitutions, insertions and deletions, seed 8), with reads capped at
1,000 bases and a 1.5 kb initial reference cut from the genome, so that
every screen and commit launch stays in the 1024 size bucket. That keeps
the JAX engine's per-shape XLA compiles, which dominate its CPU run time,
to one shape per launch kind.

The fixture files are written with the JAX package's codec and simulator;
`slice_config` builds the JAX engine's config and `port_config` the same
config as the port's own class, so each engine gets its own types."""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from pacbioassembly_tpu.codec import binary_io, dna
from pacbioassembly_tpu.config import AssemblyConfig
from pacbioassembly_tpu.tools.simulate import SimConfig, simulate

SEEDS = os.path.join(os.path.dirname(__file__), "data", "seeds.txt")
PATTERN = "1111111111111111"


def write_fixture(tmp_dir) -> dict:
    sim = SimConfig(
        genome_len=12_000, coverage=12.0, mean_read_len=800,
        min_read_len=600, max_read_len=1000,
        sub_rate=0.03, ins_rate=0.03, del_rate=0.03, seed=8,
    )
    genome, read_list, _ = simulate(sim)
    binfile = os.path.join(tmp_dir, "reads.bin")
    with open(binfile, "wb") as fh:
        binary_io.write_records(fh, read_list)
    init = os.path.join(tmp_dir, "init.txt")
    with open(init, "w") as fh:
        fh.write(dna.codes_to_text(genome[2000:3500]) + "\n1\n")
    seeds = os.path.join(tmp_dir, "seeds.txt")
    with open(seeds, "w") as fh:
        fh.write(PATTERN + "\n")
    return {"bin": binfile, "init": init, "seeds": seeds}


def slice_config(fx: dict, **kw) -> AssemblyConfig:
    """The slice's config: round-robin, seeded, with the prefilter forced
    on (prefilter_min_batch=1) so every round runs both screening passes."""
    cfg = AssemblyConfig(
        engine="batch", rng_seed=4, pattern_schedule="roundrobin",
        max_round=6, prefilter_min_batch=1, initial_ref_path=fx["init"],
    )
    return dataclasses.replace(cfg, **kw)


def port_config(cfg: AssemblyConfig):
    """The same config as the port's own AssemblyConfig."""
    from pacbioassembly_tpu_torch.config import AssemblyConfig as PortConfig

    return PortConfig(**dataclasses.asdict(cfg))


def port_reads(path: str, cfg):
    """The port's own ReadStore of a fixture file."""
    from pacbioassembly_tpu_torch.assemble import ReadStore as PortReads

    return PortReads.from_file(path, cfg)


def history_dicts(asm) -> list[dict]:
    """RoundStats as dicts: each engine has its own RoundStats class."""
    return [dataclasses.asdict(s) for s in asm.history]


def patterns() -> list[int]:
    return [dna.parse_pattern(PATTERN)]


def assert_same_state(a, b) -> None:
    """Contig bytes, votes over [beg, end) and the surviving read set."""
    np.testing.assert_array_equal(a.ref.text(), b.ref.text())
    for f in ("sel", "sup", "total"):
        np.testing.assert_array_equal(
            getattr(a.ref, f)[a.ref.beg : a.ref.end], getattr(b.ref, f)[b.ref.beg : b.ref.end]
        )
    assert a.surviving == b.surviving
