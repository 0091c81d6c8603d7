"""Synthetic PacBio-style read simulator.

Generates the benchmark configs in BASELINE.json (e.g. "synthetic 50x
PacBio reads (~15% error) vs a reference genome"): a random or supplied
genome, forward-strand reads (the reference engine has no reverse
complement — SURVEY.md §2.1 seq_accessor note) with CLR-like
substitution/insertion/deletion errors, written as a 2-bit binary record
file.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..codec import binary_io, dna


@dataclasses.dataclass
class SimConfig:
    genome_len: int = 100_000
    coverage: float = 30.0
    mean_read_len: int = 2500
    min_read_len: int = 600
    max_read_len: int = 19_000
    sub_rate: float = 0.05
    ins_rate: float = 0.05
    del_rate: float = 0.05
    seed: int = 0


def split_error_rate(total: float, profile: str = "uniform") -> tuple[float, float, float]:
    """Split a total per-base error rate into (sub, ins, del) rates.

    "uniform": e/3 each (the r1/r2 benchmark composition).
    "clr": PacBio CLR-like 1:12:4 sub:ins:del — raw CLR error is
    insertion-dominated (the reference's real data, doc/proposal.mkd
    background; ~12% ins / 4% del / 1% sub at 15-17% total)."""
    if profile == "uniform":
        return total / 3, total / 3, total / 3
    if profile == "clr":
        return total * 1 / 17, total * 12 / 17, total * 4 / 17
    raise ValueError(f"unknown error profile: {profile!r}")


def mutate_read(read: np.ndarray, cfg: SimConfig, rng: np.random.Generator) -> np.ndarray:
    """Apply CLR-style errors: per-base substitution, insertion-after,
    deletion."""
    n = len(read)
    subs = rng.random(n) < cfg.sub_rate
    shifted = (read + rng.integers(1, 4, n).astype(np.uint8)) % 4
    read = np.where(subs, shifted, read)

    dels = rng.random(n) < cfg.del_rate
    ins = rng.random(n) < cfg.ins_rate
    ins_vals = rng.integers(0, 4, n).astype(np.uint8)

    # vectorized interleave: each input base contributes (kept? 1 : 0) +
    # (insertion-after? 1 : 0) output chars
    keep = ~dels
    counts = keep.astype(np.int64) + ins.astype(np.int64)
    idx = np.repeat(np.arange(n), counts)
    vals = read[idx]
    # overwrite the second copy (the inserted char) where applicable
    second = np.zeros(len(idx), bool)
    second[1:] = idx[1:] == idx[:-1]
    vals = np.where(second, ins_vals[idx], vals)
    # where the base itself was deleted but an insertion still fires, the
    # single emitted char is the inserted one
    only_ins = ins & dels
    first_of = np.ones(len(idx), bool)
    first_of[1:] = idx[1:] != idx[:-1]
    vals = np.where(first_of & only_ins[idx], ins_vals[idx], vals)
    return vals


def simulate(cfg: SimConfig, genome: np.ndarray | None = None):
    """Returns (genome_codes, list_of_read_codes, start_positions)."""
    rng = np.random.default_rng(cfg.seed)
    if genome is None:
        genome = rng.integers(0, 4, cfg.genome_len).astype(np.uint8)
    G = len(genome)
    n_reads = max(1, int(cfg.coverage * G / cfg.mean_read_len))
    reads = []
    starts = []
    for _ in range(n_reads):
        ln = int(
            np.clip(
                rng.normal(cfg.mean_read_len, cfg.mean_read_len * 0.25),
                cfg.min_read_len,
                min(cfg.max_read_len, G),
            )
        )
        s = int(rng.integers(0, G - ln + 1))
        reads.append(mutate_read(genome[s : s + ln].copy(), cfg, rng))
        starts.append(s)
    return genome, reads, np.asarray(starts)


def cmd_simulate(args) -> int:
    sub, ins, dele = split_error_rate(
        args.error_rate, getattr(args, "error_profile", "uniform")
    )
    cfg = SimConfig(
        genome_len=args.genome_len,
        coverage=args.coverage,
        mean_read_len=args.mean_read_len,
        sub_rate=sub,
        ins_rate=ins,
        del_rate=dele,
        seed=args.seed,
    )
    genome, reads, starts = simulate(cfg)
    with open(args.out, "wb") as fh:
        binary_io.write_records(fh, reads)
    if args.genome_out:
        with open(args.genome_out, "w") as fh:
            fh.write(dna.codes_to_text(genome) + "\n")
    import sys

    print(
        f"wrote {len(reads)} reads (~{sum(map(len, reads))/len(genome):.1f}x) "
        f"to {args.out}",
        file=sys.stderr,
    )
    return 0
