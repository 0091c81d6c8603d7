"""The store and settings of the multi-device dry run's three mesh paths
(`__graft_entry__.py`, part 3): edge retreat, multi-contig restarts with the
containment dedupe, and a checkpoint resumed on the mesh. Built with the
port's own simulator and codec (equal to the JAX package's,
tests/test_torch_host_copies.py), so that tests/test_torch_gpu.py and
chip_smoke.py's card runs, which import no JAX, can use it too.

The store: two unrelated 6,000-base segments (rng 7), each simulated at
10x, reads 550-900 (mean 700), 2% each of substitutions, insertions and
deletions, seed 11. One pattern, `1111111111111111`. The settings: 30
rounds, rng_seed 1, round-robin, edge_retreat 2 with a 48-cell bite, so the
contig's weak fringe is trimmed at each convergence and screened again.

(a) RETREAT: one engine run to its end (10 rounds, 2 retreats).
(b) CONTIGS: `assemble_contigs(..., 3)`, with and without the dedupe.
(c) CHECKPOINT: rng_seed 5, saved at round 2 (checkpoint_every 2) and
    resumed to round 6, against 6 uninterrupted rounds."""

from __future__ import annotations

import dataclasses
import io

import numpy as np

from pacbioassembly_tpu_torch.assemble import ReadStore
from pacbioassembly_tpu_torch.codec import binary_io, dna
from pacbioassembly_tpu_torch.tools.simulate import SimConfig, simulate

PATTERN = "1111111111111111"
SETTINGS = dict(max_round=30, rng_seed=1, pattern_schedule="roundrobin",
                edge_retreat=2, edge_retreat_bite=48)
N_CONTIGS = 3
# (c): the checkpoint's round, the resumed run's last round and its seed
CHECKPOINT = dict(rng_seed=5, saved=2, rounds=6)


def records() -> bytes:
    rng = np.random.default_rng(7)
    segs = [rng.integers(0, 4, 6000).astype(np.uint8) for _ in range(2)]
    reads = []
    for g in segs:
        _, rl, _ = simulate(
            SimConfig(genome_len=len(g), coverage=10.0, mean_read_len=700,
                      min_read_len=550, max_read_len=900,
                      sub_rate=0.02, ins_rate=0.02, del_rate=0.02, seed=11),
            genome=g,
        )
        reads += rl
    buf = io.BytesIO()
    binary_io.write_records(buf, reads)
    return buf.getvalue()


def port_reads(data: bytes) -> ReadStore:
    return ReadStore(np.frombuffer(data, dtype=np.uint8))


def patterns() -> list[int]:
    return [dna.parse_pattern(PATTERN)]


def config(**kw):
    """The port's AssemblyConfig of the paths (the dry run leaves `engine`
    at its default; the engine is built directly)."""
    from pacbioassembly_tpu_torch.config import AssemblyConfig

    return dataclasses.replace(AssemblyConfig(**SETTINGS), **kw)


def checkpoint_configs(path: str) -> dict:
    """(c)'s three runs: 'full' (6 uninterrupted rounds), 'saved' (2 rounds,
    checkpoint at round 2 into `path`), 'resumed' (from `path` to round 6)."""
    base = config(rng_seed=CHECKPOINT["rng_seed"])
    n, saved = CHECKPOINT["rounds"], CHECKPOINT["saved"]
    return {
        "full": dataclasses.replace(base, max_round=n),
        "saved": dataclasses.replace(base, max_round=saved, checkpoint_path=path,
                                     checkpoint_every=saved),
        "resumed": dataclasses.replace(base, max_round=n, resume_path=path),
    }


def contig_rows(contigs) -> list[tuple]:
    """ContigResults as comparable tuples (each engine has its own class)."""
    return [(c.codes.tolist(), c.nreads, c.nrounds) for c in contigs]


def kept_engines(Engine):
    """An `Engine.__init__` that keeps every engine it builds in a list:
    (init, list), for `monkeypatch.setattr(Engine, "__init__", init)`.
    Keeping the JAX engines alive also keeps the JAX builder's id(ref)
    window cache from serving a freed reference's window to a restart
    (tests/torch_contigs.py::assemble_contigs_both)."""
    kept = []
    real_init = Engine.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        kept.append(self)

    return init, kept


def contig0_log(log: str) -> str:
    """The round and retreat lines of the first contig: (a)'s run."""
    return log[: log.index("=== contig 0")]


def contigs_run(data: bytes, mesh, dedupe: bool = True, device="cpu") -> dict:
    """The port's `assemble_contigs(..., N_CONTIGS)` over `mesh` (None: one
    shard on `device`), keeping every engine, each engine's per-round
    launch logs and the rows of each screening shard. Its first engine is
    (a)'s retreat run: the same config and seed, built the same way.
    Returns dict(engines, contigs (contig_rows), surviving, log, launches
    {engine: [round's launch log]}, shards {engine: [rows]})."""
    import pytest

    from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler, assemble_contigs
    from pacbioassembly_tpu_torch.parallel import sharded

    init, engines = kept_engines(BatchAssembler)
    launches, shards = {}, {}
    real_round, real_score = BatchAssembler.run_round, sharded.score_batch

    def run_round(self, log=None):
        stats = real_round(self, log=log)
        launches.setdefault(len(engines) - 1, []).append(list(self.launch_log))
        return stats

    def score_spy(a, la, b, lb, **kw):
        shards.setdefault(len(engines) - 1, []).append(len(la))
        return real_score(a, la, b, lb, **kw)

    log = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BatchAssembler, "__init__", init)
        mp.setattr(BatchAssembler, "run_round", run_round)
        mp.setattr(sharded, "score_batch", score_spy)
        contigs, surv = assemble_contigs(config(), port_reads(data), patterns(), N_CONTIGS,
                                         log=log, dedupe=dedupe, device=device, mesh=mesh)
    return dict(engines=engines, contigs=contig_rows(contigs), surviving=surv,
                log=log.getvalue(), launches=launches, shards=shards)


def counters(asm) -> tuple:
    return (asm.nround, asm.nfailure, asm.retreats, asm.fruitless_retreats,
            asm.matches_since_retreat)


def checkpoint_runs(data: bytes, path: str, mesh, device="cpu") -> dict:
    """(c) on `device`: 'full' (6 rounds) and 'saved' (2 rounds, the
    checkpoint into `path`) over `mesh`, then the checkpoint resumed to
    round 6 over `mesh` ('resumed') and on one shard ('resumed_1').
    Engines by name."""
    from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler

    cfgs = checkpoint_configs(path)
    runs = {}
    for name, key, m in (("full", "full", mesh), ("saved", "saved", mesh),
                         ("resumed", "resumed", mesh), ("resumed_1", "resumed", None)):
        asm = BatchAssembler(cfgs[key], port_reads(data), patterns(), device=device, mesh=m)
        asm.run(out=None, log=None)
        runs[name] = asm
    return runs
