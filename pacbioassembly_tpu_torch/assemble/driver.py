"""Assembly round driver.

The exact engine replicates the reference round loop
(spaced_seed.cpp:410-453) including mid-round growth and immediate read
removal — bit-parity with the C++ pipeline on deterministic configs
(pinned initial reference; single pattern or round-robin schedule).

The batch engine (assemble/batch.py) redefines round semantics for TPU
scale: candidates are screened in bulk on device against the round-start
reference, votes are commutative tensor updates, and boundary extension is
committed sequentially at end of round.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, TextIO

import numpy as np

from ..align import exact_align
from ..codec import dna
from ..config import AssemblyConfig, Constants
from ..consensus import ConsensusRef
from ..index import build_seedmap
from .reads import ReadStore


@dataclasses.dataclass
class RoundStats:
    nround: int
    pattern: int
    seedmap_size: int
    ref_len: int
    nmatches: int
    ntrials: int
    nreads_left: int
    dp_cells: int  # banded-DP cells attempted this round (perf accounting)
    # index hits beyond bucket_max_candidates that were NOT expanded this
    # round (batch engine only; the reference tries every candidate in a
    # bucket, spaced_seed.cpp:282-296 — a nonzero value flags repetitive
    # genomes where the cap bites)
    dropped_candidates: int = 0


def init_reference(
    cfg: AssemblyConfig,
    reads: ReadStore,
    rng: np.random.Generator,
    candidates: list[int] | None = None,
) -> ConsensusRef:
    """Initial reference: from -f file (line1 sequence, line2 weight) or a
    random read (init, spaced_seed.cpp:188-230). `candidates` restricts
    the random pick (multi-contig restarts pick from surviving reads)."""
    if cfg.initial_ref_path:
        with open(cfg.initial_ref_path) as fh:
            line = fh.readline()
            # quirk: the reference keeps fgets's trailing '\n' as a bogus
            # final base (C2I('\n') == 3; spaced_seed.cpp:198-203)
            seq = line.rstrip("\n") + ("\n" if cfg.quirk_init_newline and line.endswith("\n") else "")
            try:
                weight = int(fh.readline().split()[0])
            except (IndexError, ValueError):
                weight = 1
        return ConsensusRef(
            dna.text_to_codes(seq),
            locked=cfg.locked,
            weight=weight,
            capacity=3 * cfg.max_seq_len,
            overlap_min=cfg.overlap_min,
            vote_ratio=cfg.vote_ratio,
        )
    if candidates is not None and len(candidates) < len(reads):
        i = int(candidates[int(rng.integers(0, len(candidates)))])
    else:
        i = int(rng.integers(0, len(reads)))
    return ConsensusRef(
        reads.codes(i).copy(),
        locked=cfg.locked,
        capacity=3 * cfg.max_seq_len,
        overlap_min=cfg.overlap_min,
        vote_ratio=cfg.vote_ratio,
    )


class Assembler:
    def __init__(
        self,
        cfg: AssemblyConfig,
        reads: ReadStore,
        patterns: list[int],
        ref: Optional[ConsensusRef] = None,
        dump: Optional[TextIO] = None,
    ):
        if not patterns:
            raise ValueError("no seed patterns")
        self.cfg = cfg
        self.reads = reads
        self.patterns = patterns
        self.rng = np.random.default_rng(cfg.rng_seed)
        self.ref = ref if ref is not None else init_reference(cfg, reads, self.rng)
        self.dump = dump
        self.surviving = list(range(len(reads)))
        self.nfailure = 0
        self.nround = 0
        self.ntrials_total = 0
        self.dp_cells_total = 0
        self.history: list[RoundStats] = []
        if cfg.quirk_stale_dp:
            from ..align.dispatch import quirk_dp_reset

            quirk_dp_reset()  # fresh-process matrix state per run
        self._aligner = partial(
            exact_align, ratio=cfg.ratio, quirk_stale_dp=cfg.quirk_stale_dp
        )

    # ---------------------------------------------------------------- schedule

    def _pick_pattern(self) -> int:
        """Pattern selection (spaced_seed.cpp:412): after a zero-match round,
        cycle patterns deterministically by failure count; otherwise pick by
        the configured schedule."""
        if self.nfailure != 0:
            return self.patterns[self.nfailure - 1]
        if self.cfg.pattern_schedule == "roundrobin":
            return self.patterns[(self.nround - 1) % len(self.patterns)]
        return self.patterns[int(self.rng.integers(0, len(self.patterns)))]

    # ---------------------------------------------------------------- trials

    def _read_seed(self, i: int, pos: int) -> int:
        if self.cfg.quirk_seed_at:
            return self.reads.quirk_seed(i, pos)
        return dna.encode_seed(self.reads.codes(i), pos)

    def _try_trial(self, i: int, pos: int, forward: bool, index, pattern: int) -> bool:
        """One seeding trial (try_align, spaced_seed.cpp:261-299)."""
        masked = self._read_seed(i, pos) & pattern
        cands = index.lookup(masked)
        if len(cands) == 0:
            return False
        self._round_trials += 1
        codes = self.reads.codes(i)
        slen = len(codes)
        if forward:
            s_offset = pos
            seg = codes[s_offset:]
        else:
            s_offset = pos + Constants.SEED_LEN - 1
            seg = codes[: s_offset + 1][::-1]
        if len(seg) < self.cfg.overlap_min:
            return False
        for cand in cands:
            r_offset = int(cand) + (0 if forward else Constants.SEED_LEN - 1)
            band = _dp_cells_estimate(
                self.ref.post - self.ref.beg - r_offset
                if forward
                else r_offset + self.ref.beg - self.ref.pre + 1,
                len(seg),
                self.cfg.ratio,
            )
            self._round_dp_cells += band
            res = self.ref.try_align(self._aligner, r_offset, seg, forward)
            if res is not None:
                self._last_result = res
                if self.dump is not None:
                    self._dump_match(r_offset, forward, seg, res)
                return True
        return False

    def _dump_match(self, r_offset: int, forward: bool, seg: np.ndarray, res) -> None:
        """-d dump of matched (ref, seg) pair (dump_seq, spaced_seed.cpp:126-133)."""
        ref_codes = self.ref.accessor(r_offset, forward)[: res.matlen_a]
        self.dump.write(dna.codes_to_text(ref_codes) + "\n")
        self.dump.write(dna.codes_to_text(seg[: res.matlen_b]) + "\n")

    # ---------------------------------------------------------------- rounds

    def run_round(self, log: Optional[TextIO] = None) -> RoundStats:
        """One full round: rebuild index, scan surviving reads, evolve."""
        cfg = self.cfg
        self.nround += 1
        pattern = self._pick_pattern()
        index, n_indexed = build_seedmap(self.ref.text(), pattern)
        self._round_trials = 0
        self._round_dp_cells = 0
        nmatches = 0

        still = []
        for i in self.surviving:
            slen = self.reads.length(i)
            found = False
            for j in range(cfg.max_trial):
                if self._try_trial(i, j, True, index, pattern) or self._try_trial(
                    i, slen - j - Constants.SEED_LEN, False, index, pattern
                ):
                    found = True
                    nmatches += 1
                    if log:
                        r = self._last_result
                        log.write(
                            f"found {self.reads.ids[i]} at cost {r.cost}:\t"
                            f"ref_ml={r.matlen_a},\tseg_ml={r.matlen_b}\n"
                        )
                    break
            if not found:
                still.append(i)
        self.surviving = still

        if nmatches != 0:
            self.nfailure = 0
        else:
            self.nfailure += 1

        converged = self.nfailure >= len(self.patterns)
        if not converged:
            self.ref.evolve()

        stats = RoundStats(
            nround=self.nround,
            pattern=pattern,
            seedmap_size=n_indexed,
            ref_len=self.ref.length(),
            nmatches=nmatches,
            ntrials=self._round_trials,
            nreads_left=len(self.surviving),
            dp_cells=self._round_dp_cells,
        )
        self.ntrials_total += self._round_trials
        self.dp_cells_total += self._round_dp_cells
        self.history.append(stats)
        return stats

    def run(
        self,
        out: Optional[TextIO] = None,
        log: Optional[TextIO] = None,
    ) -> ConsensusRef:
        """Full assembly loop (main, spaced_seed.cpp:410-453). Prints the
        consensus to `out` after every round, like the reference."""
        cfg = self.cfg
        metrics = None
        if cfg.metrics_path:
            from ..utils import MetricsLogger

            metrics = MetricsLogger(path=cfg.metrics_path)
            metrics.event("run_start", resume=bool(cfg.resume_path))
        if cfg.resume_path:
            from .checkpoint import load_checkpoint

            load_checkpoint(cfg.resume_path, self)
        from ..utils import profiled

        profile_ctx = profiled(cfg.profile_dir)
        profile_ctx.__enter__()
        max_round = cfg.max_round if cfg.max_round is not None else 1 << 31
        while self.nround < max_round:
            if log:
                log.write(f"--------------- round {self.nround + 1} ---------\n")
            stats = self.run_round(log=log if cfg.verbose else None)
            if log:
                log.write(
                    f"seed: {stats.pattern:08x}\nseedmap size: {stats.seedmap_size}\n"
                    f"reference length: {stats.ref_len}\n#trials: {self.ntrials_total}\n"
                    f"#matches: {stats.nmatches}\n"
                )
            if metrics:
                metrics.round(stats)
            if cfg.checkpoint_path and cfg.checkpoint_every and (
                self.nround % cfg.checkpoint_every == 0
            ):
                from .checkpoint import save_checkpoint

                save_checkpoint(cfg.checkpoint_path, self)
            if self.nfailure >= len(self.patterns):
                break
            if out:
                out.write(dna.codes_to_text(self.ref.text()) + "\n")
        if cfg.checkpoint_path:
            from .checkpoint import save_checkpoint

            save_checkpoint(cfg.checkpoint_path, self)
        profile_ctx.__exit__(None, None, None)
        if metrics:
            metrics.close()
        return self.ref


def _dp_cells_estimate(la: int, lb: int, ratio: float) -> int:
    """Banded-DP cell count for one attempted alignment (perf accounting:
    len_a rows x (2*max_dst+1) band)."""
    if lb >= la:
        len_a = la
        max_dst = 1 + int(la * ratio)
    else:
        len_b = lb
        max_dst = 1 + int(lb * ratio)
        len_a = min(la, len_b + max_dst)
    return max(0, len_a) * (2 * max_dst + 1)
