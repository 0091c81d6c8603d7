"""Batch assembly engine on PyTorch (one device, one contig).

Port of pacbioassembly_tpu/assemble/batch.py. Each round is the JAX
engine's screen-then-commit round:

  1. host seedmap + candidate expansion (numpy; copied verbatim, since the
     JAX module imports jax at load time);
  2. screening: a prefilter over the first cfg.prefilter_len bases at
     cfg.prefilter_ratio, then the full screen, each launch one device
     gather (assemble/gather.py) feeding the bit-parallel kernel K1;
  3. commit: interior alignments go through the parent kernel K2, the walk
     kernel W and one scatter-add elect (consensus/elect.py); growers take
     the host C++ aligner against the current reference;
  4. host evolve (pacbioassembly_tpu/consensus/state.py, shared).

Everything the round decides is integer-identical to the JAX engine: the
same candidates, accept vectors, edit streams, vote deltas, RoundStats and
contig bytes (tests/test_torch_batch.py). The device is explicit; on a CUDA
device every screen, parent plane and walk runs as a CUDA kernel, on the
CPU as the kernels' plain versions.

Left out relative to the JAX engine: the multi-device mesh paths, the
tunnel-retry loop, the first-seen-shape flags of the launch log (PyTorch
compiles nothing per shape), the XLA traceback path (commits always take
parents + walk) and multi-contig restarts.
"""

from __future__ import annotations

import contextlib
import time
from functools import partial
from typing import Optional, TextIO

import numpy as np
import torch

from ..align.bitwave import batch_score_bitwave
from ..align.screen import ladder_size, pad_batch, size_bucket
from ..consensus.elect import elect_packed
from ..device import resolve_device
from ..host import (
    AssemblyConfig,
    ConsensusRef,
    Constants,
    MetricsLogger,
    ReadStore,
    RoundStats,
    SeedIndex,
    build_seedmap,
    dna,
    exact_align,
    init_reference,
    load_checkpoint,
    save_checkpoint,
)
from .gather import parents_and_walk

SEED_LEN = Constants.SEED_LEN

# max candidates per screening launch (bounds the launch's working set)
SCREEN_CHUNK = 4096

# max candidates per prefilter launch (tiny LB=prefilter_len shapes)
PREFILTER_CHUNK = 65536

# pairs per commit traceback launch
TB_CHUNK = 32


def _timed_launch(launch_log, kind, shape, fn):
    """Run one device launch (which ends in a host fetch), recording
    (kind, shape, seconds) into launch_log (a per-round list, or None
    outside run_round)."""
    t0 = time.perf_counter()
    out = fn()
    if launch_log is not None:
        launch_log.append({
            "kind": kind,
            "shape": list(shape),
            "s": round(time.perf_counter() - t0, 4),
        })
    return out


class CandidateBatch:
    """Structure-of-arrays candidate set — one row per (read, trial,
    direction, reference-position) screening candidate, in trial-priority
    order per read (the reference's probe order, spaced_seed.cpp:424-426,
    282-296). Arrays instead of objects: candidate counts reach 10^5-10^6
    per round at E. coli scale."""

    __slots__ = ("read", "j", "forward", "r_offset", "rank")

    def __init__(self, read, j, forward, r_offset, rank):
        self.read = np.asarray(read, dtype=np.int64)      # surviving-list row
        self.j = np.asarray(j, dtype=np.int64)            # trial number
        self.forward = np.asarray(forward, dtype=bool)
        self.r_offset = np.asarray(r_offset, dtype=np.int64)  # dir-adjusted
        self.rank = np.asarray(rank, dtype=np.int64)      # index-bucket rank

    def __len__(self) -> int:
        return len(self.read)

    @classmethod
    def empty(cls) -> "CandidateBatch":
        z = np.empty(0, np.int64)
        return cls(z, z, np.empty(0, bool), z, z)


def _gather_trial_seeds(
    buf: np.ndarray, offs: np.ndarray, pos: np.ndarray, quirk: bool
) -> np.ndarray:
    """Vectorized dna.seed_at (dna_seq.h:62-76) over an (N, T) matrix of
    base positions into the flat record buffer; rows are reads at payload
    offsets offs+4. With quirk=True, replicates the reference's aligned-pos
    bug (byte offset `pos` instead of `pos>>2`, running past the record
    into following reads' bytes; past-buffer reads are zero — the mmap
    zero page)."""
    pos = pos.astype(np.int64)
    byte0 = pos >> 2
    if quirk:
        byte0 = np.where((pos & 3) == 0, pos, byte0)
    idx = (offs[:, None] + 4 + byte0)[..., None] + np.arange(5, dtype=np.int64)
    nbuf = len(buf)
    b = np.where(
        idx < nbuf, buf[np.minimum(idx, nbuf - 1)], np.uint8(0)
    ).astype(np.uint32)
    ls = ((pos & 3) << 1).astype(np.uint32)[..., None]
    chunk = ((b[..., :4] << ls) | (b[..., 1:5] >> (8 - ls))) & 0xFF
    return (
        chunk[..., 0]
        | (chunk[..., 1] << 8)
        | (chunk[..., 2] << 16)
        | (chunk[..., 3] << 24)
    ).astype(np.uint32)


class TrialSeedCache:
    """Per-read raw trial seeds, computed once — only the pattern mask
    changes between rounds, so the whole per-round candidate discovery
    becomes (seeds & pattern) + one vectorized binary search.

    Column layout interleaves [fwd j=0, bwd j=0, fwd j=1, bwd j=1, ...] so a
    row scan in column order reproduces the reference's trial priority
    (spaced_seed.cpp:424-426)."""

    def __init__(self, reads: ReadStore, cfg: AssemblyConfig):
        T = cfg.max_trial
        N = len(reads)
        self.seeds = np.zeros((N, 2 * T), dtype=np.uint32)
        self.valid = np.zeros((N, 2 * T), dtype=bool)
        if N == 0:
            return
        slen = reads.lengths.astype(np.int64)
        offs = reads.offsets.astype(np.int64)
        jj = np.arange(T, dtype=np.int64)
        # trials per read: fwd pos j and bwd pos slen-16-j both exist for
        # j < min(T, slen-15); validity adds the segment-length floor
        # s_len = slen - j >= overlap_min (spaced_seed.cpp:271)
        nval = np.minimum(T, np.maximum(slen - SEED_LEN + 1, 0))
        col_ok = jj[None, :] < nval[:, None]
        ok = col_ok & ((slen[:, None] - jj[None, :]) >= cfg.overlap_min)

        fpos = np.broadcast_to(jj[None, :], (N, T))
        bpos = np.maximum(slen[:, None] - SEED_LEN - jj[None, :], 0)
        fs = _gather_trial_seeds(reads.buf, offs, fpos, cfg.quirk_seed_at)
        bs = _gather_trial_seeds(reads.buf, offs, bpos, cfg.quirk_seed_at)
        self.seeds[:, 0::2] = np.where(col_ok, fs, 0)
        self.seeds[:, 1::2] = np.where(col_ok, bs, 0)
        self.valid[:, 0::2] = ok
        self.valid[:, 1::2] = ok


def expand_candidates(
    reads: ReadStore,
    surviving: list[int],
    index: SeedIndex,
    pattern: int,
    cfg: AssemblyConfig,
    cache: TrialSeedCache,
) -> tuple[CandidateBatch, int, dict]:
    """All seeding trials for all surviving reads, in trial-priority order
    per read: mask the cached raw seeds, batch binary-search the index,
    then expand the hits with repeat/cumsum.

    Returns (candidates, dropped, phase_s): `dropped` counts index hits
    beyond cfg.bucket_max_candidates per (read, trial) that were not
    expanded (the reference tries every candidate in a bucket,
    spaced_seed.cpp:282-296); phase_s holds the lookup / expand timings."""
    phase_s = {"lookup_s": 0.0, "expand_rest_s": 0.0}
    if not surviving:
        return CandidateBatch.empty(), 0, phase_s
    t0 = time.perf_counter()
    cap = cfg.bucket_max_candidates
    alive = np.asarray(surviving)
    seeds = cache.seeds[alive] & np.uint32(pattern)
    valid = cache.valid[alive] & (seeds != 0)
    lo, cnt = index.lookup_batch(seeds.reshape(-1))
    cnt = cnt.reshape(seeds.shape) * valid
    lo = lo.reshape(seeds.shape)
    dropped = int(np.maximum(cnt - cap, 0).sum())
    t1 = time.perf_counter()
    phase_s["lookup_s"] = round(t1 - t0, 4)

    rows, cols = np.nonzero(cnt)  # row-major == read asc, trial-priority asc
    if len(rows) == 0:
        return CandidateBatch.empty(), dropped, phase_s
    n = np.minimum(cnt[rows, cols], cap).astype(np.int64)
    starts = lo[rows, cols].astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(n)[:-1]])
    rank = np.arange(int(n.sum()), dtype=np.int64) - np.repeat(cum, n)
    read_rep = np.repeat(rows, n)
    col_rep = np.repeat(cols, n)
    forward = (col_rep & 1) == 0
    j = col_rep >> 1
    r_offset = index.positions[np.repeat(starts, n) + rank].astype(np.int64)
    r_offset = r_offset + np.where(forward, 0, SEED_LEN - 1)

    if cfg.dedupe_diagonals and len(read_rep):
        # probes (j, r) and (j+k, r+k) of one read target the same overlap
        # diagonal; keep only the first (= highest trial priority, the one
        # the reference would commit, spaced_seed.cpp:424-439)
        diag = np.where(forward, r_offset - j, r_offset + j)
        # int64 key layout: read (28 bits) | diag + 2^33 (34 bits) | fwd
        key = (read_rep << 35) | ((diag + (1 << 33)) << 1) | forward
        _, first = np.unique(key, return_index=True)
        keep = np.sort(first)
        read_rep, j, forward = read_rep[keep], j[keep], forward[keep]
        r_offset, rank = r_offset[keep], rank[keep]

    phase_s["expand_rest_s"] = round(time.perf_counter() - t1, 4)
    return CandidateBatch(read_rep, j, forward, r_offset, rank), dropped, phase_s


@contextlib.contextmanager
def _profiled(trace_dir: Optional[str]):
    """torch.profiler trace of the run into trace_dir (no-op when None)."""
    if not trace_dir:
        yield
        return
    import os

    os.makedirs(trace_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


class BatchAssembler:
    def __init__(
        self,
        cfg: AssemblyConfig,
        reads: ReadStore,
        patterns: list[int],
        dump: Optional[TextIO] = None,
        device: str | torch.device = "cuda",
    ):
        if not patterns:
            raise ValueError("no seed patterns")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.reads = reads
        self.patterns = patterns
        self.rng = np.random.default_rng(cfg.rng_seed)
        self.surviving = list(range(len(reads)))
        self.ref = init_reference(cfg, reads, self.rng, candidates=self.surviving)
        self.dump = dump
        self.nfailure = 0
        self.nround = 0
        self.retreats = 0
        self.fruitless_retreats = 0
        self.matches_since_retreat = 0
        self.dp_cells_total = 0
        self.history: list[RoundStats] = []
        self.launch_log: Optional[list] = None
        self.phase_s: dict = {}
        self._aligner = partial(exact_align, ratio=cfg.ratio)
        # the trial-seed cache and the device read matrix depend only on
        # the read set
        self._trial_cache = TrialSeedCache(reads, cfg)
        self._device_builder = None  # lazy (assemble/gather.py)

    def _pick_pattern(self) -> int:
        if self.nfailure != 0:
            return self.patterns[self.nfailure - 1]
        if self.cfg.pattern_schedule == "roundrobin":
            return self.patterns[(self.nround - 1) % len(self.patterns)]
        return self.patterns[int(self.rng.integers(0, len(self.patterns)))]

    # ------------------------------------------------------------ phase A

    def _geometry(self, cands: CandidateBatch):
        """Per-candidate segment/reference lengths vs the round-start ref
        (vectorized; fwd segment = read[j:], bwd = read[:slen-j] reversed)."""
        ref = self.ref
        alive = np.asarray(self.surviving, dtype=np.int64)
        slen = self.reads.lengths[alive[cands.read]].astype(np.int64)
        seg_len = slen - cands.j
        p = ref.beg + cands.r_offset
        ref_len = np.where(cands.forward, ref.post - p, p - ref.pre + 1)
        return seg_len, ref_len

    def _materialize(self, cands, idxs, seg_len, ref_len, LB, LA):
        """Pack candidate (ref, seg) code matrices on the host (the path
        for read sets too large for the device matrix)."""
        ref = self.ref
        B = len(idxs)
        a_mat = np.zeros((B, LA), dtype=np.uint8)
        b_mat = np.zeros((B, LB), dtype=np.uint8)
        la = np.zeros(B, dtype=np.int32)
        lb = np.zeros(B, dtype=np.int32)
        for bi, n in enumerate(idxs):
            cj = int(cands.j[n])
            fwd = bool(cands.forward[n])
            i = self.surviving[int(cands.read[n])]
            codes = self.reads.codes(i)
            if fwd:
                seg = codes[cj:]
            else:
                seg = codes[: len(codes) - cj][::-1]
            p = ref.beg + int(cands.r_offset[n])
            need = min(int(ref_len[n]), LA)
            if fwd:
                a = ref.buf[p : p + need]
            else:
                a = ref.buf[p - need + 1 : p + 1][::-1]
            a_mat[bi, : len(a)] = a
            b_mat[bi, : len(seg)] = seg
            la[bi] = ref_len[n]
            lb[bi] = len(seg)
        la = np.minimum(la, LA).astype(np.int32)
        return a_mat, la, b_mat, lb

    def _host_batch(self, cands, idxs, seg_len, ref_len, LB, LA, pad_to=None):
        """Host-packed batch, padded (pad rows la=lb=1) and uploaded."""
        a_mat, la, b_mat, lb = self._materialize(cands, idxs, seg_len, ref_len, LB, LA)
        quantum = pad_to or 64
        (a_mat, b_mat), la, lb, _ = pad_batch(
            [a_mat, b_mat], la, lb, quantum, ladder=pad_to is None
        )
        dev = self.device
        return (
            torch.from_numpy(a_mat).to(dev), torch.from_numpy(la.astype(np.int32)).to(dev),
            torch.from_numpy(b_mat).to(dev), torch.from_numpy(lb.astype(np.int32)).to(dev),
        )

    def _win_ladder(self) -> int:
        """Padded device-window length (assemble/gather.py window ladder)."""
        return ladder_size(max(self.ref.post - self.ref.pre, 1), 8192)

    def _builder(self):
        """The device batch builder, or None when the host path must be
        used (disabled, or reads too large for a dense device matrix)."""
        if not self.cfg.device_materialize:
            return None
        if self._device_builder is None:
            from .gather import DeviceBatchBuilder

            self._device_builder = DeviceBatchBuilder(self.reads, self.cfg, self.device)
        return self._device_builder if self._device_builder.ok else None

    def _device_vectors(self, cands, idxs, ref_len, LA, pad_to):
        """Host-side int vectors describing a candidate batch for the
        device gather. Pad rows carry la=lb=1 (cheap in-kernel rejects)."""
        ref = self.ref
        B0 = len(idxs)
        read_row = np.zeros(pad_to, np.int32)
        jv = np.full(pad_to, int(self.reads.lengths[0]) - 1, np.int32)  # pad: lb=1
        fwd = np.ones(pad_to, bool)
        prel = np.zeros(pad_to, np.int32)
        la = np.ones(pad_to, np.int32)  # pad: la=1
        alive = np.asarray(self.surviving, dtype=np.int64)
        sel = np.asarray(idxs, dtype=np.int64)
        read_row[:B0] = alive[cands.read[sel]]
        jv[:B0] = cands.j[sel]
        fwd[:B0] = cands.forward[sel]
        prel[:B0] = ref.beg + cands.r_offset[sel] - ref.pre
        la[:B0] = np.minimum(ref_len[sel], LA)
        return read_row, jv, fwd, prel, la

    def _prefilter(self, cands: CandidateBatch, ref_len: np.ndarray) -> np.ndarray:
        """Cheap device pass: banded DP over only the first
        cfg.prefilter_len bases of each candidate at the looser
        cfg.prefilter_ratio. Returns a bool keep mask; candidates it
        rejects are treated as failed trials."""
        cfg = self.cfg
        LBp = cfg.prefilter_len
        # band sized by the PREFILTER ratio (the goal cells derive from it)
        Wp = 1 + int(LBp * cfg.prefilter_ratio)
        LAp = LBp + Wp + 1
        keep = np.zeros(len(cands), dtype=bool)
        builder = self._builder()
        all_idx = np.arange(len(cands))
        for lo in range(0, len(cands), PREFILTER_CHUNK):
            idxs = all_idx[lo : lo + PREFILTER_CHUNK]
            Bp = ladder_size(len(idxs))
            vecs = self._device_vectors(cands, idxs, ref_len, LAp, Bp)
            packed = _timed_launch(
                self.launch_log, "pf", (Bp, LAp, LBp, Wp, self._win_ladder()),
                lambda: builder.score(
                    self.ref, *vecs, LA=LAp, LB=LBp, w_max=Wp,
                    ratio=cfg.prefilter_ratio, kind="prefilter",
                ),
            )
            keep[idxs] = packed[: len(idxs), 0] != 0
            rows = packed[: len(idxs), 2].astype(np.int64)
            md = 1 + int(LBp * cfg.prefilter_ratio)
            self.dp_cells_total += int((rows * (2 * md + 1)).sum())
        return keep

    def screen(self, cands: CandidateBatch) -> np.ndarray:
        """Device-score all candidates vs the round-start reference.
        Returns a bool accept vector aligned with `cands`."""
        cfg = self.cfg
        self.prefilter_kept = -1  # -1 = pass not run
        accept = np.zeros(len(cands), dtype=bool)
        # per-candidate goal cells from screening (the traceback walk
        # starts from these)
        self._scr_ma = np.zeros(len(cands), dtype=np.int64)
        self._scr_mb = np.zeros(len(cands), dtype=np.int64)
        self.screen_phase_s = {"prefilter_s": 0.0, "fullscreen_s": 0.0, "fullscreen_n": 0}
        if len(cands) == 0:
            self._seg_len = self._ref_len = np.zeros(0, np.int64)
            return accept

        seg_len, ref_len = self._geometry(cands)
        self._seg_len, self._ref_len = seg_len, ref_len

        # longest segments first, in bounded launches each sized by its
        # own largest candidate
        idxs_all = np.argsort(-seg_len, kind="stable")
        longest = int(seg_len[idxs_all[0]])
        if longest > size_bucket(longest, cfg.ratio)[0]:
            raise ValueError(f"segment length {longest} exceeds max bucket")
        builder = self._builder()
        t_pf0 = time.perf_counter()
        if (
            cfg.prefilter_len
            and builder is not None
            and len(idxs_all) >= cfg.prefilter_min_batch
        ):
            keep = self._prefilter(cands, ref_len)
            idxs_all = idxs_all[keep[idxs_all]]
            self.prefilter_kept = int(keep.sum())
        self.screen_phase_s = {"prefilter_s": round(time.perf_counter() - t_pf0, 4)}
        for lo in range(0, len(idxs_all), SCREEN_CHUNK):
            idxs = idxs_all[lo : lo + SCREEN_CHUNK]
            LB, LA, W = size_bucket(int(seg_len[idxs[0]]), cfg.ratio)
            Bp = ladder_size(len(idxs))
            if builder is not None:
                vecs = self._device_vectors(cands, idxs, ref_len, LA, Bp)
                packed = _timed_launch(
                    self.launch_log, "fs", (Bp, LA, LB, W, self._win_ladder()),
                    lambda: builder.score(
                        self.ref, *vecs, LA=LA, LB=LB, w_max=W,
                        ratio=cfg.ratio, kind="fullscreen",
                    ),
                )
                acc = packed[:, 0] != 0
                ma, rows_all, mb = packed[:, 1], packed[:, 2], packed[:, 3]
            else:
                def host_score():
                    a, la, b, lb = self._host_batch(cands, idxs, seg_len, ref_len, LB, LA)
                    res = batch_score_bitwave(a, la, b, lb, la_max=LA, w_max=W, ratio=cfg.ratio)
                    return [x.cpu().numpy() for x in res]

                acc, _, ma, mb, _, rows_all = _timed_launch(
                    self.launch_log, "fs_host", (Bp, LA, LB, W), host_score
                )
            ok = acc & (ma >= cfg.overlap_min)
            accept[idxs] = ok[: len(idxs)]
            self._scr_ma[idxs] = ma[: len(idxs)]
            self._scr_mb[idxs] = mb[: len(idxs)]
            # per-pair reference-equivalent cells: rows x (2*max_dst + 1)
            # with the pair's own band (seq_aligner.h:151-190)
            rows = rows_all[: len(idxs)].astype(np.int64)
            la_used = np.minimum(ref_len[idxs], LA).astype(np.float64)
            lb_used = seg_len[idxs].astype(np.float64)
            md = 1 + np.floor(np.minimum(la_used, lb_used) * cfg.ratio).astype(np.int64)
            self.dp_cells_total += int((rows * (2 * md + 1)).sum())
        self.screen_phase_s["fullscreen_s"] = round(
            time.perf_counter() - t_pf0 - self.screen_phase_s["prefilter_s"], 4
        )
        self.screen_phase_s["fullscreen_n"] = int(len(idxs_all))
        return accept

    # ------------------------------------------------------------ phase B

    def commit(self, cands: CandidateBatch, accept: np.ndarray) -> int:
        """Commit each read's first accepted candidate, in read order.

        Alignments whose round-start DP did not consume the reference to
        its end (matlen_a < ref_len) vote from the device traceback (parent
        kernel + walk), all streams merged in one elect: votes are
        commutative integer sums. Growth is never lost by this split (a
        round-start non-consumer can only be farther from consuming a
        grown reference). Growers (ma == ref_len) and traceback misses take
        the exact sequential try_align against the CURRENT reference. The
        same round-start-snapshot deviation from a fully sequential walk as
        the JAX engine (its commit() docstring). Returns the number of
        consumed reads."""
        self.commit_phase_s = {
            "tb_s": 0.0, "host_commit_s": 0.0, "elect_s": 0.0,
            "host_aligns": 0, "device_commits": 0,
        }
        acc_idx = np.nonzero(accept)[0]
        if len(acc_idx) == 0:
            return 0
        by_read: dict[int, list[int]] = {}
        for n in acc_idx.tolist():
            by_read.setdefault(int(cands.read[n]), []).append(n)

        seg_len, ref_len = self._seg_len, self._ref_len
        chosen = {ridx: ns[0] for ridx, ns in by_read.items()}

        t_tb0 = time.perf_counter()
        tb = {}
        # locked mode (-l) freezes all voting and growth (ref_seq.h:259-266):
        # everything goes through the host try_align, which respects it
        if self.cfg.device_traceback and not self.ref.locked:
            # growers are decided by the round-start goal cell already
            # recorded by screen(); they skip the traceback
            eligible = [
                n for n in chosen.values()
                if self._scr_ma[n] < int(ref_len[n])
            ]
            if eligible:
                tb = self._traceback_batch(cands, eligible, seg_len, ref_len)
        t_tb1 = time.perf_counter()

        # phase-start window snapshot: every interior vote lands inside
        # [pre0, post0) and growth only writes rows outside it, so the
        # batched elect commutes with the sequential boundary commits
        pre0, post0 = self.ref.pre, self.ref.post
        pending: list[tuple[int, np.ndarray, np.ndarray]] = []

        consumed = []
        host_work = []  # (ridx, candidate rows) for the sequential path
        for ridx in sorted(by_read):
            n0 = chosen[ridx]
            if n0 in tb and tb[n0][2] < int(ref_len[n0]):
                ops, vals, matlen_a, matlen_b = tb[n0]
                cj = int(cands.j[n0])
                fwd = bool(cands.forward[n0])
                pending.append((n0, ops, vals))
                if self.dump is not None:
                    codes = self.reads.codes(self.surviving[ridx])
                    seg = codes[cj:] if fwd else codes[: len(codes) - cj][::-1]
                    ref_codes = self.ref.accessor(int(cands.r_offset[n0]), fwd)[:matlen_a]
                    self.dump.write(dna.codes_to_text(ref_codes) + "\n")
                    self.dump.write(dna.codes_to_text(seg[:matlen_b]) + "\n")
                consumed.append(ridx)
            else:
                host_work.append((ridx, by_read[ridx]))
        n_host_aligns, host_consumed = self._commit_host(cands, host_work)
        consumed.extend(host_consumed)
        t_host = time.perf_counter()
        if pending:
            self._apply_interior_votes(cands, pending, pre0, post0)
        t_elect = time.perf_counter()
        self.commit_phase_s = {
            "tb_s": round(t_tb1 - t_tb0, 4),
            "host_commit_s": round(t_host - t_tb1, 4),
            "elect_s": round(t_elect - t_host, 4),
            "host_aligns": n_host_aligns,
            "device_commits": len(pending),
        }
        consumed_set = set(consumed)
        self.surviving = [
            i for r, i in enumerate(self.surviving) if r not in consumed_set
        ]
        return len(consumed)

    def _commit_host(self, cands: CandidateBatch, work):
        """Sequential try_align commits for `work` [(ridx, candidate
        rows)], in read order. Returns (native align count, consumed ridx
        list). (The JAX engine's optional two-thread boundary split,
        cfg.parallel_commit, is not ported; it is off by default.)"""
        nal = 0
        cons = []
        for ridx, ns in work:
            codes = self.reads.decode(self.surviving[ridx])
            for n in ns:
                cj = int(cands.j[n])
                fwd = bool(cands.forward[n])
                seg = codes[cj:] if fwd else codes[: len(codes) - cj][::-1]
                nal += 1
                res = self.ref.try_align(self._aligner, int(cands.r_offset[n]), seg, fwd)
                if res is not None:
                    if self.dump is not None:
                        ref_codes = self.ref.accessor(int(cands.r_offset[n]), fwd)[
                            : res.matlen_a
                        ]
                        self.dump.write(dna.codes_to_text(ref_codes) + "\n")
                        self.dump.write(dna.codes_to_text(seg[: res.matlen_b]) + "\n")
                    cons.append(ridx)
                    break
        return nal, cons

    def _apply_interior_votes(
        self,
        cands: CandidateBatch,
        pending: list[tuple[int, np.ndarray, np.ndarray]],
        pre0: int,
        post0: int,
    ) -> None:
        """Merge all interior edit streams through the device elect, in
        touched-region clusters (alignments sit near the two reference
        boundaries) so the delta and its fetch scale with the touched span,
        not the contig length."""
        ref = self.ref
        # touched interval per stream (elect walks from start: forward
        # ascends, backward descends; INSERTs touch start-1 when forward)
        starts = np.array(
            [ref.beg + int(cands.r_offset[n]) - pre0 for n, _, _ in pending],
            dtype=np.int64,
        )
        fwds = np.array([bool(cands.forward[n]) for n, _, _ in pending])
        nedits = np.array([len(ops) for _, ops, _ in pending], dtype=np.int64)
        lo_i = np.where(fwds, starts - 1, starts - nedits)
        hi_i = np.where(fwds, starts + nedits, starts + 1)

        # greedy interval clustering (sorted by lo, gap <= 4096 merges),
        # then merge smallest gaps until at most 4 clusters remain
        order = np.argsort(lo_i, kind="stable")
        clusters: list[list[int]] = []
        bounds: list[list[int]] = []
        for idx in order.tolist():
            if clusters and lo_i[idx] <= bounds[-1][1] + 4096:
                clusters[-1].append(idx)
                bounds[-1][1] = max(bounds[-1][1], int(hi_i[idx]))
            else:
                clusters.append([idx])
                bounds.append([int(lo_i[idx]), int(hi_i[idx])])
        while len(clusters) > 4:
            gaps = [
                bounds[k + 1][0] - bounds[k][1] for k in range(len(clusters) - 1)
            ]
            k = int(np.argmin(gaps))
            clusters[k] += clusters.pop(k + 1)
            b = bounds.pop(k + 1)
            bounds[k][1] = max(bounds[k][1], b[1])

        L = post0 - pre0
        dev = self.device
        for members, (clo, chi) in zip(clusters, bounds):
            base = max(0, clo)
            span = min(chi, L) - base + 1
            Lc = ladder_size(span, 8192)
            N = len(members)
            E = int(max(nedits[m] for m in members))
            ops_m = np.zeros((N, max(E, 1)), dtype=np.uint8)
            vals_m = np.zeros((N, max(E, 1)), dtype=np.uint8)
            start = np.zeros(N, dtype=np.int32)
            fwd = np.zeros(N, dtype=bool)
            for row, m in enumerate(members):
                _, ops, vals = pending[m]
                ops_m[row, : len(ops)] = ops
                vals_m[row, : len(vals)] = vals
                start[row] = starts[m] - base
                fwd[row] = fwds[m]

            def elect():
                delta = elect_packed(
                    torch.from_numpy(ops_m).to(dev),
                    torch.from_numpy(vals_m).to(dev),
                    torch.from_numpy(start).to(dev),
                    torch.from_numpy(fwd).to(dev),
                    torch.ones(N, dtype=torch.bool, device=dev),
                    Lc,
                )
                return delta.cpu().numpy()

            packed = _timed_launch(self.launch_log, "elect", (Lc, N, E), elect)
            w = min(span, L - base)
            o = pre0 + base
            ref.sel[o : o + w] += packed[:w, 0:4]
            ref.sup[o : o + w] += packed[:w, 4:8]
            ref.total[o : o + w] += packed[:w, 8]
            ref.mark_dirty(o, o + w)  # incremental-evolve provenance
        ref.version += 1

    def _traceback_batch(self, cands, idxs, seg_len, ref_len):
        """Device traceback for the chosen interior candidates: the parent
        kernel and the walk, started from the screening pass's goal cells.
        Returns {candidate index: (ops, vals, matlen_a, matlen_b)}."""
        cfg = self.cfg
        LB, LA, W = size_bucket(int(max(seg_len[n] for n in idxs)), cfg.ratio)
        out = {}
        builder = self._builder()
        for lo in range(0, len(idxs), TB_CHUNK):
            part = idxs[lo : lo + TB_CHUNK]
            # bound the plane's rows by this chunk's real max length,
            # rounded to a multiple of 512 (len_a <= la = min(ref_len, LA))
            la_bound = int(np.minimum(ref_len[part], LA).max())
            rows = min(LA, -(-la_bound // 512) * 512)
            rows_pk = -(-rows // 128) * 128
            E = rows_pk + W + 2 + 32
            sel = np.asarray(part, dtype=np.int64)
            ma_p = np.zeros(TB_CHUNK, np.int32)
            mb_p = np.zeros(TB_CHUNK, np.int32)
            acc_p = np.zeros(TB_CHUNK, bool)
            ma_p[: len(part)] = self._scr_ma[sel]
            mb_p[: len(part)] = self._scr_mb[sel]
            acc_p[: len(part)] = True
            if builder is not None:
                vecs = self._device_vectors(cands, part, ref_len, LA, TB_CHUNK)

                def launch():
                    return builder.traceback_parents(
                        self.ref, *vecs, ma_p, mb_p, acc_p,
                        LA=LA, LB=LB, w_max=W, ratio=cfg.ratio,
                        rows_max=rows_pk, e_max=E,
                    )
            else:
                def launch():
                    a, la, b, lb = self._host_batch(
                        cands, part, seg_len, ref_len, LB, LA, pad_to=TB_CHUNK
                    )
                    g = torch.from_numpy(np.stack([ma_p, mb_p, acc_p]).astype(np.int32))
                    g = g.to(self.device)
                    return parents_and_walk(
                        a, la, b, lb, g[0], g[1], g[2] != 0,
                        LA=LA, w_max=W, ratio=cfg.ratio, rows_max=rows_pk, e_max=E,
                    )

            ov, ne = _timed_launch(
                self.launch_log, "tbp",
                (TB_CHUNK, LA, LB, W, rows_pk, E, self._win_ladder()), launch,
            )
            ops, vals = ov[:, :E], ov[:, E:]
            for bi, n in enumerate(part):
                out[n] = (ops[bi, : ne[bi]], vals[bi, : ne[bi]], int(ma_p[bi]), int(mb_p[bi]))
        return out

    # ------------------------------------------------------------ rounds

    def run_round(self, log: Optional[TextIO] = None) -> RoundStats:
        self.nround += 1
        self.launch_log = []  # per-launch (kind, shape, s) this round
        cells_before = self.dp_cells_total
        pattern = self._pick_pattern()
        t0 = time.perf_counter()
        index, n_indexed = build_seedmap(self.ref.text(), pattern)
        t1 = time.perf_counter()
        cands, dropped, expand_s = expand_candidates(
            self.reads, self.surviving, index, pattern, self.cfg, self._trial_cache
        )
        t2 = time.perf_counter()
        accept = self.screen(cands)
        t3 = time.perf_counter()
        nmatches = self.commit(cands, accept)
        t4 = time.perf_counter()

        if nmatches != 0:
            self.nfailure = 0
        else:
            self.nfailure += 1
        if self.nfailure < len(self.patterns):
            self.ref.evolve()
        t5 = time.perf_counter()
        ll = self.launch_log
        slow = max(ll, key=lambda e: e["s"]) if ll else None
        self.phase_s = {
            "seedmap_s": round(t1 - t0, 4),
            "expand_s": round(t2 - t1, 4),
            "screen_s": round(t3 - t2, 4),
            "commit_s": round(t4 - t3, 4),
            "evolve_s": round(t5 - t4, 4),
            "retreats": self.retreats,
            "prefilter_kept": self.prefilter_kept,
            "launches": len(ll),
            **(
                {
                    "slow_launch_kind": slow["kind"],
                    "slow_launch_s": slow["s"],
                    "slow_launch_shape": slow["shape"],
                }
                if slow
                else {}
            ),
            **expand_s,
            **self.screen_phase_s,
            **self.commit_phase_s,
        }

        stats = RoundStats(
            nround=self.nround,
            pattern=pattern,
            seedmap_size=n_indexed,
            ref_len=self.ref.length(),
            nmatches=nmatches,
            ntrials=len(cands),
            nreads_left=len(self.surviving),
            dp_cells=self.dp_cells_total - cells_before,
            dropped_candidates=dropped,
        )
        self.history.append(stats)
        return stats

    def run(self, out=None, log=None) -> ConsensusRef:
        cfg = self.cfg
        metrics = None
        if cfg.metrics_path:
            import os

            metrics = MetricsLogger(path=cfg.metrics_path)
            # segment marker: the metrics file is append-mode
            metrics.event("run_start", resume=bool(cfg.resume_path), pid=os.getpid())
        if cfg.resume_path:
            load_checkpoint(cfg.resume_path, self)
        max_round = cfg.max_round if cfg.max_round is not None else 1 << 31
        with _profiled(cfg.profile_dir):
            while self.nround < max_round:
                if self._run_one(out, log, metrics):
                    break
        if cfg.checkpoint_path:
            save_checkpoint(cfg.checkpoint_path, self)
        if metrics:
            metrics.close()
        return self.ref

    def _run_one(self, out, log, metrics) -> bool:
        """One round plus its bookkeeping; returns True when the run stops."""
        cfg = self.cfg
        stats = self.run_round(log=log)
        self.matches_since_retreat += stats.nmatches
        if log:
            drop = (
                f" dropped_candidates={stats.dropped_candidates}"
                if stats.dropped_candidates
                else ""
            )
            log.write(
                f"--- batch round {stats.nround}: matches={stats.nmatches} "
                f"ref_len={stats.ref_len} candidates={stats.ntrials} "
                f"reads_left={stats.nreads_left}{drop}\n"
            )
        if metrics:
            metrics.round(stats, extra=self.phase_s)
        stop = False
        if self.nfailure >= len(self.patterns):
            # every pattern failed in a row: the reference terminates here;
            # with edge_retreat budget left, resample the stalled edge
            # instead (AssemblyConfig.edge_retreat). Runs before the
            # per-round checkpoint so a resume replays the same trajectory.
            give_up = (
                cfg.edge_retreat_fruitless
                and self.fruitless_retreats >= cfg.edge_retreat_fruitless
            )
            trimmed = 0
            if (
                not give_up
                and self.retreats < cfg.edge_retreat
                and self.ref.length() >= cfg.edge_retreat_min_len
            ):
                trimmed = self.ref.retreat_edges(
                    cfg.edge_retreat_min_total, keep_min=cfg.overlap_min
                )
                if trimmed == 0 and cfg.edge_retreat_bite:
                    trimmed = self.ref.retreat_fixed(
                        cfg.edge_retreat_bite, keep_min=cfg.overlap_min
                    )
            if trimmed != 0:
                self.fruitless_retreats = (
                    self.fruitless_retreats + 1
                    if self.matches_since_retreat == 0 and self.retreats > 0
                    else 0
                )
                self.matches_since_retreat = 0
            if trimmed == 0:
                stop = True
            else:
                self.retreats += 1
                self.nfailure = 0
                if log:
                    log.write(
                        f"--- edge retreat {self.retreats}: trimmed {trimmed} "
                        f"low-support cells, ref_len={self.ref.length()}\n"
                    )
        if cfg.checkpoint_path and cfg.checkpoint_every and (
            self.nround % cfg.checkpoint_every == 0
        ):
            save_checkpoint(cfg.checkpoint_path, self)
        if stop:
            return True
        if out:
            out.write(dna.codes_to_text(self.ref.text()) + "\n")
        return False
