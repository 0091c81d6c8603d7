"""Batch assembly engine on PyTorch (one device, one contig).

Port of pacbioassembly_tpu/assemble/batch.py. Each round is the JAX
engine's screen-then-commit round:

  1. host seedmap, then candidate expansion: numpy (copied verbatim, since
     the JAX module imports jax at load time) on the CPU, torch ops over a
     device copy of the trial-seed cache on a CUDA device;
  2. screening: a prefilter over the first cfg.prefilter_len bases at
     cfg.prefilter_ratio, then the full screen, each launch one device
     gather (assemble/gather.py) feeding the chosen screening kernel: the
     bit-parallel K1 (default) or the row-DP K3 (`screen_kernel`);
  3. commit: interior alignments go through the parent kernel K2, the walk
     kernel W and one scatter-add elect (consensus/elect.py); growers take
     the host C++ aligner against the current reference;
  4. host evolve (consensus/state.py).

Everything the round decides is integer-identical to the JAX engine: the
same candidates, accept vectors, edit streams, vote deltas, RoundStats and
contig bytes (tests/test_torch_batch.py). The device is explicit; on a CUDA
device every screen, parent plane and walk runs as a CUDA kernel, on the
CPU as the kernels' plain versions.

Multi-contig assembly (`assemble_contigs`) restarts the engine on the
surviving reads, as the JAX engine's does, on one shard or over a mesh.

The multi-device round (`mesh=`, parallel/) is one round with the
single-device one: every full-screen launch pads its batch to
ladder_size(B, 64 n) and splits it over the mesh's n shards
(parallel/sharded.py::sharded_screen), and the elect pads its streams to
ladder_size(N, 8 n) and sums the shards' deltas (sharded_elect_packed).
The prefilter and the commit's parents + walk stay on the engine's
device, which must be the mesh's first. Without `mesh=` the mesh is the
engine's own device, one shard. The round's RoundStats equal the
single-device round's, and its contig, votes, surviving reads and matches
equal the JAX engine's multi-device run (tests/test_torch_mesh_engine.py;
with stall recovery, restarts and checkpoints, tests/test_torch_mesh_paths.py).

Left out relative to the JAX engine: the tunnel-retry loop, the
first-seen-shape flags of the launch log (PyTorch compiles nothing per
shape), and the multi-device round's other path: the JAX engine takes
len(jax.devices()) > 1 shards by default and then skips the prefilter and
the fused gather, packs screening launches on the host and re-runs commit
chunks through align/traceback.py. The decisions are the same either way.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Optional, TextIO

import numpy as np
import torch

from ..align import exact_align
from ..align.screen import SCREEN_KERNELS, ladder_size, pad_batch, score_batch, size_bucket
from ..codec import dna
from ..config import AssemblyConfig, Constants
from ..consensus import ConsensusRef
from ..device import resolve_device
from ..index import SeedIndex, build_seedmap
from ..index.device import device_index, device_lookup
from ..parallel import Mesh, make_mesh
from ..parallel.sharded import sharded_elect_packed, sharded_screen
from ..utils import MetricsLogger, profiled, span
from .checkpoint import load_checkpoint, save_checkpoint
from .driver import RoundStats, init_reference
from .gather import parents_and_walk
from .reads import ReadStore

SEED_LEN = Constants.SEED_LEN

# max candidates per screening launch (bounds the launch's working set)
SCREEN_CHUNK = 4096

# max candidates per prefilter launch (tiny LB=prefilter_len shapes)
PREFILTER_CHUNK = 65536

# pairs per commit traceback launch
TB_CHUNK = 32


def _launch(launch_log, kind, shape, fn):
    """Run one device launch (which ends in a host fetch) in the span
    launch.<kind>, with its preparation and fetch. Notes (kind, shape) in
    launch_log (a per-round list, or None outside run_round)."""
    with span("launch." + kind):
        out = fn()
    if launch_log is not None:
        launch_log.append({"kind": kind, "shape": list(shape)})
    return out


def _align(a, b, *, ratio):
    """One call of the host aligner, in the span round.commit.host.align."""
    with span("round.commit.host.align"):
        return exact_align(a, b, ratio=ratio)


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
    (spaced_seed.cpp:424-426).

    `on(device)` is the cache on a device, uploaded once per device and
    kept with the cache, so the engines that share a cache (multi-contig
    restarts, the mesh engine) share its device copy."""

    def __init__(self, reads: ReadStore, cfg: AssemblyConfig):
        T = cfg.max_trial
        N = len(reads)
        self.seeds = np.zeros((N, 2 * T), dtype=np.uint32)
        self.valid = np.zeros((N, 2 * T), dtype=bool)
        self._copies: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}
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

    def on(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """(seeds as int64, valid) on `device`."""
        copy = self._copies.get(device)
        if copy is None:
            copy = self._copies[device] = self._upload(device)
        return copy

    def _upload(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        return (torch.from_numpy(self.seeds.astype(np.int64)).to(device),
                torch.from_numpy(self.valid).to(device))


def expand_candidates(
    reads: ReadStore,
    surviving: list[int],
    index: SeedIndex,
    pattern: int,
    cfg: AssemblyConfig,
    cache: TrialSeedCache,
    *,
    device: Optional[torch.device] = None,
) -> tuple[CandidateBatch, int, dict]:
    """All seeding trials for all surviving reads, in trial-priority order
    per read: mask the cached raw seeds, batch binary-search the index,
    then expand the hits with repeat/cumsum.

    Returns (candidates, dropped, phase_s): `dropped` counts index hits
    beyond cfg.bucket_max_candidates per (read, trial) that were not
    expanded (the reference tries every candidate in a bucket,
    spaced_seed.cpp:282-296); phase_s holds the lookup / expand timings:
    the spans round.expand.lookup (the cached seeds' gather and mask,
    round.expand.seeds, then the index probe, round.expand.probe) and
    round.expand.hits, and `expand_device`: 1 when the expansion ran on
    the card, 0 here.

    On a CUDA `device` the same steps run there (_expand_on_device), over
    the cache's device copy; the candidates come back as numpy arrays."""
    if device is not None and device.type == "cuda":
        return _expand_on_device(surviving, index, pattern, cfg, cache, device)
    phase_s = {"lookup_s": 0.0, "expand_rest_s": 0.0, "expand_device": 0}
    if not surviving:
        return CandidateBatch.empty(), 0, phase_s
    with span("round.expand.lookup") as lookup:
        cap = cfg.bucket_max_candidates
        with span("round.expand.seeds"):
            alive = np.asarray(surviving)
            seeds = cache.seeds[alive] & np.uint32(pattern)
            valid = cache.valid[alive] & (seeds != 0)
        with span("round.expand.probe"):
            lo, cnt = index.lookup_batch(seeds.reshape(-1))
        cnt = cnt.reshape(seeds.shape) * valid
        lo = lo.reshape(seeds.shape)
        dropped = int(np.maximum(cnt - cap, 0).sum())
    phase_s["lookup_s"] = round(lookup.s, 4)
    with span("round.expand.hits") as hits:
        cands = _expand_hits(index, cnt, lo, cap, cfg)
    if len(cands):
        phase_s["expand_rest_s"] = round(hits.s, 4)
    return cands, dropped, phase_s


def _expand_hits(index: SeedIndex, cnt, lo, cap: int, cfg: AssemblyConfig) -> CandidateBatch:
    """The index hits of every (read, trial) as candidates: expand_candidates'
    second half."""
    rows, cols = np.nonzero(cnt)  # row-major == read asc, trial-priority asc
    if len(rows) == 0:
        return CandidateBatch.empty()
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
    return CandidateBatch(read_rep, j, forward, r_offset, rank)


def _sync(device: torch.device) -> None:
    """Wait for the device's work, so that a span ends after it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _expand_on_device(
    surviving: list[int],
    index: SeedIndex,
    pattern: int,
    cfg: AssemblyConfig,
    cache: TrialSeedCache,
    device: torch.device,
) -> tuple[CandidateBatch, int, dict]:
    """expand_candidates in torch ops on `device`: the same candidates, in
    the same order, the same `dropped` and the same spans, each ending at
    a sync after its device work (the last two at `dropped`'s read and the
    candidates' fetch). The host index's sorted keys and positions are
    uploaded each round (at most 2 MAX_READ_LEN entries)."""
    phase_s = {"lookup_s": 0.0, "expand_rest_s": 0.0, "expand_device": 1}
    if not surviving:
        return CandidateBatch.empty(), 0, phase_s
    with span("round.expand.lookup") as lookup:
        cap = cfg.bucket_max_candidates
        with span("round.expand.seeds"):
            all_seeds, all_valid = cache.on(device)
            alive = torch.from_numpy(np.asarray(surviving, np.int64)).to(device)
            seeds = all_seeds[alive] & pattern
            valid = all_valid[alive] & (seeds != 0)
            _sync(device)
        with span("round.expand.probe"):
            dindex = device_index(index, device)
            lo, cnt = device_lookup(dindex, seeds)
            _sync(device)
        cnt = cnt * valid
        dropped = int((cnt - cap).clamp_(min=0).sum().item())
    phase_s["lookup_s"] = round(lookup.s, 4)
    with span("round.expand.hits") as hits:
        cands = _expand_hits_on_device(dindex.positions, cnt, lo, cap, cfg.dedupe_diagonals)
    if len(cands):
        phase_s["expand_rest_s"] = round(hits.s, 4)
    return cands, dropped, phase_s


def _expand_hits_on_device(positions, cnt, lo, cap: int, dedupe: bool) -> CandidateBatch:
    """_expand_hits in torch ops; one fetch of the candidates."""
    rows, cols = torch.nonzero(cnt, as_tuple=True)  # row-major, as np.nonzero
    if len(rows) == 0:
        return CandidateBatch.empty()
    n = cnt[rows, cols].clamp(max=cap).long()
    ends = torch.cumsum(n, 0)
    total = int(ends[-1])
    hit = torch.repeat_interleave(torch.arange(len(n), device=n.device), n, output_size=total)
    rank = torch.arange(total, device=n.device) - (ends - n)[hit]
    read_rep = rows[hit]
    col_rep = cols[hit]
    forward = (col_rep & 1) == 0
    j = col_rep >> 1
    r_offset = positions[lo[rows, cols].long()[hit] + rank].long()
    r_offset = r_offset + torch.where(forward, 0, SEED_LEN - 1)
    out = torch.stack([read_rep, j, forward.long(), r_offset, rank])

    if dedupe:
        # _expand_hits' key; the first occurrence of each key in candidate
        # order (a stable sort, the first of each run), back in that order:
        # np.unique(return_index=True) then np.sort
        diag = torch.where(forward, r_offset - j, r_offset + j)
        key = (read_rep << 35) | ((diag + (1 << 33)) << 1) | forward.long()
        skey, order = torch.sort(key, stable=True)
        first = torch.ones_like(skey, dtype=torch.bool)
        first[1:] = skey[1:] != skey[:-1]
        out = out[:, torch.sort(order[first]).values]
    out = out.cpu().numpy()
    return CandidateBatch(out[0], out[1], out[2] != 0, out[3], out[4])


class BatchAssembler:
    def __init__(
        self,
        cfg: AssemblyConfig,
        reads: ReadStore,
        patterns: list[int],
        ref: Optional[ConsensusRef] = None,
        dump: Optional[TextIO] = None,
        surviving: Optional[list[int]] = None,
        trial_cache: Optional[TrialSeedCache] = None,
        device_builder=None,
        device: str | torch.device = "cuda",
        screen_kernel: str = "bitwave",
        mesh: Optional[Mesh] = None,
    ):
        if not patterns:
            raise ValueError("no seed patterns")
        if screen_kernel not in SCREEN_KERNELS:
            raise ValueError(f"unknown screening kernel {screen_kernel!r} (expected {SCREEN_KERNELS})")
        self.device = resolve_device(device)
        self.screen_kernel = screen_kernel
        # the dp mesh: one shard on the engine's device unless given. The
        # gather, the prefilter and K2 + W run on the engine's device and
        # sharded results come back to the mesh's first device: one device
        if mesh is not None and mesh.first != self.device:
            raise ValueError(f"engine on {self.device}, but {mesh} starts on {mesh.first}")
        self.mesh = mesh if mesh is not None else make_mesh(devices=[self.device])
        self.cfg = cfg
        self.reads = reads
        self.patterns = patterns
        self.rng = np.random.default_rng(cfg.rng_seed)
        self.surviving = (
            list(range(len(reads))) if surviving is None else list(surviving)
        )
        if ref is not None:
            self.ref = ref
        else:
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
        self._aligner = partial(_align, ratio=cfg.ratio)
        # the trial-seed cache and the device read matrix depend only on
        # the read set: two engines on one read set may share them
        # (multi-contig restarts do)
        self._trial_cache = trial_cache or TrialSeedCache(reads, cfg)
        self._device_builder = device_builder  # lazy (assemble/gather.py)
        if device_builder is not None and device_builder.device != self.device:
            raise ValueError(
                f"device builder on {device_builder.device}, engine on {self.device}"
            )

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

    def _host_batch(self, cands, idxs, seg_len, ref_len, LB, LA, pad_to):
        """Host-packed batch, padded to pad_to rows (pad rows la=lb=1) and
        uploaded."""
        a_mat, la, b_mat, lb = self._materialize(cands, idxs, seg_len, ref_len, LB, LA)
        (a_mat, b_mat), la, lb, _ = pad_batch([a_mat, b_mat], la, lb, pad_to, ladder=False)
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
            packed = _launch(
                self.launch_log, "pf", (Bp, LAp, LBp, Wp, self._win_ladder()),
                lambda: builder.score(
                    self.ref, *vecs, LA=LAp, LB=LBp, w_max=Wp,
                    ratio=cfg.prefilter_ratio, kind="prefilter",
                    screen_kernel=self.screen_kernel,
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
        with span("round.screen.prefilter") as prefilter:
            if (
                cfg.prefilter_len
                and builder is not None
                and len(idxs_all) >= cfg.prefilter_min_batch
            ):
                keep = self._prefilter(cands, ref_len)
                idxs_all = idxs_all[keep[idxs_all]]
                self.prefilter_kept = int(keep.sum())
        self.screen_phase_s = {"prefilter_s": round(prefilter.s, 4)}
        with span("round.screen.full") as full:
            self._full_screen(cands, idxs_all, seg_len, ref_len, builder, accept)
        self.screen_phase_s["fullscreen_s"] = round(full.s, 4)
        self.screen_phase_s["fullscreen_n"] = int(len(idxs_all))
        return accept

    def _full_screen(self, cands, idxs_all, seg_len, ref_len, builder, accept) -> None:
        """The full screen of the candidates `idxs_all` (longest first),
        in bounded launches: fills `accept` and the goal cells."""
        cfg = self.cfg
        for lo in range(0, len(idxs_all), SCREEN_CHUNK):
            idxs = idxs_all[lo : lo + SCREEN_CHUNK]
            LB, LA, W = size_bucket(int(seg_len[idxs[0]]), cfg.ratio)
            # a row a shard or more: the ladder's quantum times the shards
            Bp = ladder_size(len(idxs), 64 * self.mesh.size)
            if builder is not None:
                vecs = self._device_vectors(cands, idxs, ref_len, LA, Bp)
                kind, shape = "fs", (Bp, LA, LB, W, self._win_ladder())
            else:
                vecs = None
                kind, shape = "fs_host", (Bp, LA, LB, W)

            def launch():
                if vecs is not None:
                    batch = builder.materialize(self.ref, *vecs, LA, LB)
                else:
                    batch = self._host_batch(cands, idxs, seg_len, ref_len, LB, LA, pad_to=Bp)
                res = sharded_screen(
                    self.mesh, *batch, la_max=LA, w_max=W, ratio=cfg.ratio,
                    screen_kernel=self.screen_kernel,
                )
                # one fetch: [accept, matlen_a, dp_rows, matlen_b]
                return torch.stack(
                    [res.accept.to(torch.int32), res.matlen_a, res.dp_rows, res.matlen_b], 1
                ).cpu().numpy()

            packed = _launch(self.launch_log, kind, shape, launch)
            acc = packed[:, 0] != 0
            ma, rows_all, mb = packed[:, 1], packed[:, 2], packed[:, 3]
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

        with span("round.commit.traceback") as traceback:
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

        with span("round.commit.host") as host:
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
        with span("round.commit.elect") as elect:
            if pending:
                self._apply_interior_votes(cands, pending, pre0, post0)
        self.commit_phase_s = {
            "tb_s": round(traceback.s, 4),
            "host_commit_s": round(host.s, 4),
            "elect_s": round(elect.s, 4),
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
        rows)], in read order. Returns (native align count, consumed
        ridx list).

        When safe (cfg.parallel_commit), the two BOUNDARY REGIONS run in
        two threads: every candidate comes from the boundary-only seedmap
        (ref_seq.h:291-311 semantics), so each side's alignments touch at
        most seedmap-window + read-length cells around its own edge, and
        growth at post (pre) can only come from right(left)-side
        candidates: the sides share no state when L >= 2*reach, and
        per-side order, the carrier of the sequential-growth semantics,
        is preserved. The native DP is thread_local (pbcore.cpp g_arena)
        and ctypes releases the GIL for the C call. Reads with candidates
        in BOTH regions (repeat-spanning) commit after the join: an
        ordering deviation of the same kind as the engine's round-start
        snapshot (commit() docstring); votes commute either way. The
        partition is a pure function of the candidate set, so identical
        runs give identical results (tests/test_torch_contigs.py)."""

        def run(items):
            nal = 0
            cons = []
            for ridx, ns in items:
                codes = self.reads.decode(self.surviving[ridx])
                for n in ns:
                    cj = int(cands.j[n])
                    fwd = bool(cands.forward[n])
                    seg = codes[cj:] if fwd else codes[: len(codes) - cj][::-1]
                    nal += 1
                    res = self.ref.try_align(
                        self._aligner, int(cands.r_offset[n]), seg, fwd
                    )
                    if res is not None:
                        if self.dump is not None:
                            ref_codes = self.ref.accessor(
                                int(cands.r_offset[n]), fwd
                            )[: res.matlen_a]
                            self.dump.write(dna.codes_to_text(ref_codes) + "\n")
                            self.dump.write(
                                dna.codes_to_text(seg[: res.matlen_b]) + "\n"
                            )
                        cons.append(ridx)
                        break
            return nal, cons

        cfg = self.cfg
        L = self.ref.length()
        # disjointness bound for the two-thread split: every candidate
        # comes from the boundary-only seedmap (window = max_read_len at
        # each end, ref_seq.h:291-311) and an alignment reaches at most
        # ~read_len*(1+ratio) cells past its seed, so each side's scatter
        # region is <= `reach` cells from its own edge; the sides are
        # disjoint only when L >= 2*reach
        max_rd = int(self.reads.lengths.max()) if len(self.reads) else 0
        reach = cfg.max_read_len + int(max_rd * (1.0 + cfg.ratio)) + 64
        if (
            not cfg.parallel_commit
            or self.ref.locked
            or self.dump is not None
            or cfg.quirk_stale_dp  # stale-DP emulation is order-sensitive
            or L < 2 * reach
            or len(work) < 4
        ):
            return run(work)
        mid = L // 2
        left, right, mixed = [], [], []
        for ridx, ns in work:
            sides = {int(cands.r_offset[n]) >= mid for n in ns}
            if len(sides) == 2:
                mixed.append((ridx, ns))
            elif sides.pop():
                right.append((ridx, ns))
            else:
                left.append((ridx, ns))
        with ThreadPoolExecutor(max_workers=2) as ex:
            fut_l = ex.submit(run, left)
            fut_r = ex.submit(run, right)
            nl, cl = fut_l.result()
            nr, cr = fut_r.result()
        nm, cm = run(mixed)
        # threads' ref.version += 1 are racy read-modify-writes; one more
        # bump guarantees the post-commit version differs from any value
        # a device cache was keyed on during screening
        self.ref.version += 1
        return nl + nr + nm, sorted(cl + cr + cm)

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
        n = self.mesh.size
        for members, (clo, chi) in zip(clusters, bounds):
            base = max(0, clo)
            span = min(chi, L) - base + 1
            Lc = ladder_size(span, 8192)
            N = len(members)
            E = int(max(nedits[m] for m in members))
            # equal shards of streams, padded as the JAX engine pads
            Np, Ep = (ladder_size(N, 8 * n), ladder_size(E, 256)) if n > 1 else (N, max(E, 1))
            ops_m = np.zeros((Np, Ep), dtype=np.uint8)
            vals_m = np.zeros((Np, Ep), dtype=np.uint8)
            start = np.zeros(Np, dtype=np.int32)
            fwd = np.zeros(Np, dtype=bool)
            enabled = np.zeros(Np, dtype=bool)
            for row, m in enumerate(members):
                _, ops, vals = pending[m]
                ops_m[row, : len(ops)] = ops
                vals_m[row, : len(vals)] = vals
                start[row] = starts[m] - base
                fwd[row] = fwds[m]
                enabled[row] = True

            def elect():
                args = [torch.from_numpy(x) for x in (ops_m, vals_m, start, fwd, enabled)]
                return sharded_elect_packed(self.mesh, *args, Lc).cpu().numpy()

            packed = _launch(self.launch_log, "elect", (Lc, Np, Ep, n), elect)
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

            ov, ne = _launch(
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
        self.launch_log = []  # per-launch (kind, shape) this round
        cells_before = self.dp_cells_total
        pattern = self._pick_pattern()
        with span("round.seedmap") as seedmap:
            index, n_indexed = build_seedmap(self.ref.text(), pattern)
        with span("round.expand") as expand:
            cands, dropped, expand_s = expand_candidates(
                self.reads, self.surviving, index, pattern, self.cfg, self._trial_cache,
                device=self.device,
            )
        with span("round.screen") as screen:
            accept = self.screen(cands)
        with span("round.commit") as commit:
            nmatches = self.commit(cands, accept)

        with span("round.evolve") as evolve:
            if nmatches != 0:
                self.nfailure = 0
            else:
                self.nfailure += 1
            if self.nfailure < len(self.patterns):
                self.ref.evolve()
        self.phase_s = {
            "seedmap_s": round(seedmap.s, 4),
            "expand_s": round(expand.s, 4),
            "screen_s": round(screen.s, 4),
            "commit_s": round(commit.s, 4),
            "evolve_s": round(evolve.s, 4),
            "retreats": self.retreats,
            "prefilter_kept": self.prefilter_kept,
            "launches": len(self.launch_log),
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
        with profiled(cfg.profile_dir):
            while self.nround < max_round:
                with span("round", root=self.nround + 1):
                    stop = self._run_one(out, log, metrics)
                if stop:
                    break
        if cfg.checkpoint_path:
            save_checkpoint(cfg.checkpoint_path, self)
        if metrics:
            metrics.close()
        return self.ref

    def _run_one(self, out, log, metrics) -> bool:
        """One round plus its bookkeeping (stall recovery, the checkpoint of
        the cadence), in run()'s span `round`; returns True when the run
        stops."""
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
            with span("round.retreat"):
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


@dataclasses.dataclass
class ContigResult:
    codes: np.ndarray      # final consensus codes
    nreads: int            # reads consumed into this contig
    nrounds: int           # rounds run


def assemble_contigs(
    cfg: AssemblyConfig,
    reads: ReadStore,
    patterns: list[int],
    n_contigs: int,
    log: Optional[TextIO] = None,
    dedupe: bool = True,
    *,
    device: str | torch.device = "cuda",
    screen_kernel: str = "bitwave",
    mesh: Optional[Mesh] = None,
) -> tuple[list[ContigResult], list[int]]:
    """Multi-contig assembly: run the batch engine to termination, then
    RESTART on the surviving reads with a fresh random initial read, until
    n_contigs are produced or no reads remain.

    The reference builds one contig per process and relies on manually
    re-running with `-f` to continue (README.mkd:52-63, doc/final.tex:
    245-249 "restart from a saved sequence"); this automates that
    workflow. The trial-seed cache and the device-resident read matrix are
    shared across restarts (they depend only on the read set). With
    `dedupe` (default), contigs whose sequence is almost entirely
    contained in a larger contig (tools/postprocess.py::dedupe_contigs:
    restarts re-assembling scraps of already-covered sequence) are
    dropped from the output; their reads stay consumed. Every engine runs
    on `device` with the screening kernel `screen_kernel`, over `mesh`
    when one is given (its first local device must be `device`: the shared
    device read matrix lives there). Returns (contigs, surviving_read_rows)."""
    contigs: list[ContigResult] = []
    surviving: Optional[list[int]] = None
    cache = None
    builder = None
    for ci in range(n_contigs):
        c = dataclasses.replace(
            cfg,
            rng_seed=None if cfg.rng_seed is None else cfg.rng_seed + ci,
            # -f seeds only the first contig; restarts pick a random
            # surviving read (init, spaced_seed.cpp:205-210)
            initial_ref_path=cfg.initial_ref_path if ci == 0 else None,
            checkpoint_path=None,
            resume_path=None if ci else cfg.resume_path,
        )
        asm = BatchAssembler(
            c, reads, patterns,
            surviving=surviving,
            trial_cache=cache,
            device_builder=builder,
            device=device,
            screen_kernel=screen_kernel,
            mesh=mesh,
        )
        if not asm.surviving:
            break
        before = len(asm.surviving)
        asm.run(out=None, log=log)
        contigs.append(
            ContigResult(
                codes=asm.ref.text().copy(),
                nreads=before - len(asm.surviving),
                nrounds=asm.nround,
            )
        )
        if log:
            log.write(
                f"=== contig {ci}: {len(contigs[-1].codes)} bp from "
                f"{contigs[-1].nreads} reads in {asm.nround} rounds; "
                f"{len(asm.surviving)} reads left\n"
            )
        surviving = asm.surviving
        cache = asm._trial_cache
        builder = asm._device_builder
        # free the big consensus tensors before the next restart
        del asm
        if not surviving:
            break
    if dedupe and len(contigs) > 1:
        from ..tools.postprocess import dedupe_contigs

        kept, dropped = dedupe_contigs([c.codes for c in contigs])
        if dropped and log:
            for d in dropped:
                log.write(
                    f"=== dropping contig {d['idx']} "
                    f"({len(contigs[d['idx']].codes)} bp): {d['covered']:.0%} "
                    f"contained in contig {d['into']}\n"
                )
        contigs = [contigs[i] for i in kept]
    return contigs, surviving if surviving is not None else list(range(len(reads)))
