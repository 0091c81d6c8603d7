"""Plain replay of one round of the batch assembler, written for the benchmark.

The round of the assembler's batch engine, as a plain program: the
boundary seed index of the round-start consensus (a stable sort and binary
search), candidate expansion (every trial seed of every surviving read,
masked by the round's pattern, at most `bucket_max_candidates` hits a
trial, one probe a read, direction and diagonal), screening (the prefilter
over the first `prefilter_len` bases at `prefilter_ratio`, then the full
banded DP in chunks of 4,096 longest-first, each at its own size bucket),
the commit (each read's first accepted candidate: interior ones vote from
the plain parent plane and walk, the others go through the plain host
aligner against the current consensus, in read order or, with
`parallel_commit`, in the order of the engine's two-thread split), and the
plain evolve; then the stall recovery of the engine's round loop (edge retreat).

`replay_round` starts from a snapshot of the program's state before the
round (consensus, surviving reads, counters and the generator state of
the pattern schedule) and returns what the round produced at each stage.
It imports nothing of the program: it follows the published semantics
with its own code and the frozen plain DPs beside it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import aligner, rowdp, traceback
from .consensus import Consensus

SEED_LEN = 16
# shift of base t in the uint32 seed: byte t // 4, first base of a byte in bits 7-6
_SEED_WEIGHTS = np.array([1 << ((t // 4) * 8 + (3 - t % 4) * 2) for t in range(SEED_LEN)],
                         dtype=np.int64)
SCREEN_CHUNK = 4096
TB_CHUNK = 32
BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 20001)
MATRIX_BYTES = 1 << 30  # the program's device read matrix budget: beyond it, no prefilter


def size_bucket(lb: int, ratio: float):
    for cap in BUCKETS:
        if lb <= cap:
            break
    w = 1 + int(cap * ratio)
    return cap, cap + w + 1, w


def encode_seeds(codes: np.ndarray, positions: np.ndarray) -> np.ndarray:
    idx = np.asarray(positions, np.int64)[:, None] + np.arange(SEED_LEN)
    return ((codes[idx].astype(np.int64) * _SEED_WEIGHTS).sum(axis=1) & 0xFFFFFFFF).astype(np.uint32)


class Reads:
    """The store as the engine keeps it: reads with min_len < length <
    max_len, numbered in store order."""

    def __init__(self, codes: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
                 min_len: int, max_len: int):
        keep = (lengths > min_len) & (lengths < max_len)
        self.flat = codes
        self.offsets = offsets[keep].astype(np.int64)
        self.lengths = lengths[keep].astype(np.int64)

    def __len__(self):
        return len(self.lengths)

    def codes(self, i: int) -> np.ndarray:
        o = int(self.offsets[i])
        return self.flat[o: o + int(self.lengths[i])]


def trial_seeds(reads: Reads, max_trial: int, overlap_min: int, block: int = 8192):
    """(seeds, valid) (N, 2T): column 2j the forward trial at base j, 2j+1
    the backward one at length - 16 - j."""
    N, T = len(reads), max_trial
    seeds = np.zeros((N, 2 * T), np.uint32)
    valid = np.zeros((N, 2 * T), bool)
    jj = np.arange(T, dtype=np.int64)
    for lo in range(0, N, block):
        sl = slice(lo, min(N, lo + block))
        slen, offs = reads.lengths[sl], reads.offsets[sl]
        nval = np.minimum(T, np.maximum(slen - SEED_LEN + 1, 0))
        col_ok = jj[None, :] < nval[:, None]
        ok = col_ok & ((slen[:, None] - jj[None, :]) >= overlap_min)
        for col, pos in ((0, np.broadcast_to(jj, (len(slen), T))),
                         (1, np.maximum(slen[:, None] - SEED_LEN - jj[None, :], 0))):
            p = np.where(col_ok, offs[:, None] + pos, 0)
            s = encode_seeds(reads.flat, p.reshape(-1)).reshape(p.shape)
            seeds[sl, col::2] = np.where(col_ok, s, 0)
            valid[sl, col::2] = ok
    return seeds, valid


def seed_index(codes: np.ndarray, mask: int, max_read_len: int):
    """(keys, positions, n_indexed) of the boundary windows: the first
    min(L-16, W) positions ascending, then the last min(L-W-16, W)
    descending from L-16; zero keys dropped; stable by key."""
    L = len(codes)
    nhead = min(L - SEED_LEN, max_read_len)
    ntail = min(L - max_read_len - SEED_LEN, max_read_len)
    pos = np.concatenate([np.arange(max(0, nhead), dtype=np.int64),
                          L - SEED_LEN - np.arange(max(0, ntail), dtype=np.int64)])
    n_indexed = max(0, nhead) + max(0, ntail)
    if len(pos) == 0:
        return np.empty(0, np.uint32), np.empty(0, np.int64), n_indexed
    keys = encode_seeds(codes, pos) & np.uint32(mask)
    keep = keys != 0
    keys, pos = keys[keep], pos[keep]
    order = np.argsort(keys, kind="stable")
    return keys[order], pos[order], n_indexed


def expand(seeds, valid, surviving, keys, positions, pattern: int, cfg: dict):
    """Candidates (dict of arrays read, j, forward, r_offset, rank) and the
    hits dropped beyond the cap."""
    empty = {k: np.empty(0, np.int64) for k in ("read", "j", "r_offset", "rank")}
    empty["forward"] = np.empty(0, bool)
    if len(surviving) == 0:
        return empty, 0
    cap = cfg["bucket_max_candidates"]
    alive = np.asarray(surviving, np.int64)
    s = seeds[alive] & np.uint32(pattern)
    ok = valid[alive] & (s != 0)
    lo = np.searchsorted(keys, s.reshape(-1), side="left").reshape(s.shape)
    hi = np.searchsorted(keys, s.reshape(-1), side="right").reshape(s.shape)
    cnt = (hi - lo) * ok
    dropped = int(np.maximum(cnt - cap, 0).sum())
    rows, cols = np.nonzero(cnt)
    if len(rows) == 0:
        return empty, dropped
    n = np.minimum(cnt[rows, cols], cap).astype(np.int64)
    rank = np.arange(int(n.sum()), dtype=np.int64) - np.repeat(np.cumsum(n) - n, n)
    read = np.repeat(rows, n)
    col = np.repeat(cols, n)
    forward = (col & 1) == 0
    j = col >> 1
    r_offset = positions[np.repeat(lo[rows, cols], n) + rank].astype(np.int64)
    r_offset = r_offset + np.where(forward, 0, SEED_LEN - 1)
    if cfg["dedupe_diagonals"]:
        diag = np.where(forward, r_offset - j, r_offset + j)
        key = (read << 35) | ((diag + (1 << 33)) << 1) | forward
        _, first = np.unique(key, return_index=True)
        keep = np.sort(first)
        read, j, forward, r_offset, rank = read[keep], j[keep], forward[keep], r_offset[keep], rank[keep]
    return {"read": read, "j": j, "forward": forward, "r_offset": r_offset, "rank": rank}, dropped


def _pairs(ref: Consensus, reads: Reads, alive, cands, idxs, ref_len, LA, LB):
    """(a, la, b, lb) host matrices: a = the consensus from the candidate's
    position in its direction (la = min(ref_len, LA)), b = the read segment
    from trial j in its direction (lb = min(length - j, LB))."""
    B = len(idxs)
    a = np.zeros((B, LA), np.uint8)
    b = np.zeros((B, LB), np.uint8)
    la = np.zeros(B, np.int32)
    lb = np.zeros(B, np.int32)
    for q, n in enumerate(idxs):
        codes = reads.codes(int(alive[cands["read"][n]]))
        j = int(cands["j"][n])
        fwd = bool(cands["forward"][n])
        seg = codes[j:] if fwd else codes[: len(codes) - j][::-1]
        seg = seg[:LB]
        acc = ref.accessor(int(cands["r_offset"][n]), fwd)[: min(int(ref_len[n]), LA)]
        a[q, : len(acc)] = acc
        b[q, : len(seg)] = seg
        la[q], lb[q] = len(acc), len(seg)
    return a, la, b, lb


def _score(dev, a, la, b, lb, **kw):
    t = [torch.from_numpy(x).to(dev) for x in (a, la, b, lb)]
    s = rowdp.score(*t, **kw)
    return s.accept.cpu().numpy(), s.matlen_a.cpu().numpy().astype(np.int64), \
        s.matlen_b.cpu().numpy().astype(np.int64)


def screen(ref: Consensus, reads: Reads, alive, cands, cfg: dict, prefilter_on: bool, dev):
    """(accept, ma, mb, prefilter_kept, seg_len, ref_len) over the candidates."""
    n = len(cands["read"])
    accept = np.zeros(n, bool)
    ma = np.zeros(n, np.int64)
    mb = np.zeros(n, np.int64)
    if n == 0:
        return accept, ma, mb, -1, np.zeros(0, np.int64), np.zeros(0, np.int64)
    slen = reads.lengths[alive[cands["read"]]]
    seg_len = slen - cands["j"]
    p = ref.beg + cands["r_offset"]
    ref_len = np.where(cands["forward"], len(ref.codes) - p, p + 1)
    order = np.argsort(-seg_len, kind="stable")
    kept = -1
    if cfg["prefilter_len"] and prefilter_on and n >= cfg["prefilter_min_batch"]:
        LBp = cfg["prefilter_len"]
        Wp = 1 + int(LBp * cfg["prefilter_ratio"])
        every = np.arange(n)
        keep = np.zeros(n, bool)
        for lo in range(0, n, 65536):
            idxs = every[lo: lo + 65536]
            mats = _pairs(ref, reads, alive, cands, idxs, ref_len, LBp + Wp + 1, LBp)
            keep[idxs] = _score(dev, *mats, la_max=LBp + Wp + 1, w_max=Wp,
                                ratio=cfg["prefilter_ratio"])[0]
        order = order[keep[order]]
        kept = int(keep.sum())
    for lo in range(0, len(order), SCREEN_CHUNK):
        idxs = order[lo: lo + SCREEN_CHUNK]
        LB, LA, W = size_bucket(int(seg_len[idxs[0]]), cfg["ratio"])
        mats = _pairs(ref, reads, alive, cands, idxs, ref_len, LA, LB)
        acc, m_a, m_b = _score(dev, *mats, la_max=LA, w_max=W, ratio=cfg["ratio"])
        accept[idxs] = acc & (m_a >= cfg["overlap_min"])
        ma[idxs], mb[idxs] = m_a, m_b
    return accept, ma, mb, kept, seg_len, ref_len


def commit(ref: Consensus, reads: Reads, alive, cands, accept, ma, mb, seg_len, ref_len,
           cfg: dict, dev, tally: dict | None = None) -> tuple[list[int], bool]:
    """Each read's first accepted candidate: the device traceback's reads
    vote after the host reads, which commit in read order or, where the
    engine splits them, in the split's order (`host_order`). Returns the
    consumed rows of the surviving list and whether the split was taken;
    counts the host aligns in `tally["host_aligns"]`, where given."""
    by_read: dict[int, list[int]] = {}
    for n in np.nonzero(accept)[0].tolist():
        by_read.setdefault(int(cands["read"][n]), []).append(n)
    if not by_read:
        return [], False
    chosen = {r: ns[0] for r, ns in by_read.items()}
    tb = {}
    if cfg["device_traceback"]:
        eligible = [n for n in chosen.values() if ma[n] < ref_len[n]]
        if eligible:
            LB, LA, W = size_bucket(int(max(seg_len[n] for n in eligible)), cfg["ratio"])
            for lo in range(0, len(eligible), TB_CHUNK):
                part = eligible[lo: lo + TB_CHUNK]
                la_bound = int(np.minimum(ref_len[part], LA).max())
                rows = min(LA, -(-la_bound // 512) * 512)
                rows_pk = -(-rows // 128) * 128
                E = rows_pk + W + 2 + 32
                a, la, b, lb = (torch.from_numpy(x).to(dev) for x in
                                _pairs(ref, reads, alive, cands, part, ref_len, LA, LB))
                plane, md, lb_dp = traceback.parents(a, la, b, lb, la_max=LA, w_max=W,
                                                     ratio=cfg["ratio"], rows_max=rows_pk)
                ops, vals, ne = traceback.walk(plane, b, lb_dp, md, ma[part], mb[part],
                                               np.ones(len(part), bool), w_max=W, e_max=E)
                for q, n in enumerate(part):
                    tb[n] = (ops[q, : ne[q]], vals[q, : ne[q]])
    pending, consumed = [], []

    def align(x, y):
        if tally is not None:
            tally["host_aligns"] += 1
        return aligner.align(x, y, cfg["ratio"])

    host = []
    for r in sorted(by_read):
        n0 = chosen[r]
        if n0 in tb:
            pending.append(n0)
            consumed.append(r)
        else:
            host.append(r)
    order, split = host_order(ref, reads, cands, host, by_read, cfg)
    for r in order:
        codes = reads.codes(int(alive[r]))
        for n in by_read[r]:
            j = int(cands["j"][n])
            fwd = bool(cands["forward"][n])
            seg = codes[j:] if fwd else codes[: len(codes) - j][::-1]
            if ref.try_align(align, int(cands["r_offset"][n]), seg, fwd):
                consumed.append(r)
                break
    for n in pending:
        ref.elect(int(cands["r_offset"][n]), *tb[n], bool(cands["forward"][n]))
    return sorted(consumed), split


def host_order(ref: Consensus, reads: Reads, cands, host: list[int], by_read: dict,
               cfg: dict) -> tuple[list[int], bool]:
    """The order in which the host reads `host` (in read order) commit, and
    whether the engine's two-thread split takes them. The split needs
    `parallel_commit`, a consensus of L >= 2 * reach bases, where reach =
    max_read_len + int(the store's longest read * (1 + ratio)) + 64 bounds
    the cells one side's alignments touch from its own end, at least 4 host
    reads, and none of a locked consensus, a dump of the alignments or the
    stale-DP quirk. Then a read whose accepted candidates all lie at
    r_offset < L // 2 is a left read, all at or beyond it a right read, and
    one with candidates on both sides a mixed read: the two sides commit in
    two threads, each in read order, and the mixed reads after both, in read
    order. The sides share no cell, so serially that is the left reads, then
    the right, then the mixed."""
    L = ref.length()
    reach = cfg["max_read_len"] + int(int(reads.lengths.max()) * (1.0 + cfg["ratio"])) + 64
    if (not cfg["parallel_commit"] or cfg.get("locked") or cfg.get("quirk_stale_dp")
            or L < 2 * reach or len(host) < 4):
        return host, False
    mid = L // 2
    side = {r: {int(cands["r_offset"][n]) >= mid for n in by_read[r]} for r in host}
    left = [r for r in host if side[r] == {False}]
    right = [r for r in host if side[r] == {True}]
    mixed = [r for r in host if len(side[r]) == 2]
    return left + right + mixed, True


def audit_accepts(rounds: list[dict], reads: Reads, cfg: dict, dev) -> tuple[int, int]:
    """The guarantee that a read is accepted only where its whole overlap
    aligns within R, over every pair the program accepted in the given
    rounds: each pair is built again from the round-start consensus
    (codes, beg) and the candidate (store read, j, forward, r_offset),
    and scored by the plain DP at its own size bucket (the band and the
    row bound come from the pair's lengths, so its chunk's bucket does not
    change the score). Returns (pairs, pairs not accepted by the plain DP
    or with another goal cell)."""
    groups: dict[tuple, list] = {}
    for rnd in rounds:
        codes, beg = rnd["codes"], rnd["beg"]
        for q in range(len(rnd["read"])):
            seq = reads.codes(int(rnd["read"][q]))
            j, fwd = int(rnd["j"][q]), bool(rnd["forward"][q])
            seg = seq[j:] if fwd else seq[: len(seq) - j][::-1]
            p = beg + int(rnd["r_offset"][q])
            acc = codes[p:] if fwd else codes[: p + 1][::-1]
            key = size_bucket(len(seg), cfg["ratio"])
            groups.setdefault(key, []).append((acc, seg, int(rnd["ma"][q]), int(rnd["mb"][q])))
    pairs = bad = 0
    for (LB, LA, W), items in groups.items():
        for lo in range(0, len(items), SCREEN_CHUNK):
            part = items[lo: lo + SCREEN_CHUNK]
            a = np.zeros((len(part), LA), np.uint8)
            b = np.zeros((len(part), LB), np.uint8)
            la = np.zeros(len(part), np.int32)
            lb = np.zeros(len(part), np.int32)
            for q, (acc, seg, _, _) in enumerate(part):
                acc, seg = acc[:LA], seg[:LB]
                a[q, : len(acc)], b[q, : len(seg)] = acc, seg
                la[q], lb[q] = len(acc), len(seg)
            ok, m_a, m_b = _score(dev, a, la, b, lb, la_max=LA, w_max=W, ratio=cfg["ratio"])
            ok &= m_a >= cfg["overlap_min"]
            got_a = np.array([x[2] for x in part])
            got_b = np.array([x[3] for x in part])
            bad += int((~ok | (m_a != got_a) | (m_b != got_b)).sum())
            pairs += len(part)
    return pairs, bad


def replay_round(snap: dict, reads: Reads, seeds, valid, patterns, cfg: dict, dev) -> dict:
    """One round and its stall recovery from the program's state `snap`
    (state, surviving, nround, nfailure, retreats, fruitless_retreats,
    matches_since_retreat, rng). Returns each stage's outputs."""
    ref = Consensus.from_state(snap["state"], vote_ratio=cfg["vote_ratio"],
                               overlap_min=cfg["overlap_min"])
    alive = np.asarray(snap["surviving"], np.int64)
    nfailure = snap["nfailure"]
    rng = np.random.default_rng()
    rng.bit_generator.state = snap["rng"]
    if nfailure:
        pattern = patterns[nfailure - 1]
    elif cfg["pattern_schedule"] == "roundrobin":
        pattern = patterns[snap["nround"] % len(patterns)]
    else:
        pattern = patterns[int(rng.integers(0, len(patterns)))]
    keys, positions, n_indexed = seed_index(ref.text(), pattern, cfg["max_read_len"])
    cands, dropped = expand(seeds, valid, alive, keys, positions, pattern, cfg)
    lmax = int(reads.lengths.max())
    prefilter_on = cfg["device_materialize"] and (
        2 * len(reads) * (-(-lmax // 128) * 128) <= MATRIX_BYTES)
    accept, ma, mb, kept, seg_len, ref_len = screen(ref, reads, alive, cands, cfg,
                                                    prefilter_on, dev)
    tally = {"host_aligns": 0}
    consumed, split = commit(ref, reads, alive, cands, accept, ma, mb, seg_len, ref_len, cfg, dev,
                             tally)
    committed = ref.state()
    gone = set(consumed)
    surviving = [int(i) for r, i in enumerate(alive.tolist()) if r not in gone]
    nmatches = len(consumed)
    nfailure = 0 if nmatches else nfailure + 1
    if nfailure < len(patterns):
        ref.evolve()
    retreats, fruitless, since = snap["retreats"], snap["fruitless_retreats"], snap["matches_since_retreat"]
    since += nmatches
    if nfailure >= len(patterns):
        give_up = cfg["edge_retreat_fruitless"] and fruitless >= cfg["edge_retreat_fruitless"]
        trimmed = 0
        if (not give_up and retreats < cfg["edge_retreat"]
                and ref.length() >= cfg["edge_retreat_min_len"]):
            trimmed = ref.retreat_edges(cfg["edge_retreat_min_total"], cfg["overlap_min"])
            if trimmed == 0 and cfg["edge_retreat_bite"]:
                trimmed = ref.retreat_fixed(cfg["edge_retreat_bite"], cfg["overlap_min"])
        if trimmed:
            fruitless = fruitless + 1 if since == 0 and retreats > 0 else 0
            since = 0
            retreats += 1
            nfailure = 0
    return {
        "pattern": pattern, "n_indexed": n_indexed, "cands": cands, "dropped": dropped,
        "accept": accept, "ma": ma, "mb": mb, "prefilter_kept": kept,
        "committed": committed, "nmatches": nmatches, "split": split,
        "host_aligns": tally["host_aligns"],
        "state": ref.state(), "surviving": surviving, "nfailure": nfailure,
        "retreats": retreats, "fruitless_retreats": fruitless, "matches_since_retreat": since,
        "rng": rng.bit_generator.state,
    }


def initial_state(reads: Reads, rng_seed: int):
    """The first contig's start: a read drawn by the engine's generator,
    each base one vote; returns (state, generator state after the draw)."""
    rng = np.random.default_rng(rng_seed)
    i = int(rng.integers(0, len(reads)))
    return Consensus.from_read(reads.codes(i)).state(), rng.bit_generator.state
