"""Plain read locator, written for the benchmark.

The assembler's locator (locator.cpp:41-96): index every position of the
contig under one spaced-seed pattern (positions 0 .. L-17, stable by key);
for each read of at least 500 bases try seed offsets j = 0..49 in order and
each hit in index order, aligning the read from j (a) against the contig
from the hit (b) with the banded DP at ratio R (MAXN 40,000, MAXM 6,000);
the first accepted alignment with matlen_b > 0 gives the read's row
(read number, contig position, cost, length - j, diag cost). Reads under
500 bases are skipped without a number. Here the triples of the reads
asked for are scored together with the frozen plain DP, which decides
each triple alone, so the first accepted one is the sequential loop's.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rowdp
from .engine import SEED_LEN, encode_seeds

MAX_TRIAL_J, MIN_READ = 50, 500
MAXN, MAXM = 40_000, 6_000
BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 20001, MAXN)
CHUNK = 512


def contig_index(contig: np.ndarray, mask: int):
    pos = np.arange(max(0, len(contig) - SEED_LEN), dtype=np.int64)
    keys = np.concatenate([encode_seeds(contig, pos[i: i + (1 << 20)])
                           for i in range(0, len(pos), 1 << 20)] or [np.empty(0, np.uint32)])
    keys &= np.uint32(mask)
    keep = keys != 0
    keys, pos = keys[keep], pos[keep]
    order = np.argsort(keys, kind="stable")
    return keys[order], pos[order]


def rows_for(contig, index, mask: int, reads: list[np.ndarray], ratio: float, dev) -> list:
    """The row of each read (None where no alignment is accepted)."""
    keys, positions = index
    tri = []  # (read, j, candidate) in the loop's order
    for r, seq in enumerate(reads):
        nj = min(MAX_TRIAL_J, max(0, len(seq) - SEED_LEN + 1))
        if nj == 0:
            continue
        k = encode_seeds(seq, np.arange(nj)) & np.uint32(mask)
        lo = np.searchsorted(keys, k, side="left")
        hi = np.searchsorted(keys, k, side="right")
        for j in range(nj):
            tri += [(r, j, int(c)) for c in positions[lo[j]: hi[j]]]
    clen = len(contig)
    res = {}
    by_cap: dict[int, list[int]] = {}
    for t, (r, j, _) in enumerate(tri):
        la = len(reads[r]) - j
        cap = next(c for c in BUCKETS if la <= c)
        by_cap.setdefault(cap, []).append(t)
    for cap, ts in by_cap.items():
        w = 1 + int(np.floor(cap * ratio))
        LBm = cap + w + 1
        for s in range(0, len(ts), CHUNK):
            part = ts[s: s + CHUNK]
            B = len(part)
            a = np.zeros((B, cap), np.uint8)
            b = np.zeros((B, LBm), np.uint8)
            la = np.zeros(B, np.int32)
            lb = np.zeros(B, np.int32)
            for q, t in enumerate(part):
                r, j, c = tri[t]
                seg = reads[r][j:]
                a[q, : len(seg)] = seg
                sl = contig[c: c + LBm]
                b[q, : len(sl)] = sl
                la[q], lb[q] = len(seg), clen - c
            sc = rowdp.score(*(torch.from_numpy(x).to(dev) for x in (a, la, b, lb)),
                             la_max=cap, w_max=w, ratio=ratio, maxn=MAXN, maxm=MAXM)
            out = [x.cpu().numpy() for x in (sc.accept, sc.cost, sc.matlen_b, sc.diag_cost)]
            for q, t in enumerate(part):
                res[t] = tuple(int(x[q]) for x in out)
    first: dict[int, tuple] = {}
    for t, (r, j, c) in enumerate(tri):
        acc, cost, mb, diag = res[t]
        if acc and mb > 0 and r not in first:
            first[r] = (c, cost, len(reads[r]) - j, diag)
    return [first.get(r) for r in range(len(reads))]
