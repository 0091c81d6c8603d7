"""Plain consensus with per-base votes (numpy), written for the benchmark.

The semantics of the assembler's `ref_seq` + `vote_box` (ref_seq.h:47-373,
as the port's consensus/state.py implements them), kept as plain arrays
over the current extent [pre, post) only:

  codes (L,)   the consensus text
  sel   (L, 4) selection votes          sup (L, 4) insert-after votes
  total (L,)   participants of each box
  beg, end     the round-stable window [beg, end) inside [0, L)

elect() scatters an edit stream's votes; try_align() aligns a segment and
votes, growing the ends on a full consumption; evolve() is the whole
split / keep / delete walk (ref_seq.h:317-349) over the extent, never an
incremental one; retreat_edges() and retreat_fixed() trim the ends
(the program's stall recovery). `state()` gives the fields a checkpoint
holds, relative to pre.
"""

from __future__ import annotations

import numpy as np

from .traceback import DELETE, INSERT, MATCH


class Consensus:
    def __init__(self, codes, sel, sup, total, beg, end, vote_ratio=0.5, overlap_min=64):
        self.codes = np.asarray(codes, np.uint8).copy()
        self.sel = np.asarray(sel, np.int32).copy()
        self.sup = np.asarray(sup, np.int32).copy()
        self.total = np.asarray(total, np.int32).copy()
        self.beg, self.end = int(beg), int(end)
        self.vote_ratio = vote_ratio
        self.overlap_min = overlap_min

    @classmethod
    def from_read(cls, codes, **kw):
        codes = np.asarray(codes, np.uint8)
        L = len(codes)
        sel = np.zeros((L, 4), np.int32)
        sel[np.arange(L), codes] = 1
        return cls(codes, sel, np.zeros((L, 4), np.int32), np.ones(L, np.int32), 0, L, **kw)

    @classmethod
    def from_state(cls, st: dict, **kw):
        return cls(st["codes"], st["sel"], st["sup"], st["total"], st["beg"], st["end"], **kw)

    def state(self) -> dict:
        return {"codes": self.codes.copy(), "sel": self.sel.copy(), "sup": self.sup.copy(),
                "total": self.total.copy(), "beg": self.beg, "end": self.end}

    def length(self) -> int:
        return self.end - self.beg

    def text(self) -> np.ndarray:
        return self.codes[self.beg:self.end]

    def accessor(self, pos: int, forward: bool) -> np.ndarray:
        p = self.beg + pos
        return self.codes[p:] if forward else self.codes[: p + 1][::-1]

    # growth: fresh single-vote boxes at either end
    def _fresh(self, codes):
        n = len(codes)
        sel = np.zeros((n, 4), np.int32)
        sel[np.arange(n), codes] = 1
        return sel, np.zeros((n, 4), np.int32), np.ones(n, np.int32)

    def append(self, codes) -> None:
        codes = np.asarray(codes, np.uint8)
        if len(codes) == 0:
            return
        sel, sup, tot = self._fresh(codes)
        self.codes = np.concatenate([self.codes, codes])
        self.sel = np.concatenate([self.sel, sel])
        self.sup = np.concatenate([self.sup, sup])
        self.total = np.concatenate([self.total, tot])

    def prepend(self, codes) -> None:
        codes = np.asarray(codes, np.uint8)
        n = len(codes)
        if n == 0:
            return
        sel, sup, tot = self._fresh(codes)
        self.codes = np.concatenate([codes, self.codes])
        self.sel = np.concatenate([sel, self.sel])
        self.sup = np.concatenate([sup, self.sup])
        self.total = np.concatenate([tot, self.total])
        self.beg += n
        self.end += n

    def elect(self, pos: int, ops, vals, forward: bool) -> None:
        ops = np.asarray(ops)
        vals = np.asarray(vals).astype(np.int64)
        adv = (ops != INSERT).astype(np.int64)
        before = np.cumsum(adv) - adv
        start = self.beg + pos
        if forward:
            idx = np.where(ops == INSERT, start + before - 1, start + before)
        else:
            idx = start - before
        # a vote outside the extent (an INSERT past a grown end) has no box:
        # the growth that follows makes fresh boxes there
        inside = (idx >= 0) & (idx < len(self.codes))
        m, d, i = (ops == MATCH) & inside, (ops == DELETE) & inside, (ops == INSERT) & inside
        np.add.at(self.sel, (idx[m], vals[m]), 1)
        np.add.at(self.total, idx[m], 1)
        np.add.at(self.total, idx[d], 1)
        np.add.at(self.sup, (idx[i], vals[i]), 1)

    def try_align(self, align, pos: int, seg, forward: bool) -> bool:
        ref = self.accessor(pos, forward)
        res = align(ref, seg)
        if res is None:
            return False
        matlen_a, matlen_b, _, ops, vals = res
        if matlen_a < self.overlap_min:
            return False
        self.elect(pos, ops, vals, forward)
        if matlen_a == len(ref):
            tail = seg[matlen_b:]
            if forward:
                self.append(tail)
            else:
                self.prepend(tail[::-1])
        return True

    def evolve(self) -> None:
        """Split supplements into new boxes, keep majority winners, delete
        the rest, each deleted box's selection going to the supplement of
        the nearest kept box before it; a deleted run at the head drops
        its selection."""
        L = len(self.codes)
        if L == 0:
            self.beg = self.end = 0
            return
        sel, sup, tot = self.sel, self.sup, self.total
        thresh = self.vote_ratio * tot
        valid = sel.max(axis=1) > thresh
        has_sup = sup.max(axis=1) > thresh
        K = np.empty(2 * L, bool)
        K[0::2], K[1::2] = valid, has_sup
        c_sel = np.zeros((2 * L, 4), np.int32)
        c_sup = np.zeros((2 * L, 4), np.int32)
        c_tot = np.zeros(2 * L, np.int32)
        c_code = np.zeros(2 * L, np.uint8)
        c_sel[0::2] = sel
        c_sup[0::2] = np.where(has_sup[:, None], 0, sup)
        c_tot[0::2] = tot
        c_code[0::2] = sel.argmax(axis=1)
        c_sel[1::2] = sup
        c_tot[1::2] = tot
        c_code[1::2] = sup.argmax(axis=1)
        slot = np.where(K, np.arange(2 * L), -1)
        last_kept = np.concatenate([[-1], np.maximum.accumulate(slot)[:-1]])
        dele = np.nonzero(~valid)[0]
        tgt = last_kept[2 * dele]
        ok = tgt >= 0
        np.add.at(c_sup, tgt[ok], sel[dele[ok]])
        kept = np.nonzero(K)[0]
        self.codes, self.sel, self.sup, self.total = c_code[kept], c_sel[kept], c_sup[kept], c_tot[kept]
        self.beg, self.end = 0, len(kept)

    def _trim(self, lo: int, hi: int) -> None:
        self.codes, self.sel = self.codes[lo:hi], self.sel[lo:hi]
        self.sup, self.total = self.sup[lo:hi], self.total[lo:hi]
        self.beg, self.end = 0, hi - lo

    def retreat_edges(self, min_total: int, keep_min: int) -> int:
        L = len(self.codes)
        if L == 0:
            return 0
        weak = self.total < min_total
        if weak.all():
            return 0
        kl = int(np.argmin(weak))
        kr = int(np.argmin(weak[::-1]))
        if (kl == 0 and kr == 0) or (L - kr) - kl < keep_min:
            return 0
        self._trim(kl, L - kr)
        return kl + kr

    def retreat_fixed(self, n: int, keep_min: int) -> int:
        L = len(self.codes)
        cut = min(n, (L - keep_min) // 2)
        if cut <= 0:
            return 0
        self._trim(cut, L - cut)
        return 2 * cut
