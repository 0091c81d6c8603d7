"""Evolving consensus reference with per-base vote tensors.

Re-design of the reference's `ref_seq` + `vote_box` + `base_vote`
(ref_seq.h:47-373): the std::list<vote_box> becomes flat integer tensors
aligned with the text buffer —

  sel   (cap, 4) int32   selection votes per base      (base_vote acgt)
  sup   (cap, 4) int32   supplement (insert-after) votes
  total (cap,)   int32   participant count per box

The text buffer keeps the sequence in the middle third so it can grow in
both directions (txt_buf layout, ref_seq.h:363-372). Window semantics match
the reference exactly: [beg, end) is the round-stable reference, [pre,
post) the mid-round extended extent.

elect() turns an edit stream into scatter-adds (apply_edits,
ref_seq.h:25-41); evolve() is the vectorized split/keep/delete walk
(ref_seq.h:317-349), including the absorb-into-previous-survivor rule for
deleted boxes. Both are commutative integer updates, which is what makes
the multi-chip vote merge a plain psum (see parallel/).
"""

from __future__ import annotations

import numpy as np

from ..align.types import AlignResult, DELETE, INSERT, MATCH
from ..config import Constants


class ConsensusRef:
    def __init__(
        self,
        codes: np.ndarray,
        locked: bool = False,
        weight: int = 1,
        capacity: int = 3 * Constants.MAX_SEQ_LEN,
        overlap_min: int = Constants.OVERLAP_MIN,
        vote_ratio: float = Constants.VOTE_RATIO,
    ):
        codes = np.asarray(codes, dtype=np.uint8)
        L = len(codes)
        if L > capacity // 3:
            raise ValueError(f"initial reference too long: {L}")
        self.cap = capacity
        self.origin = capacity // 3
        self.locked = locked
        self.overlap_min = overlap_min
        self.vote_ratio = vote_ratio

        self.buf = np.zeros(capacity, dtype=np.uint8)
        self.sel = np.zeros((capacity, 4), dtype=np.int32)
        self.sup = np.zeros((capacity, 4), dtype=np.int32)
        self.total = np.zeros(capacity, dtype=np.int32)

        o = self.origin
        self.buf[o : o + L] = codes
        # vote_box(c, w): w selection votes but total == 1 (ref_seq.h:122)
        self.sel[o + np.arange(L), codes] = weight
        self.total[o : o + L] = 1
        self.beg = self.pre = o
        self.end = self.post = o + L
        self.version = 0  # bumped on every mutation (device-cache key)
        # evolve dirty tracking: None = full recompute required; else a
        # list of absolute [lo, hi) vote-touched intervals since the last
        # evolve (see evolve() — decisions are per-cell local, so clean
        # cells keep their state and only touched spans recompute)
        self._dirty: list | None = []
        self.evolve_stats = {"fast": 0, "splice": 0, "full": 0, "noop": 0}

    # ------------------------------------------------------------------ geometry

    def length(self) -> int:
        return self.end - self.beg

    def contained(self, pos: int) -> bool:
        return self.pre <= pos + self.beg < self.post

    def accessor(self, pos: int, forward: bool) -> np.ndarray:
        """Reference subsequence in reading order (get_accessor,
        ref_seq.h:282-286): forward reads toward post, backward reads toward
        pre on the same strand (no reverse complement)."""
        assert self.contained(pos), pos
        p = self.beg + pos
        if forward:
            return self.buf[p : self.post]
        return self.buf[self.pre : p + 1][::-1]

    def text(self) -> np.ndarray:
        """The round-stable reference window [beg, end)."""
        return self.buf[self.beg : self.end]

    # ------------------------------------------------------------------ growth

    def _reset_rows(self, lo: int, hi: int) -> None:
        self.sel[lo:hi] = 0
        self.sup[lo:hi] = 0
        self.total[lo:hi] = 0

    def append(self, codes: np.ndarray) -> None:
        """Grow at the tail with fresh single-vote boxes (ref_seq.h:227-233)."""
        codes = np.asarray(codes, dtype=np.uint8)
        L = len(codes)
        if L == 0:
            return
        if self.post + L > self.cap:
            raise OverflowError("reference capacity exceeded (append)")
        lo = self.post
        self.buf[lo : lo + L] = codes
        self._reset_rows(lo, lo + L)
        self.sel[lo + np.arange(L), codes] = 1
        self.total[lo : lo + L] = 1
        self.post += L
        self.version += 1

    def prepend(self, codes: np.ndarray) -> None:
        """Grow at the head; `codes` in genomic (left-to-right) order
        (ref_seq.h:235-242)."""
        codes = np.asarray(codes, dtype=np.uint8)
        L = len(codes)
        if L == 0:
            return
        if self.pre - L < 0:
            raise OverflowError("reference capacity exceeded (prepend)")
        lo = self.pre - L
        self.buf[lo : lo + L] = codes
        self._reset_rows(lo, lo + L)
        self.sel[lo + np.arange(L), codes] = 1
        self.total[lo : lo + L] = 1
        self.pre = lo
        self.version += 1

    # ------------------------------------------------------------------ voting

    def elect(self, pos: int, ops: np.ndarray, vals: np.ndarray, forward: bool) -> None:
        """Apply an edit stream as votes (elect + apply_edits,
        ref_seq.h:25-41, 352-362).

        MATCH  -> sel[box, val] += 1, total[box] += 1, advance
        DELETE -> total[box] += 1, advance
        INSERT -> sup[prev-box(fwd) / cur-box(bwd), val] += 1, no advance
        """
        ops = np.asarray(ops)
        vals = np.asarray(vals)
        advance = (ops != INSERT).astype(np.int64)
        nonins_before = np.cumsum(advance) - advance  # exclusive prefix count
        start = self.beg + pos
        if forward:
            idx = start + nonins_before
            idx = np.where(ops == INSERT, idx - 1, idx)
        else:
            idx = start - nonins_before
        m = ops == MATCH
        d = ops == DELETE
        i = ops == INSERT
        np.add.at(self.sel, (idx[m], vals[m].astype(np.int64)), 1)
        np.add.at(self.total, idx[m], 1)
        np.add.at(self.total, idx[d], 1)
        np.add.at(self.sup, (idx[i], vals[i].astype(np.int64)), 1)
        if len(idx):
            self.mark_dirty(int(idx.min()), int(idx.max()) + 1)
        self.version += 1

    def try_align(self, aligner, pos: int, seg: np.ndarray, forward: bool):
        """Align a read segment at reference position pos; on success vote and
        possibly grow (try_align, ref_seq.h:259-277).

        `aligner(a, b)` -> AlignResult|None with a=reference, b=segment;
        `seg` is the segment in reading order.
        Returns the AlignResult on acceptance, else None.
        """
        ref = self.accessor(pos, forward)
        res: AlignResult | None = aligner(ref, seg)
        if res is None:
            return None
        if res.matlen_a < self.overlap_min:
            return None
        if self.locked:
            return res
        self.elect(pos, res.ops, res.vals, forward)
        if res.matlen_a == len(ref):
            tail = seg[res.matlen_b :]
            if forward:
                self.append(tail)
            else:
                self.prepend(tail[::-1])
        return res

    # ------------------------------------------------------------------ evolve

    def mark_dirty(self, lo: int, hi: int) -> None:
        """Record that votes changed in absolute rows [lo, hi) since the
        last evolve. None means 'everything' (e.g. a checkpoint-restored
        reference) and stays None until the next full evolve."""
        if self._dirty is None:
            return
        self._dirty.append((lo, hi))

    def _evolve_block(self, lo: int, hi: int):
        """The split/keep/delete candidate walk (ref_seq.h:317-349) over
        absolute rows [lo, hi), vectorized over the interleaved candidate
        array [box0, split0, box1, split1, ...]. A deleted box absorbs its
        selection into the nearest preceding kept candidate; a deleted run
        starting at `lo` drops the absorption, exactly like the reference
        list walk at the window head — so incremental callers must start
        blocks at the window head or at a cell guaranteed kept.

        Returns (code, sel, sup, tot) arrays of the kept candidates."""
        L = hi - lo
        sel = self.sel[lo:hi]
        sup = self.sup[lo:hi]
        tot = self.total[lo:hi]

        sel_max = sel.max(axis=1)
        sup_max = sup.max(axis=1)
        thresh = self.vote_ratio * tot
        valid = sel_max > thresh      # is_valid(0.5)  (ref_seq.h:170)
        has_sup = sup_max > thresh    # has_supply(0.5) (ref_seq.h:175)
        # winner(): argmax with A>C>G>T tie preference == first max
        sel_win = sel.argmax(axis=1).astype(np.uint8)
        sup_win = sup.argmax(axis=1).astype(np.uint8)

        # candidate slots: 2i = original box i (kept iff valid), 2i+1 = split
        # box of i (exists iff has_sup; a split box is always valid because
        # split copies total and has_supply uses the same threshold).
        K = np.empty(2 * L, dtype=bool)
        K[0::2] = valid
        K[1::2] = has_sup

        cand_sel = np.zeros((2 * L, 4), dtype=np.int32)
        cand_sup = np.zeros((2 * L, 4), dtype=np.int32)
        cand_tot = np.zeros(2 * L, dtype=np.int32)
        cand_code = np.zeros(2 * L, dtype=np.uint8)
        cand_sel[0::2] = sel
        cand_sup[0::2] = np.where(has_sup[:, None], 0, sup)  # split() resets sup
        cand_tot[0::2] = tot
        cand_code[0::2] = sel_win
        cand_sel[1::2] = sup
        cand_tot[1::2] = tot
        cand_code[1::2] = sup_win

        # deleted boxes absorb their selection into the nearest preceding
        # kept candidate's supplement (ref_seq.h:339-346)
        slot_of_kept = np.where(K, np.arange(2 * L), -1)
        last_kept_before = np.concatenate(
            [[-1], np.maximum.accumulate(slot_of_kept)[:-1]]
        )
        del_idx = np.nonzero(~valid)[0]
        tgt = last_kept_before[2 * del_idx]
        okm = tgt >= 0
        np.add.at(cand_sup, tgt[okm], sel[del_idx[okm]])

        kept = np.nonzero(K)[0]
        # output positions of the absorb receivers: the ONLY cells whose
        # next-evolve decision can change without new votes (absorbed
        # supplement may cross the split threshold) — callers keep them
        # dirty. Every other output cell reproduces itself: kept originals
        # and absorb-free cells keep sel/sup/total verbatim, split hosts
        # and split boxes leave with sup == 0.
        kept_rank = np.cumsum(K) - 1
        absorb_out = np.unique(kept_rank[tgt[okm]]) if okm.any() else np.empty(0, np.int64)
        return (
            cand_code[kept], cand_sel[kept], cand_sup[kept], cand_tot[kept],
            absorb_out,
        )

    def _merged_dirty(self, pre: int, post: int, gap: int = 64, cap: int = 8):
        """Dirty spans clipped to [pre, post), sorted, merged (gap-
        tolerant), reduced to at most `cap` spans; None if unknown."""
        if self._dirty is None:
            return None
        iv = []
        for lo, hi in self._dirty:
            lo, hi = max(lo, pre), min(hi, post)
            if lo < hi:
                iv.append((lo, hi))
        if not iv:
            return []
        iv.sort()
        merged = [list(iv[0])]
        for lo, hi in iv[1:]:
            if lo <= merged[-1][1] + gap:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        while len(merged) > cap:
            gaps = [merged[k + 1][0] - merged[k][1] for k in range(len(merged) - 1)]
            k = int(np.argmin(gaps))
            merged[k][1] = max(merged[k][1], merged[k + 1][1])
            merged.pop(k + 1)
        return merged

    def evolve(self) -> None:
        """Commit votes: split supplements into new boxes, keep majority
        winners, delete the rest absorbing their selection into the previous
        survivor's supplement (ref_seq.h:317-349).

        Decisions are per-cell local, and a cell untouched since the last
        evolve keeps its state unchanged (it was kept then with the same
        votes; fresh growth cells are single-vote kept boxes; post-evolve
        cells never retain a pending split — the only non-local effect,
        absorbed supplement from a deleted neighbor, re-marks its target
        dirty below). So when the touched spans are known, only THEY are
        recomputed and spliced, and the O(L) full rebuild — measured
        1.3-3.5 s/round at 4.6 Mb, the largest steady-state phase of the
        r4 whole-genome run — drops to the touched-span size. Falls back
        to the full path (recompute everything, rebase to origin) when
        the dirty set is unknown, spans the window, shifts an interior
        span's length, or the window drifts near the buffer edge."""
        if self.locked:
            return
        pre, post = self.pre, self.post
        L = post - pre
        self.version += 1
        if L == 0:
            self.beg = self.end = self.pre = self.post = self.origin
            self._dirty = []
            return
        spans = self._merged_dirty(pre, post)
        margin = self.cap // 8
        if (
            spans is not None
            and pre > margin
            and post < self.cap - margin
            and self._evolve_incremental(spans)
        ):
            return
        self._evolve_full()

    def _evolve_full(self) -> None:
        pre, post = self.pre, self.post
        code, sel, sup, tot, absorb_out = self._evolve_block(pre, post)
        newL = len(code)
        o = self.origin
        if o + newL > self.cap:
            raise OverflowError("reference capacity exceeded (evolve)")
        self.buf[o : o + newL] = code
        self.sel[o : o + newL] = sel
        self.sup[o : o + newL] = sup
        self.total[o : o + newL] = tot
        self.pre = self.beg = o
        self.end = self.post = o + newL
        # absorb receivers may split at the NEXT evolve with no new votes
        self._dirty = [(o + int(p), o + int(p) + 1) for p in absorb_out]
        self.evolve_stats["full"] += 1

    def _evolve_incremental(self, spans) -> bool:
        """Recompute only the touched spans and splice them in place.
        Returns False (caller runs the full path) on any bail condition."""
        pre, post = self.pre, self.post
        if not spans:
            # nothing voted since the last evolve: every cell keeps
            self.beg, self.end = pre, post
            self._dirty = []
            self.evolve_stats["noop"] += 1
            return True
        blocks = []
        interior_delta = False
        for lo, hi in spans:
            lo2 = max(lo - 1, pre)  # preceding kept cell = absorb anchor
            if lo2 == pre and hi == post:
                return False  # whole window: the full path IS this
            out = self._evolve_block(lo2, hi)
            delta = len(out[0]) - (hi - lo2)
            if lo2 > pre and hi < post and delta != 0:
                interior_delta = True
            blocks.append((lo2, hi, out, delta))
        if interior_delta:
            # an interior span changed length: every cell right of it
            # shifts, so splice-rebase — span-limited recompute + one
            # O(L) copy-through of the clean segments (~10x cheaper than
            # the full path's whole-window candidate recompute)
            return self._splice_rebase(blocks)

        next_dirty = []
        for lo2, hi, (code, sel, sup, tot, absorb_out), delta in blocks:
            nl = len(code)
            if lo2 == pre:
                start = hi - nl  # keep the right boundary, move `pre`
                if start < 0:
                    return False
                self.pre = start
            else:
                start = lo2
                if hi == post:
                    if start + nl > self.cap:
                        return False
                    self.post = start + nl
            self.buf[start : start + nl] = code
            self.sel[start : start + nl] = sel
            self.sup[start : start + nl] = sup
            self.total[start : start + nl] = tot
            # absorb receivers may split next evolve without new votes
            next_dirty.extend(
                (start + int(p), start + int(p) + 1) for p in absorb_out
            )
        self.beg, self.end = self.pre, self.post
        self._dirty = next_dirty
        self.evolve_stats["fast"] += 1
        return True

    def _splice_rebase(self, blocks) -> bool:
        """Assemble [clean segment | recomputed block | ...] into a fresh
        window at the origin (one copy-through pass; the clean segments'
        evolve output is their input verbatim — the invariant the dirty
        tracking rests on)."""
        pre, post = self.pre, self.post
        o = self.origin
        plan = []
        cur = pre
        for lo2, hi, out, _delta in blocks:
            if lo2 > cur:
                plan.append(("clean", cur, lo2, None))
            plan.append(("new", 0, 0, out))
            cur = hi
        if cur < post:
            plan.append(("clean", cur, post, None))
        newL = sum(
            (e[2] - e[1]) if e[0] == "clean" else len(e[3][0]) for e in plan
        )
        if o + newL > self.cap:
            raise OverflowError("reference capacity exceeded (evolve)")
        nbuf = np.empty(newL, np.uint8)
        nsel = np.empty((newL, 4), np.int32)
        nsup = np.empty((newL, 4), np.int32)
        ntot = np.empty(newL, np.int32)
        next_dirty = []
        w = 0
        for e in plan:
            if e[0] == "clean":
                lo, hi = e[1], e[2]
                n = hi - lo
                nbuf[w : w + n] = self.buf[lo:hi]
                nsel[w : w + n] = self.sel[lo:hi]
                nsup[w : w + n] = self.sup[lo:hi]
                ntot[w : w + n] = self.total[lo:hi]
            else:
                code, sel, sup, tot, absorb_out = e[3]
                n = len(code)
                nbuf[w : w + n] = code
                nsel[w : w + n] = sel
                nsup[w : w + n] = sup
                ntot[w : w + n] = tot
                next_dirty.extend(
                    (o + w + int(p), o + w + int(p) + 1) for p in absorb_out
                )
            w += n
        self.buf[o : o + newL] = nbuf
        self.sel[o : o + newL] = nsel
        self.sup[o : o + newL] = nsup
        self.total[o : o + newL] = ntot
        self.pre = self.beg = o
        self.end = self.post = o + newL
        self._dirty = next_dirty
        self.evolve_stats["splice"] += 1
        return True

    def retreat_edges(self, min_total: int = 2, keep_min: int = 64) -> int:
        """Trim the weakly-supported fringe (cells with total < min_total)
        off both ends of the consensus and return the number of cells cut.

        Stall recovery beyond the reference: when every pattern fails
        (spaced_seed.cpp:441-447 just terminates there), the blocker at
        high error rates is the outermost ~read-length of consensus, which
        carries a single read's votes (total == 1) and therefore that
        read's full error rate — new reads must beat ~2x the per-read
        error to align across it. Cutting the fringe back to multi-read
        support lets a different read re-extend with fresh errors. No-op
        when locked, when there is no strong interior, or when the strong
        interior is shorter than keep_min."""
        if self.locked:
            return 0
        lo, hi = min(self.pre, self.beg), max(self.post, self.end)
        if hi <= lo:
            return 0
        weak = self.total[lo:hi] < min_total
        if weak.all():
            return 0
        kl = int(np.argmin(weak))          # leading weak run
        kr = int(np.argmin(weak[::-1]))    # trailing weak run
        if kl == 0 and kr == 0:
            return 0
        if (hi - kr) - (lo + kl) < keep_min:
            return 0
        self.pre = self.beg = lo + kl
        self.end = self.post = hi - kr
        self.version += 1
        return kl + kr

    def retreat_fixed(self, n: int, keep_min: int = 64) -> int:
        """Trim a FIXED n cells off each end of the consensus (stall-recovery
        escalation beyond retreat_edges: once the single-read fringe is
        gone, a stalled edge can still carry a multi-read consensus that no
        remaining read seeds against — e.g. two erroneous tails that agreed
        by chance. Cutting a fixed span forces a different read to re-extend
        it). Returns cells cut; no-op when locked or too short."""
        if self.locked:
            return 0
        lo, hi = min(self.pre, self.beg), max(self.post, self.end)
        cut = min(n, (hi - lo - keep_min) // 2)
        if cut <= 0:
            return 0
        self.pre = self.beg = lo + cut
        self.end = self.post = hi - cut
        self.version += 1
        return 2 * cut

    # ------------------------------------------------------------------ misc

    def state_dict(self) -> dict:
        """Checkpointable snapshot (SURVEY.md §5 checkpoint/resume)."""
        pre, post = self.pre, self.post
        return {
            "codes": self.buf[pre:post].copy(),
            "sel": self.sel[pre:post].copy(),
            "sup": self.sup[pre:post].copy(),
            "total": self.total[pre:post].copy(),
            "beg": self.beg - pre,
            "end": self.end - pre,
            "locked": self.locked,
            "overlap_min": self.overlap_min,
            "vote_ratio": self.vote_ratio,
        }

    @classmethod
    def from_state_dict(cls, state: dict, capacity: int = 3 * Constants.MAX_SEQ_LEN):
        ref = cls.__new__(cls)
        codes = np.asarray(state["codes"], dtype=np.uint8)
        L = len(codes)
        ref.cap = capacity
        ref.origin = capacity // 3
        ref.locked = bool(state["locked"])
        ref.overlap_min = int(state["overlap_min"])
        ref.vote_ratio = float(state["vote_ratio"])
        ref.buf = np.zeros(capacity, dtype=np.uint8)
        ref.sel = np.zeros((capacity, 4), dtype=np.int32)
        ref.sup = np.zeros((capacity, 4), dtype=np.int32)
        ref.total = np.zeros(capacity, dtype=np.int32)
        o = ref.origin
        ref.buf[o : o + L] = codes
        ref.sel[o : o + L] = state["sel"]
        ref.sup[o : o + L] = state["sup"]
        ref.total[o : o + L] = state["total"]
        ref.pre = o
        ref.post = o + L
        ref.beg = o + int(state["beg"])
        ref.end = o + int(state["end"])
        ref.version = 0
        # restored votes have unknown provenance: first evolve runs full
        ref._dirty = None
        ref.evolve_stats = {"fast": 0, "splice": 0, "full": 0, "noop": 0}
        return ref
