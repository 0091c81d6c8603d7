"""Assembly post-processing: contig containment dedup + read accounting.

The reference's round loop runs until NO read matches
(spaced_seed.cpp:444-447) and its `-f` restart workflow leaves any
redundant re-assembly of already-covered sequence to the operator
(README.mkd:52-63). The automated multi-contig mode
(assemble/batch.py::assemble_contigs) needs both closed out explicitly:

- `dedupe_contigs`: multi-contig restarts can re-assemble scraps of
  genome an earlier (larger) contig already covers — the r4 3% run
  shipped 5 sub-3 kb contigs fully contained in the 4.59 Mb contig.
  Containment is decided self-contained (no genome truth): the smaller
  contig's unique-16-mer collinear chains against the larger contig
  (tools/coverage.py machinery with the larger contig playing the
  genome) must cover >= min_covered of its length.

- `classify_reads`: reads still surviving at termination, categorized
  against the final contigs so summaries account for 100% of the input:
    mapped      — the read aligns into a finished contig (its region IS
                  assembled; it was simply never caught by a boundary
                  seed while that region was growing — redundant
                  coverage, not lost sequence)
    seeded_only — at least one seed trial hits a contig but every DP
                  rejects (error too high / overlap below OVERLAP_MIN)
    unseedable  — no head-or-tail seed trial of any direction occurs in
                  any contig (error-saturated or junk read)
  Mapping reuses the batched locator (tools/locate.py::map_reads, on the
  port's screening kernels) in both directions: the assembler probes head
  seeds forward and tail seeds backward (spaced_seed.cpp:424-426); a
  backward alignment is a forward alignment of the jointly reversed
  read+contig (same-strand model — there is no reverse complement
  anywhere, dna_seq.h:185-233).
"""

from __future__ import annotations

import numpy as np
import torch

from .coverage import _unique_anchors, contig_chains
from .locate import map_reads


def contig_containment(
    small: np.ndarray,
    anchor_keys: np.ndarray,
    anchor_pos: np.ndarray,
) -> float:
    """Fraction of `small` covered by collinear chains against another
    contig's unique-16-mer anchors (pass _unique_anchors(large))."""
    if len(small) == 0:
        return 0.0
    chains, _, _ = contig_chains(small, anchor_keys, anchor_pos)
    covered = sum(ch["contig"][1] - ch["contig"][0] for ch in chains)
    return covered / len(small)


def dedupe_contigs(
    contigs: list[np.ndarray], min_covered: float = 0.8
) -> tuple[list[int], list[dict]]:
    """Containment dedup over a contig set. Returns (kept_indices,
    dropped) where dropped entries are {idx, into, covered}: contig
    `idx` has >= min_covered of its length collinear with kept contig
    `into`. Larger contigs are kept first; a dropped contig is never a
    containment target (`into` is always kept), so the result is
    order-independent of ties. Partial overlaps (< min_covered) are NOT
    dropped — only (near-)containment is redundancy."""
    order = sorted(range(len(contigs)), key=lambda i: -len(contigs[i]))
    kept: list[int] = []
    anchors: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    dropped: list[dict] = []
    for i in order:
        hit = None
        for k in kept:
            if len(contigs[k]) <= len(contigs[i]):
                continue
            if k not in anchors:
                anchors[k] = _unique_anchors(contigs[k])
            frac = contig_containment(contigs[i], *anchors[k])
            if frac >= min_covered:
                hit = (k, frac)
                break
        if hit is None:
            kept.append(i)
        else:
            dropped.append(
                {"idx": i, "into": hit[0], "covered": round(hit[1], 4)}
            )
    return sorted(kept), dropped


def classify_reads(
    contigs: list[np.ndarray],
    seqs: list[np.ndarray],
    pattern: int,
    ratio: float,
    min_contig: int = 10_000,
    *,
    device: str | torch.device = "cuda",
    screen_kernel: str = "bitwave",
) -> dict:
    """Account for a surviving read set against the final contigs.
    Returns {total, mapped, seeded_only, unseedable, too_short,
    categories: per-read int array 0=mapped 1=seeded_only 2=unseedable
    3=too_short}. Contigs shorter than min_contig are skipped as mapping
    targets (a read "contained" only in a junk contig is not assembled
    sequence). Reads under the locator's 500 bp floor are counted
    too_short (locator.cpp:72; the assembler never indexed them either,
    spaced_seed.cpp:331-342). The mapping runs on `device` with the
    screening kernel `screen_kernel`."""
    from ..index import build_seedmap

    MIN_READ = 500
    n = len(seqs)
    cat = np.full(n, 2, np.int8)  # default: unseedable
    short = np.array([len(s) < MIN_READ for s in seqs])
    cat[short] = 3
    targets = [c for c in contigs if len(c) >= min_contig]
    targets.sort(key=len, reverse=True)

    from ..codec import dna

    # pass order: biggest contigs first, forward then backward; reads
    # already mapped are dropped from later (more expensive) passes
    pending = [i for i in range(n) if not short[i]]
    for c in targets:
        for direction in ("fwd", "bwd"):
            if not pending:
                break
            if direction == "fwd":
                tgt = c
                probe = [seqs[i] for i in pending]
            else:
                tgt = c[::-1].copy()
                probe = [seqs[i][::-1].copy() for i in pending]
            # seedability (any head-trial hit) refines unseedable->seeded
            index, _ = build_seedmap(tgt, pattern, max_read_len=len(tgt))
            J = 50
            keys = np.zeros((len(probe), J), np.uint32)
            for k, s in enumerate(probe):
                nj = min(J, max(0, len(s) - 16 + 1))
                if nj:
                    keys[k, :nj] = dna.encode_seeds(s, np.arange(nj))
            keys &= np.uint32(pattern)
            _, cnt = index.lookup_batch(keys.reshape(-1))
            seeded = cnt.reshape(len(probe), J).sum(axis=1) > 0
            for k, ii in enumerate(pending):
                if seeded[k] and cat[ii] == 2:
                    cat[ii] = 1
            rows, _ = map_reads(
                tgt, pattern, probe, ratio, device=device, screen_kernel=screen_kernel
            )
            got = {r[0] for r in rows}
            still = []
            for k, ii in enumerate(pending):
                if k in got:
                    cat[ii] = 0
                else:
                    still.append(ii)
            pending = still
    return {
        "total": int(n),
        "mapped": int((cat == 0).sum()),
        "seeded_only": int((cat == 1).sum()),
        "unseedable": int((cat == 2).sum()),
        "too_short": int((cat == 3).sum()),
        "categories": cat,
    }
