"""Assembly-vs-genome evaluation: genome fraction covered, N50/NG50.

The reference never measured genome coverage — its evaluation was the
locator residual (doc/final.tex:266-277) on a single contig. A
whole-genome multi-contig assembly needs the complementary metric: how
much of the (known, simulated) genome the contigs jointly cover.

Method: anchor exact unique 16-mers. Every genome position whose 16-mer
occurs exactly once in the genome is an unambiguous anchor; each contig's
16-mers are matched against those anchors (vectorized uint32 join — the
same 2-bit seed encoding as the indexer, dna_seq.h:86-96). At the
assembler's residual error rates (<=5%) an exact 16-mer survives every
few bases, so matched anchor positions are dense inside truly assembled
regions; merging them with a generous gap tolerance (default 1 kb,
anchors in correct regions are ~5 bp apart) yields per-contig genome
intervals whose union is the covered fraction. Pure numpy on host — a
one-shot evaluation tool, not a pipeline stage.
"""

from __future__ import annotations

import numpy as np

K = 16


def _kmers(codes: np.ndarray) -> np.ndarray:
    """(len-15,) uint32 2-bit 16-mers (first base in the high bits —
    ordering is irrelevant here, only equality joins)."""
    n = len(codes) - K + 1
    if n <= 0:
        return np.zeros(0, np.uint32)
    km = np.zeros(n, np.uint32)
    c = codes.astype(np.uint32)
    for k in range(K):
        km = (km << np.uint32(2)) | c[k : k + n]
    return km


def _unique_anchors(genome: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(sorted unique-in-genome kmers, their genome positions)."""
    km = _kmers(genome)
    order = np.argsort(km, kind="stable")
    ks = km[order]
    # count occurrences of each kmer value
    new = np.empty(len(ks), bool)
    new[:1] = True
    new[1:] = ks[1:] != ks[:-1]
    grp = np.cumsum(new) - 1
    cnt = np.bincount(grp)
    uniq_mask = cnt[grp] == 1
    return ks[uniq_mask], order[uniq_mask].astype(np.int64)


def contig_intervals(
    contig: np.ndarray,
    anchor_keys: np.ndarray,
    anchor_pos: np.ndarray,
    max_gap: int = 1000,
    min_anchors: int = 8,
) -> list[tuple[int, int]]:
    """Genome intervals [lo, hi) this contig covers: matched anchor
    positions, sorted and merged when consecutive anchors are <= max_gap
    apart; runs with < min_anchors matches are noise and dropped."""
    km = _kmers(contig)
    idx = np.searchsorted(anchor_keys, km)
    idx = np.clip(idx, 0, len(anchor_keys) - 1)
    hit = anchor_keys[idx] == km
    pos = np.unique(anchor_pos[idx[hit]])
    if len(pos) == 0:
        return []
    brk = np.nonzero(np.diff(pos) > max_gap)[0]
    starts = np.concatenate([[0], brk + 1])
    ends = np.concatenate([brk, [len(pos) - 1]])
    out = []
    for s, e in zip(starts, ends):
        if e - s + 1 >= min_anchors:
            out.append((int(pos[s]), int(pos[e]) + K))
    return out


def contig_chains(
    contig: np.ndarray,
    anchor_keys: np.ndarray,
    anchor_pos: np.ndarray,
    min_anchors: int = 8,
    slack: int = 64,
    despike_window: int = 9,
    despike_tol: int = 500,
    micro_max: int = 5000,
) -> tuple[list[dict], list[dict], list[dict]]:
    """Order-respecting collinearity analysis of one contig.

    `contig_intervals` is structurally blind to misassembly: it takes
    np.unique over matched genome positions, so a chimeric, inverted, or
    shuffled contig still scores "covered". This is the complementary,
    order-aware view — the reference's own evaluation was an
    order-respecting per-read alignment (locator.cpp:68-92,
    doc/final.tex:266-277); this applies the same principle contig-wide
    using unique-16-mer anchors.

    Method: matched anchors form (contig_pos, genome_pos) pairs, taken in
    CONTIG order. A correctly assembled (same-strand) region keeps the
    diagonal d = genome_pos - contig_pos locally constant (drifting only
    with indel error). Isolated spurious anchors (an error recreating
    some other genome-unique 16-mer) are removed by a sliding-median
    despike on d; the survivors are split into maximal collinear chains
    wherever the diagonal jumps by more than max(slack, 0.3*dc) between
    consecutive anchors or genome order reverses. Chains shorter than
    min_anchors are noise and dropped.

    Returns (chains, breaks, micro_inserts):
      chains: [{contig: [clo, chi), genome: [glo, ghi), anchors: n}]
      breaks: between consecutive chains, {contig_pos, genome_jump,
        kind: "gap" (forward jump) | "order" (genome goes backward —
        duplication / inversion / shuffle)}. genome_jump is next.glo -
        prev.ghi (bases of genome skipped; large => chimeric join).
      micro_inserts: short foreign excursions — a chain of < micro_max
        contig bases whose FLANKS are mutually collinear (the contig
        resumes the same diagonal after it). These are a handful of
        bases copied from elsewhere in the genome (a mis-voted insertion
        at high error), not a structural join; counting their two
        compensating mega-jumps as chimeric breaks would misread a
        28 bp wart as a Mb-scale misassembly (exactly what the naive
        interval metric did to the r4 CLR headline contig). Reported as
        {contig_pos, len, source: genome pos the bases came from}.
    """
    km = _kmers(contig)
    idx = np.searchsorted(anchor_keys, km)
    idx = np.clip(idx, 0, max(len(anchor_keys) - 1, 0))
    hit = (anchor_keys[idx] == km) if len(anchor_keys) else np.zeros(0, bool)
    cpos = np.nonzero(hit)[0].astype(np.int64)
    if len(cpos) < min_anchors:
        return [], [], []
    gpos = anchor_pos[idx[hit]]
    d = gpos - cpos

    # despike: sliding median of the diagonal over anchor index; anchors
    # whose d deviates > despike_tol from the local median are spurious
    # (the window spans ~w anchors = tens of bases of contig, so true
    # indel drift within it is far below the tolerance)
    w = despike_window
    if len(d) >= w:
        pad = w // 2
        dpad = np.pad(d, (pad, pad), mode="edge")
        med = np.median(
            np.lib.stride_tricks.sliding_window_view(dpad, w), axis=1
        )
        keep = np.abs(d - med) <= despike_tol
        cpos, gpos, d = cpos[keep], gpos[keep], d[keep]
    if len(cpos) < min_anchors:
        return [], [], []

    dc = np.diff(cpos)
    dg = np.diff(gpos)
    jump_tol = np.maximum(slack, (0.3 * dc).astype(np.int64))
    ok = (dg > 0) & (np.abs(dg - dc) <= jump_tol)
    brk = np.nonzero(~ok)[0]
    starts = np.concatenate([[0], brk + 1])
    ends = np.concatenate([brk, [len(cpos) - 1]])

    chains = []
    for s, e in zip(starts, ends):
        if e - s + 1 < min_anchors:
            continue
        chains.append({
            "contig": [int(cpos[s]), int(cpos[e]) + K],
            "genome": [int(gpos[s]), int(gpos[e]) + K],
            "anchors": int(e - s + 1),
        })
    def collinear(a, b):
        jc = b["contig"][0] - a["contig"][1]
        jg = b["genome"][0] - a["genome"][1]
        return abs(jg - jc) <= max(slack, int(0.3 * abs(jc)))

    def merge_collinear(chs):
        """Re-merge adjacent chains on the same diagonal: a spurious
        anchor inside despike_tol splits a true chain in two (its own
        1-anchor "chain" was dropped above); the flanks stay mutually
        collinear, which a real chimeric join never is."""
        out = []
        for ch in chs:
            if out and collinear(out[-1], ch):
                a = out[-1]
                a["contig"][1] = ch["contig"][1]
                a["genome"][1] = ch["genome"][1]
                a["anchors"] += ch["anchors"]
            else:
                out.append(ch)
        return out

    chains = merge_collinear(chains)

    def genome_continuous(a, b):
        # |genome gap across the excursion| small: the contig resumes
        # (nearly) the genome position where it left off. The contig-side
        # jump jc includes the foreign bases, so the tolerance keys on it.
        jc = b["contig"][0] - a["contig"][1]
        jg = b["genome"][0] - a["genome"][1]
        return abs(jg) <= max(slack, int(0.3 * abs(jc)))

    # excursion removal: a SHORT chain whose removal leaves the genome
    # walk continuous is a foreign micro-insert, not a structural join —
    # remove it, record it, and force-merge the flanks (their diagonals
    # differ by exactly the insert length, so `collinear` would not)
    micro = []
    changed = True
    while changed:
        changed = False
        for i in range(1, len(chains) - 1):
            ch = chains[i]
            if (
                ch["contig"][1] - ch["contig"][0] < micro_max
                and genome_continuous(chains[i - 1], chains[i + 1])
            ):
                micro.append({
                    "contig_pos": int(ch["contig"][0]),
                    "len": int(ch["contig"][1] - ch["contig"][0]),
                    "source": int(ch["genome"][0]),
                })
                a, b = chains[i - 1], chains[i + 1]
                a["contig"][1] = b["contig"][1]
                a["genome"][1] = b["genome"][1]
                a["anchors"] += b["anchors"]
                del chains[i : i + 2]
                changed = True
                break
    breaks = []
    for a, b in zip(chains, chains[1:]):
        jump = b["genome"][0] - a["genome"][1]
        breaks.append({
            "contig_pos": int(a["contig"][1]),
            "genome_jump": int(jump),
            "kind": "gap" if jump >= 0 else "order",
        })
    return chains, breaks, micro


def _union_len(intervals: list[tuple[int, int]]) -> int:
    if not intervals:
        return 0
    iv = sorted(intervals)
    total, lo, hi = 0, iv[0][0], iv[0][1]
    for a, b in iv[1:]:
        if a > hi:
            total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return total + hi - lo


def _nx(lengths: list[int], denom: int, x: float = 0.5) -> int:
    """N50-style statistic: largest L such that contigs >= L sum to
    >= x * denom (0 when the assembly never reaches the threshold)."""
    acc = 0
    for ln in sorted(lengths, reverse=True):
        acc += ln
        if acc >= x * denom:
            return ln
    return 0


def evaluate_assembly(
    genome: np.ndarray,
    contigs: list[np.ndarray],
    max_gap: int = 1000,
    break_tol: int = 50_000,
) -> dict:
    """Coverage + contiguity + misassembly summary of a multi-contig
    assembly against the known genome. Returns {genome_len, assembly_len,
    genome_covered, genome_fraction, n50, ng50, misassemblies, max_break,
    per_contig: [{len, intervals, genome_span, chains, breaks, n_breaks,
    n_misassemblies}]}.

    A misassembly is a collinearity break whose genome jump exceeds
    break_tol (forward chimeric join) or whose genome order reverses by
    more than break_tol (shuffle/duplication) — see contig_chains."""
    keys, pos = _unique_anchors(genome)
    per = []
    all_iv = []
    n_mis = 0
    max_break = 0
    for c in contigs:
        iv = contig_intervals(c, keys, pos, max_gap=max_gap)
        all_iv.extend(iv)
        chains, breaks, micro = contig_chains(c, keys, pos)
        mis = [b for b in breaks if abs(b["genome_jump"]) > break_tol]
        n_mis += len(mis)
        if breaks:
            max_break = max(
                max_break, max(abs(b["genome_jump"]) for b in breaks)
            )
        per.append({
            "len": int(len(c)),
            "intervals": [[int(a), int(b)] for a, b in iv],
            "genome_span": int(sum(b - a for a, b in iv)),
            "chains": chains,
            "breaks": breaks,
            "micro_inserts": micro,
            "n_breaks": len(breaks),
            "n_misassemblies": len(mis),
        })
    covered = _union_len(all_iv)
    lens = [len(c) for c in contigs]
    return {
        "genome_len": int(len(genome)),
        "assembly_len": int(sum(lens)),
        "genome_covered": int(covered),
        "genome_fraction": round(covered / max(len(genome), 1), 4),
        "n50": _nx(lens, sum(lens)),
        "ng50": _nx(lens, len(genome)),
        "misassemblies": n_mis,
        "max_break": int(max_break),
        "break_tol": break_tol,
        "per_contig": per,
    }
