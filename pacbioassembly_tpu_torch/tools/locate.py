"""Batched read->contig locator on PyTorch.

Port of pacbioassembly_tpu/tools/locate.py. Each chunk of triples goes to
the device as one launch of the chosen screening kernel (K1 or K3,
align/screen.py::score_batch, counted as `bitwave_locate` or
`rowdp_locate`); on a CPU device, their plain version.

The reference locator (locator.cpp:41-96) maps each read onto a finished
contig with a sequential triple loop: seed offsets j=0..49, full-contig
seedmap lookup, then one `seq_aligner<40000,6000>(0.15)` DP per candidate,
breaking at the first success. Mapping a read set onto a fixed contig is
embarrassingly parallel, so here ALL (read, seed-offset, candidate) triples
are scored in batched device launches (the same screening kernels as the
assembler) and only the TSV selection/printing stays on host. Output is
identical to the sequential loop: for each read, the first accepted triple
in (j asc, bucket-rank asc) order prints

    nseq  ref_pos  final_cost  len-j  diag_cost        (locator.cpp:85-89)

because acceptance per triple is decision-identical between the batched
scorer and the exact aligner (pinned by the align test suite), and the
first-success selection is order-preserving.
"""

from __future__ import annotations

import itertools
import sys
from typing import Iterable, Optional, TextIO

import numpy as np
import torch

from ..align.screen import score_batch
from ..codec import dna
from ..device import resolve_device
from ..index import SeedIndex, build_seedmap
from ..utils import span

MAX_TRIAL_J = 50   # locator.cpp:74
MIN_READ = 500     # locator.cpp:72
MAXN, MAXM = 40_000, 6_000  # locator.cpp:24-25
CHUNK = 2048       # triples per device launch (bounds the dense batch)
_CALLS = itertools.count(1)  # map_reads calls in this process: the root id of their spans


def _read_triples(
    seqs: list[np.ndarray], index: SeedIndex, pattern: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All (read, j, contig-candidate) probe triples, vectorized, in the
    sequential loop's order: read asc, j asc, bucket rank asc."""
    n = len(seqs)
    J = MAX_TRIAL_J
    keys = np.zeros((n, J), np.uint32)
    ok = np.zeros((n, J), bool)
    for i, seq in enumerate(seqs):
        nj = min(J, max(0, len(seq) - dna.SEED_LEN + 1))
        if nj:
            keys[i, :nj] = dna.encode_seeds(seq, np.arange(nj)) & np.uint32(pattern)
            ok[i, :nj] = True
    lo, cnt = index.lookup_batch(keys.reshape(-1))
    cnt = (cnt.reshape(n, J) * ok).astype(np.int64)
    lo = lo.reshape(n, J).astype(np.int64)

    rows, cols = np.nonzero(cnt)  # row-major: read asc, j asc
    if len(rows) == 0:
        z = np.empty(0, np.int64)
        return z, z, z
    m = cnt[rows, cols]
    starts = lo[rows, cols]
    rank = np.arange(int(m.sum()), dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(m)[:-1]]), m
    )
    cand = index.positions[np.repeat(starts, m) + rank].astype(np.int64)
    return np.repeat(rows, m), np.repeat(cols, m), cand


def map_reads(
    contig_codes: np.ndarray,
    pattern: int,
    seqs: Iterable[np.ndarray],
    ratio: float,
    *,
    device: str | torch.device = "cuda",
    screen_kernel: str = "bitwave",
) -> tuple[list[tuple[int, int, int, int, int]], int]:
    """Core of the locator: map each read onto the contig and return
    ([(nseq, ref_pos, final_cost, len-j, diag_cost)] for each read's first
    accepted mapping, number_of_reads_processed). Decision- and
    order-identical to the reference's sequential loop (locator.cpp:68-92).
    Scores on `device` with the screening kernel `screen_kernel`.

    The call is the span locate.map_reads (its count the reads
    processed), with the children locate.index (the whole-contig seedmap),
    locate.triples (the probe triples and their lengths; count: triples),
    one locate.fill (the host a/b matrices) and one locate.score (the
    copies, the kernel and the fetch) a chunk, and locate.select (the
    first hit of each read)."""
    with span("locate.map_reads", root=next(_CALLS)) as call:
        rows, nproc = _map_reads(contig_codes, pattern, seqs, ratio, device, screen_kernel)
        call.n = nproc
    return rows, nproc


def _map_reads(contig_codes, pattern, seqs, ratio, device, screen_kernel):
    """map_reads inside its span."""
    dev = resolve_device(device)
    seqs = list(seqs)
    with span("locate.index"):
        index, _ = build_seedmap(contig_codes, pattern, max_read_len=len(contig_codes))
    # reads under 500 bp are skipped WITHOUT counting (locator.cpp:72
    # `continue` jumps over the ++nseq as well)
    big = [s for s in seqs if len(s) >= MIN_READ]

    clen = len(contig_codes)
    with span("locate.triples") as triples:
        tri_read, tri_j, tri_cand = _read_triples(big, index, pattern)
        la_all = np.array([len(big[r]) for r in tri_read], np.int64) - tri_j
        lb_all = clen - tri_cand
        triples.n = len(tri_read)

    # one result slot per triple; scored bucket-by-bucket, chunked
    accept = np.zeros(len(tri_read), bool)
    cost = np.zeros(len(tri_read), np.int64)
    diag = np.zeros(len(tri_read), np.int64)
    mb = np.zeros(len(tri_read), np.int64)

    # bucket by the a-side (read segment) length; roles are flipped vs the
    # assembler (a=read segment, b=contig suffix — locator.cpp:85 aligns
    # (&ac_seg, &ac_ref)), so rows bound = seg bucket cap and the b matrix
    # carries la_max + w_max + 1 columns (the kernel clamps len_b to
    # len_a + max_dst; raw lb is passed as the scalar length)
    BUCKETS = np.array([256, 512, 1024, 2048, 4096, 8192, 16384, 20001, MAXN])
    cap_of = BUCKETS[np.searchsorted(BUCKETS, la_all, side="left")] if len(la_all) else la_all
    order = np.arange(len(tri_read))
    for cap in np.unique(cap_of).tolist():
        w = 1 + int(np.floor(cap * ratio))
        sel = order[cap_of == cap]
        LBm = cap + w + 1
        for s in range(0, len(sel), CHUNK):
            part = sel[s : s + CHUNK]
            B = len(part)
            with span("locate.fill"):
                a_mat = np.zeros((B, cap), np.uint8)
                b_mat = np.zeros((B, LBm), np.uint8)
                la = np.zeros(B, np.int32)
                lb = np.zeros(B, np.int32)
                for bi, t in enumerate(part):
                    seq = big[tri_read[t]]
                    seg = seq[tri_j[t] :]
                    a_mat[bi, : len(seg)] = seg
                    c0 = int(tri_cand[t])
                    bslice = contig_codes[c0 : c0 + LBm]
                    b_mat[bi, : len(bslice)] = bslice
                    la[bi] = len(seg)
                    lb[bi] = clen - c0
            with span("locate.score"):
                res = score_batch(
                    *(torch.from_numpy(x).to(dev) for x in (a_mat, la, b_mat, lb)),
                    screen_kernel=screen_kernel, kind="locate",
                    la_max=cap, w_max=w, ratio=ratio, maxn=MAXN, maxm=MAXM,
                )
                accept[part] = res.accept.cpu().numpy()
                cost[part] = res.cost.cpu().numpy()
                diag[part] = res.diag_cost.cpu().numpy()
                mb[part] = res.matlen_b.cpu().numpy()

    with span("locate.select"):
        # first accepted triple per read, in (j, rank) order == triple order
        hit = accept & (mb > 0)
        first: dict[int, int] = {}
        for t in np.nonzero(hit)[0].tolist():
            r = int(tri_read[t])
            if r not in first:
                first[r] = t

        rows = []
        for nseq in range(len(big)):
            t = first.get(nseq)
            if t is not None:
                ln = len(big[nseq]) - int(tri_j[t])
                rows.append(
                    (nseq, int(tri_cand[t]), int(cost[t]), ln, int(diag[t]))
                )
    return rows, len(big)


def locate_batched(
    contig_codes: np.ndarray,
    pattern: int,
    seqs: Iterable[np.ndarray],
    ratio: float,
    out: Optional[TextIO] = None,
    log: Optional[TextIO] = None,
    *,
    device: str | torch.device = "cuda",
    screen_kernel: str = "bitwave",
) -> int:
    """Batched-device equivalent of the locator main loop. `seqs` are ALL
    stdin words as code arrays; reads under 500 bp are skipped without
    counting (locator.cpp:72).

    out/log default to the CURRENT sys.stdout/sys.stderr at call time —
    an import-time `out=sys.stdout` default freezes whatever stream object
    exists when this module is first imported, which silently bypasses
    stream redirection done later (pytest capsys exposed this when a new
    test module started importing us at collection time)."""
    out = sys.stdout if out is None else out
    log = sys.stderr if log is None else log
    rows, nproc = map_reads(
        contig_codes, pattern, seqs, ratio, device=device, screen_kernel=screen_kernel
    )
    for nseq, pos, c, ln, dg in rows:
        out.write(f"{nseq}\t{pos}\t{c}\t{ln}\t{dg}\n")
    print(f"totally {nproc} sequences processed", file=log)
    return 0


def residual_error(
    contig_codes: np.ndarray,
    pattern: int,
    seqs: Iterable[np.ndarray],
    ratio: float = 0.15,
    *,
    device: str | torch.device = "cuda",
    screen_kernel: str = "bitwave",
) -> dict:
    """The reference's contig-quality measurement (doc/final.tex:266-277):
    map low-error reads onto the contig with the locator and report the
    per-base residual = total alignment cost / total matched length over
    each read's first accepted mapping (its published raw-error contig
    scored 0.1219 by this method). Returns
    {mapped, total, residual_error, mean_cost_per_read_base}."""
    rows, nproc = map_reads(
        contig_codes, pattern, seqs, ratio, device=device, screen_kernel=screen_kernel
    )
    return residual_from_rows(rows, nproc)


def residual_from_rows(rows: list[tuple[int, int, int, int, int]], nproc: int) -> dict:
    """residual_error's summary of map_reads' (rows, nproc)."""
    tot_cost = sum(r[2] for r in rows)
    tot_len = sum(r[3] for r in rows)
    return {
        "mapped": len(rows),
        "total": nproc,
        "residual_error": round(tot_cost / tot_len, 4) if tot_len else None,
        "mean_cost_per_read_base": (
            round(float(np.mean([r[2] / r[3] for r in rows])), 4) if rows else None
        ),
        # raw sums so multi-contig assemblies can aggregate one residual
        # over all contigs (sum costs / sum lengths), benchmarks/ecoli_scale.py
        "total_cost": int(tot_cost),
        "total_len": int(tot_len),
    }
