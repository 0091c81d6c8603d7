#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pacbioassembly_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels [--port DIR]    # only the kernels against their plain versions (2)
    python3 chip_smoke.py --k1-slice [--port DIR]   # only the K1 slice of 3 (profiled rounds too), of DIR's port
    python3 chip_smoke.py --k1-slice --parallel-commit   # the same with the two-thread host commit
    python3 chip_smoke.py --k3-slice [--port DIR]   # only the K3 slice of 4 and locate through K3
    python3 chip_smoke.py --contigs-path [--port DIR]   # only the multi-contig path of 8
    python3 chip_smoke.py --mesh-path [--port DIR]      # only the mesh phase of 9 (mesh paths too)
    python3 chip_smoke.py --genome [3pct|clr] [--out DIR [--resume]]  # a whole 4.6 Mb genome

Builds the CUDA kernels from csrc/ with nvcc at first use, then:

  1. device: the card's name, power limit and top SM clock (nvidia-smi), the
     build time and ptxas's report (registers, shared memory, stack, spills)
     of every kernel, K1's thread build on a line of its own (and in every
     mode);
  2. kernels vs plain versions on the card, exact equality, on simulated
     overlaps at 3% and 15% error plus random non-overlaps: the screening
     kernels K1 (bitwave.cu) and K3 (wavefront.cu) at the prefilter geometry
     (LB=128, W=58, R=0.45; B=4096, and B=32768 as on the main path) and at
     the 2048, 4096 and 8192 full-screen buckets (B=1024, R=0.3), K3 also
     held equal to K1 field by field; K2 (tbwave.cu) and W (walk.cu) at Bp=32 in the same three
     buckets; a 256-pair sample against the native host aligner; then each
     kernel's launch shapes: K1's thread path at 16, 32 and 64 pairs a
     block and its warp path at the prefilter's 2 words a stripe (B =
     32,768, 4,096 and 1,024), K2 at each lanes-per-thread shape, and K3
     at each lanes-per-thread shape on both sides of its warp/block cutover
     at the paths' geometries, each equal to the wrapper's choice;
  3. the main path with K1 at E. coli scale: 4.6 Mb at 30x, reads of mean
     2,500, 3% uniform error, seed 11; BatchAssembler on cuda, rng_seed 7,
     round-robin over tests/data/seeds.txt, 60 rounds (more if no round has
     yet reached the prefilter's candidate threshold); every kernel of the
     path must have launched and no plain version. Its state is kept, then
     a few more rounds run under torch.profiler (the engine's profile_dir):
     the card's busy share and device time by kernel, and what fills a
     prefilter pass (host vectors, the on-device gather, the screening call,
     the fetch; on the card the screening kernel, PyTorch's kernels and
     copies);
  4. the row-DP path: the same read store, trial-seed cache and device read
     matrix, screen_kernel="rowdp", as many rounds; K3 and K2/W launch, no
     K1 and no plain version, and its RoundStats, contig bytes, votes and
     surviving reads equal the K1 path's kept state. Then 10 more rounds
     under torch.profiler, for K3's device time;
  5. locate on the card: 2,000 reads (1,500 the row-DP path consumed, 500
     it did not) mapped onto its contig, pattern 1 of seeds.txt, R=0.15,
     through K3 and through K1: equal TSVs, the first 100 reads equal the
     sequential host loop, residual error and wall time of each;
  6. every kernel variant the paths of 3-5 and 8-11 launched, held against
     its plain version on the inputs of its first launches, at the paths'
     own shapes, and K3's variants at each of its launch shapes equal to the
     wrapper's choice on those inputs (8-11 run before 6 and 7);
  7. the same port on cuda and on cpu, 8 rounds of a 60 kb genome: equal
     contig bytes, votes and surviving reads;
  8. multi-contig assembly through the CLI (`assemble --engine batch
     --device cuda --contigs N`, stdout and stderr captured), each contig
     run to its natural end, on (a) 300 kb at 30x, mean read 2,500, 3%
     uniform error, seed 11, 8 contigs: per contig its length, reads,
     rounds, wall time, s/round p50/p95 and the card's allocated memory
     after it (which must not grow), the dedupe's dropped contigs, the kept
     contigs' genome fraction, N50 and misassemblies (tools/coverage.py;
     gates: fraction >= 0.9, no misassembly) and the largest contig's
     residual error against CCS-like reads on the card; (b) 150 kb at 30x,
     15% CLR-profile error, 4 contigs, the same per contig, then every
     surviving read accounted for on the card (tools/postprocess.py::
     classify_reads; gate: the four categories sum to the survivors). K1
     (prefilter, full screen, locate), K2 and W must have launched, no
     plain version; phase 6 replays this path's variants too. Then (c)
     the two-segment store of tests/test_batch.py::test_multi_contig_assembly,
     4 contigs, without and with dedupe, on cuda and on cpu: equal
     ContigResults and surviving reads;
  9. the multi-device round: (a) the engine on a 2-shard mesh of the card
     (`make_mesh(devices=[cuda:0, cuda:0])`) on the slice's read store for
     MESH_ROUNDS rounds: the single-device round with each full screen
     split into two shards and the elect summed over them; its RoundStats,
     contig bytes, votes and surviving reads must equal the K1 slice's at
     that round (recorded in 3), s/round beside the slice's; K1 (prefilter
     and full screen), K2 and W must have launched, no plain version, and
     K1's full screen twice a screening launch;
     (b) two gloo processes on 127.0.0.1 (tests/torch_multihost_worker.py),
     two shards each on the card: the sharded screen and summed elect equal
     the serial port on both; (c) align/traceback.py on the card == its CPU
     run, align/bitscan.py on the card == K1, and the device seed index and
     device evolve on the K1 slice's round-60 contig and reference (before
     its evolve) == the host build_seedmap / lookup_batch and evolve, each
     timed beside the host function; (d) the mesh paths: the three paths
     of the multi-device dry run (tests/torch_mesh_paths.py: two 6 kb
     segments at 10x, 2% error, edge retreat 2 with 48-cell bites) on 2
     shards of the card, on 1 shard of the card and on the cpu, all equal:
     the retreat run (10 rounds, 2 retreats), assemble_contigs(..., 3,
     dedupe=True, mesh=) (2 contigs kept), and a checkpoint at round 2
     resumed to round 6 (rng_seed 5) == 6 uninterrupted rounds, the 2-shard
     checkpoint resumed on one shard too; the retreat run once more with
     the prefilter forced on, 2 shards == 1 shard; per path its wall time,
     rounds and s/round on 2 and on 1 shard and its launches by kernel
     variant; K1 (prefilter and full screen), K2 and W must have launched,
     no plain version (path `mesh-paths` in 6);
 10. stall recovery: tests/torch_retreat.py's fixtures (a), the stall store
     of tests/test_batch.py::test_edge_retreat_recovers_from_stall (its
     weak fringe trimmed after round 19; 20 rounds), and (b), the fruitless
     store of tests/test_batch.py::test_fruitless_retreat_escape (fixed
     bites, then the fruitless escape), on the card and on the port's cpu:
     equal RoundStats, contig bytes, votes, surviving reads, retreat
     counters and logs; a trimmed fringe and a fixed bite on the card; K1's
     full screen, K2 and W must have launched, no plain version (phase 6
     replays this path's variants too);
 11. the engine's branches (tests/torch_branches.py: synth2 with the
     reference's quirks): `-l` (locked: every alignment on the host, no K2
     or W; the output equal to golden_consensus_locked.txt under its
     newline-as-'T' rule), `-d` (ratio 0.25, 16 trials: the dump) and
     device_traceback=False (no K2 or W), on the card and on the cpu: equal
     printed consensus, dump bytes, RoundStats, contig, votes and
     survivors; K1's full screen, K2 and W must have launched, no plain
     version (path `branches` in 6).

`--genome [3pct|clr]` runs the whole-genome path alone, held to a committed
run of the JAX package (GENOME_RUNS): 3pct (the default) to
benchmarks/results/ecoli_wg_3pct_r5, the E. coli store of 3 (4.6 Mb at 30x,
3% uniform error, seed 11), and clr to ecoli_wg_15pct_clr_r5, the same
genome at 15% CLR error (1:12:4 substitutions, insertions, deletions),
the reference's headline experiment. Each is assembled as
benchmarks/ecoli_scale.py ran it (random pattern schedule, rng_seed 7 +
contig, stall recovery --edge-retreat 400 --retreat-bite 96
--retreat-min-len 20000 --retreat-fruitless 3, up to 64 contigs sharing the
trial cache and the device builder, checkpoints every 50 rounds), every
round of every contig held to the committed metrics on nround, pattern,
ref_len, nmatches, ntrials, nreads_left and retreats (the first divergent
round stops the run and prints both rows; the other fields print where
they differ), each contig ending on its committed last round. Then the
end gates of ecoli_scale.py against the committed summary: the dedupe's
dropped contigs, the reads consumed and surviving, the rounds of the kept
contigs; contig 0 (3pct) or every kept contig (clr, the assembly FASTA)
byte for byte; the residual error of the largest kept contig and of each of
50 kb or more with their aggregate, on the card; the coverage evaluation
holding them; the surviving reads classified on the card
(tools/postprocess.py::classify_reads). Last, every kernel variant the run
launched against its plain version, and a `genome` JSON line (per contig
records, phase sums, gate results, launches, kernel rows). With `--out DIR`
the checkpoints, metrics JSONL, engine log and the residual and
classification results stay in DIR, and `--resume` goes on from its
finished contigs, the current contig's round checkpoint and the end gates
already computed (held to the committed values, not recomputed).

Kernel times are CUDA events: a kernel's is the min over fresh inputs of
its wrapper's launches queued behind a spin kernel, so that the host's
enqueueing stays out of it (the wrapper's time on an idle card, host
overhead included, is printed beside it); a plain version's is its one
checked run (each plain version runs once on a tiny batch first, so that
PyTorch's lazy kernel loading stays out of the timed runs). Each kernel's bound is the larger of the bytes its
function must move over 3.35 TB/s and the integer operations of the least
work known for its function on these inputs (`bound_work`: the same count
for K1 and K3, over each pair's own band and its rows up to failure or
len_a) over 132 SMs x 64 INT32 lanes x the top SM clock. Prints one JSON line of kernel results, the
nvidia-smi line, and last `{"ok": true, "device": {...}}`. Any failure
exits non-zero before that. Needs no network and imports no JAX, and
nothing of the JAX package: only the port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEEDS = os.path.join(REPO, "tests", "data", "seeds.txt")
BUCKETS = (2048, 4096, 8192)  # full-screen buckets the E. coli slice launches at
PROFILED_ROUNDS = {"bitwave": 10, "rowdp": 10}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT32_LANES = 132 * 64     # SMs x INT32 lanes per SM
QUEUE_CYCLES = 10_000_000  # ~5 ms of spinning ahead of a timed kernel (timed)


def log(*a):
    print(*a, flush=True)


def nvidia_smi(fields="name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed(torch, fn, x, queued=False):
    """(card ms, result) of fn(x), by CUDA events. With `queued`, a spin
    kernel keeps the card busy while the host enqueues the events and fn's
    launches, so the time is the card's alone; without, it also holds
    whatever the card waits for the host (a wrapper's own overhead)."""
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    s.record()
    out = fn(x)
    e.record()
    e.synchronize()
    return s.elapsed_time(e), out


def max_err(torch, k, p) -> int:
    """Max |kernel - plain| over paired tensors."""
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) for x, y in zip(k, p))


def make_pairs(rng, n, LB, LA, err_mix=(0.03, 0.15), random_share=0.34):
    """Screening candidates like the engine's: a = the reference from the
    seed on (length up to LA), b = a read segment from the same genome
    position with simulated errors (or an unrelated segment)."""
    from pacbioassembly_tpu_torch.tools.simulate import SimConfig, mutate_read

    A = np.zeros((n, LA), np.uint8)
    Bm = np.zeros((n, LB), np.uint8)
    la = np.zeros(n, np.int32)
    lb = np.zeros(n, np.int32)
    n_rand = int(n * random_share)
    for i in range(n):
        src = rng.integers(0, 4, LA + LB).astype(np.uint8)
        seg_len = int(rng.integers(LB // 2, LB + 1))
        if i < n_rand:
            seg = rng.integers(0, 4, seg_len).astype(np.uint8)
        else:
            e = err_mix[i % len(err_mix)]
            cfg = SimConfig(sub_rate=e / 3, ins_rate=e / 3, del_rate=e / 3)
            seg = mutate_read(src[: seg_len + LB // 4], cfg, rng)[:seg_len]
        a_len = int(rng.integers(max(1, LB // 4), LA + 1))
        A[i, :a_len] = src[:a_len]
        Bm[i, : len(seg)] = seg
        la[i], lb[i] = a_len, len(seg)
    perm = rng.permutation(n)
    return A[perm], la[perm], Bm[perm], lb[perm]


# ----------------------------------------------------------------- bounds


def _screen_geometry(torch, a, la, b, lb, kw):
    """Per-pair (md, len_a, len_b, ok_size) of a screening launch, as the
    kernels compute them."""
    from pacbioassembly_tpu_torch.align.scan import pair_geometry, threshold_tensors
    from pacbioassembly_tpu_torch.config import Constants

    tab_len = max(kw["la_max"], a.shape[1], b.shape[1]) + 1
    _, _, band_tab = threshold_tensors(kw["ratio"], tab_len, str(la.device))
    md, len_a, len_b = pair_geometry(la.to(torch.int32), lb.to(torch.int32), band_tab, tab_len)
    maxn = kw.get("maxn", Constants.ALIGNER_MAXN)
    maxm = kw.get("maxm", Constants.ALIGNER_MAXM)
    ok = (len_a < maxn + maxm) & (md < maxm) & (md <= kw["w_max"]) & (len_a <= kw["la_max"])
    return md.double(), len_a.double(), len_b.double(), ok


# int32 operations of the least work known for each function, whichever
# kernel computes it (a 64-bit operation counts as two int32 operations)
CELL_OPS = 6     # one DP cell: the match compare, three adds, two mins
WORD_OPS = 34    # one 64-cell word of a bit-parallel (Myers) step: 17 64-bit ops
PARENT_OPS = 4   # a cell's parent choice: two compares, a select, the 2-bit pack


def bound_work(torch, kernel, args, kw, out) -> tuple[float, float]:
    """(bytes, int32 operations) the kernel's function needs on these
    inputs, the same for every kernel that computes it: each input read
    once, each output written once; operations over each pair's own band
    of 2md+1 lanes and the rows these inputs really run (the scan's
    dp_rows: up to failure or len_a, 0 when size-rejected). Screening takes
    per pair the lower of a plain DP (CELL_OPS a cell) and a bit-parallel
    one (WORD_OPS a 64-lane word); set-up (the match masks, the goal
    search) is left out, so the count stays below the least work."""
    nbytes = float(sum(t.numel() * t.element_size() for t in args))
    if kernel.startswith(("bitwave", "rowdp")):
        a, la, b, lb = args
        md, _, _, ok = _screen_geometry(torch, a, la, b, lb, kw)
        rows = out.dp_rows.double()
        band = 2 * md + 1
        nbytes += 6 * 4 * la.numel()
        ops = rows * torch.minimum(CELL_OPS * band, WORD_OPS * torch.ceil(band / 64))
        ops = float(torch.where(ok, ops, torch.zeros_like(ops)).sum())
    elif kernel == "tbwave":
        from pacbioassembly_tpu_torch.align.tbwave import _geometry

        parents, _, _ = out
        a, la, b, lb = args
        NRB = parents.shape[1]
        nbytes += parents.numel() * 4
        md, len_a, _ = _geometry(la, lb, kw["la_max"], a.shape[1], b.shape[1], kw["ratio"])
        rows = torch.clamp(len_a.double(), max=NRB * 16)
        band = 2 * torch.clamp(md.double(), max=kw["w_max"]) + 1
        ops = float((rows * band * (CELL_OPS + PARENT_OPS)).sum())
    else:  # walk: ~20 operations per edit
        ops_t, vals_t, nedit = out
        nbytes += ops_t.numel() + vals_t.numel() + nedit.numel() * 4
        nbytes += 4 * (walk_words(torch, args, kw, out) - args[0].numel())
        ops = float(nedit.double().sum() * 20)
    return nbytes, ops


def walk_words(torch, args, kw, out) -> int:
    """The parent words a walk must read: the distinct (row block, lane)
    words under the cells it stepped back from, rebuilt from its edit
    stream (row 0 is analytic and reads none)."""
    P, matlen_a, matlen_b = args[0], args[4], args[5]
    ops_t, _, nedit = out
    B, NRB, S = P.shape
    E = ops_t.shape[1]
    op = ops_t.long()
    live = torch.arange(E, device=op.device)[None, :] < nedit[:, None].long()
    # the cell before edit e of the forward stream, counted back from the goal
    di = torch.flip(torch.cumsum(torch.flip((live & (op != 2)).long(), [1]), 1), [1])
    dj = torch.flip(torch.cumsum(torch.flip((live & (op != 3)).long(), [1]), 1), [1])
    i = matlen_a.long()[:, None] - di + (live & (op != 2)).long()
    j = matlen_b.long()[:, None] - dj + (live & (op != 3)).long()
    # and the cell the walk stopped on, where a parent of 0 ended it (not
    # the 32-edit block stop at E)
    i = torch.cat([i, (matlen_a.long() - di[:, 0])[:, None]], 1)
    j = torch.cat([j, (matlen_b.long() - dj[:, 0])[:, None]], 1)
    stop = args[6].bool() & (nedit < E // 32 * 32)
    live = torch.cat([live, stop[:, None]], 1) & (i > 0)
    rb = torch.clamp((i - 1) >> 4, max=NRB - 1)
    k = torch.clamp(j - i + kw["w_max"], 0, S - 1)
    q = torch.arange(B, device=op.device)[:, None]
    return int(torch.unique(((q * NRB + rb) * S + k)[live]).numel())


class Results:
    """Per kernel: the largest error seen and the timed shapes."""

    def __init__(self, clock_mhz: float):
        self.err: dict[str, int] = {}
        self.rows: list[dict] = []
        self.int_rate = INT32_LANES * clock_mhz * 1e6

    def add(self, torch, kernel, where, shape, err, times, plain_ms, args, kw, out):
        ms, wrapper_ms = times  # _kernel_ms
        if err != 0:
            raise AssertionError(f"{kernel} ({where}, {shape}): kernel != plain (max abs err {err})")
        nbytes, ops = bound_work(torch, kernel, args, kw, out)
        t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / self.int_rate
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        self.err[kernel] = max(self.err.get(kernel, 0), err)
        self.rows.append(dict(kernel=kernel, where=where, shape=shape, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound, bound_by=by, wrapper_ms=wrapper_ms))
        log(f"[kernels:{where}] {kernel} {shape}: equal; kernel {ms:.4f} ms (wrapper on an idle "
            f"card {wrapper_ms:.4f} ms), plain "
            f"{plain_ms:.3f} ms, bound {bound:.4f} ms by {by} ({nbytes / 1e6:.2f} MB, "
            f"{ops / 1e9:.3f} G int ops)")


def _kernel_ms(torch, fn, items):
    """(kernel ms, wrapper ms): min card time over the fresh inputs that
    share the first input's static arguments (the first itself when none
    does), of the wrapper's launches queued behind a spin kernel (the
    card's time alone) and of the wrapper called on an idle card (its host
    overhead included)."""
    same = [x for x in items[1:] if x[1] == items[0][1]] or items[:1]
    return tuple(min(timed(torch, lambda x: fn(*x[0], **x[1]), x, queued=q)[0] for x in same)
                 for q in (True, False))


def screen_fn(name):
    """A screening kernel's wrapper, looked up at call time (the main-path
    input keeper swaps these module attributes)."""
    from pacbioassembly_tpu_torch.align import bitwave, wavefront

    return bitwave.batch_score_bitwave if name == "bitwave" else wavefront.batch_score_rowdp


def check_score(torch, res, kernel, kind, items, where, shape, plain=None):
    """A screening kernel (bitwave or rowdp) against the plain row DP:
    exact on the first of `items`, a list of (args, kwargs). `plain` is
    (scores, ms) of the plain version on those inputs when already run.
    Returns (plain scores, plain ms, kernel scores)."""
    from pacbioassembly_tpu_torch.align import scan

    args, kw = items[0]
    fn = screen_fn(kernel)
    k = fn(*args, kind=kind, **kw)
    if plain is None:
        plain_ms, p = timed(torch, lambda x: scan.batch_score(*x, **kw), args)
    else:
        p, plain_ms = plain
    ms = _kernel_ms(torch, lambda *a, **k_: fn(*a, kind=kind, **k_), items)
    res.add(torch, f"{kernel}_{kind}", where, shape, max_err(torch, k, p), ms, plain_ms,
            args, kw, k)
    return p, plain_ms, k


def check_parents(torch, res, items, where, shape):
    """K2 against the plain parents DP (plane, md, len_b)."""
    from pacbioassembly_tpu_torch.align import tbwave

    args, kw = items[0]
    k = tbwave.batch_parents(*args, **kw)
    plain_ms, p = timed(torch, lambda x: tbwave.batch_parents_plain(*x, **kw), args)
    ms = _kernel_ms(torch, tbwave.batch_parents, items)
    res.add(torch, "tbwave", where, shape, max_err(torch, k, p), ms, plain_ms, args, kw, k)


def check_walk(torch, res, items, where, shape):
    """W against the plain walk on the same planes and goal cells."""
    from pacbioassembly_tpu_torch.align import tbwave

    args, kw = items[0]
    k = tbwave.walk_parents(*args, **kw)
    plain_ms, p = timed(torch, lambda y: tbwave.walk_parents_plain(*y, **kw), args)
    ms = _kernel_ms(torch, tbwave.walk_parents, items)
    res.add(torch, "walk", where, shape, max_err(torch, k, p), ms, plain_ms, args, kw, k)


def warm_plain(torch, dev):
    """Run each plain version once on a tiny batch: their first use loads
    PyTorch's kernels, which must stay out of the timed runs."""
    from pacbioassembly_tpu_torch.align import scan, tbwave

    x = tuple(torch.from_numpy(v).to(dev) for v in make_pairs(np.random.default_rng(0), 8, 64, 96))
    kw = dict(la_max=96, w_max=20, ratio=0.3)
    sc = scan.batch_score(*x, **kw)
    pp, md, lb_dp = tbwave.batch_parents_plain(*x, **kw)
    tbwave.walk_parents_plain(pp, x[2], lb_dp, md, sc.matlen_a, sc.matlen_b, sc.accept,
                              w_max=20, e_max=182)
    torch.cuda.synchronize()


def phase_kernels(torch, dev, res):
    from pacbioassembly_tpu_torch.align import scan, tbwave
    from pacbioassembly_tpu_torch.align.dispatch import exact_align
    from pacbioassembly_tpu_torch.align.screen import size_bucket
    from pacbioassembly_tpu_torch.native import pbcore

    warm_plain(torch, dev)
    rng = np.random.default_rng(2024)

    def up(batch):
        return tuple(torch.from_numpy(x).to(dev) for x in batch)

    # the prefilter at the main path's batch (B = 32,768) draws from a
    # generator of its own, so that the other shapes keep earlier runs' inputs
    geoms = ([("prefilter", 4096, 128, 0.45, rng),
              ("prefilter", 32768, 128, 0.45, np.random.default_rng(2025))]
             + [("fullscreen", 1024, c, 0.3, rng) for c in BUCKETS])
    for kind, B, LB, ratio, gen in geoms:
        if kind == "prefilter":
            W = 1 + int(LB * ratio)
            LA = LB + W + 1
        else:
            LB, LA, W = size_bucket(LB, ratio)
        batches = [up(make_pairs(gen, B, LB, LA)) for _ in range(4)]
        kw = dict(la_max=LA, w_max=W, ratio=ratio)
        shape = f"B={B} LA={LA} LB={LB} W={W} R={ratio}"
        items = [(x, kw) for x in batches]
        p, plain_ms, k1 = check_score(torch, res, "bitwave", kind, items, "synthetic", shape)
        _, _, k3 = check_score(torch, res, "rowdp", kind, items, "synthetic", shape,
                               plain=(p, plain_ms))
        if max_err(torch, k3, k1) != 0:
            raise AssertionError(f"{shape}: K3 != K1")
        n_acc = int(p.accept.sum())
        failed = int(((~p.accept) & (p.dp_rows > 10) & (p.dp_rows < LB // 2)).sum())
        if not (0 < n_acc < B and failed > 0):
            raise AssertionError(f"{shape}: degenerate inputs ({n_acc} of {B} accepted, "
                                 f"{failed} early-failed)")
        log(f"[kernels:synthetic] ... K3 == K1 field by field; {n_acc} accepted, "
            f"{failed} early-failed")
        if LB == BUCKETS[0]:
            native = (batches[0], kw, p)

    # native host core on a 256-pair sample of the 2048-bucket batch
    pbcore.load()  # build libpbcore.so now; raises if it cannot
    (A, la, Bm, lb), kw, p = native
    A, la, Bm, lb = (x.cpu().numpy() for x in (A, la, Bm, lb))
    mism = 0
    for i in rng.choice(len(la), 256, replace=False):
        r = exact_align(A[i, : la[i]], Bm[i, : lb[i]], ratio=kw["ratio"])
        got = (bool(p.accept[i]), int(p.cost[i]), int(p.matlen_a[i]), int(p.matlen_b[i]), int(p.diag_cost[i]))
        want = (False,) if r is None else (True, r.cost, r.matlen_a, r.matlen_b, r.diag_cost)
        mism += got[: len(want)] != want
    if mism:
        raise AssertionError(f"{mism} of 256 sampled pairs disagree with the native aligner")
    log("[kernels:synthetic] 256 sampled 2048-bucket pairs agree with the native host aligner")

    # K2 + W: one commit launch (Bp = 32) per bucket, as batch.py sizes it
    for cap in BUCKETS:
        LB, LA, W = size_bucket(cap, 0.3)
        batches = [up(make_pairs(rng, 32, LB, LA, random_share=0.0)) for _ in range(3)]
        rows = min(LA, -(-int(batches[0][1].max()) // 512) * 512)
        rows_pk = -(-rows // 128) * 128
        E = rows_pk + W + 2 + 32
        kw = dict(la_max=LA, w_max=W, ratio=0.3, rows_max=rows_pk)
        shape = f"Bp=32 LA={LA} W={W} rows={rows_pk}"
        check_parents(torch, res, [(x, kw) for x in batches], "synthetic", shape)
        walk_in = []
        for x in batches:
            pk, md, lb_dp = tbwave.batch_parents(*x, **kw)
            sc = scan.batch_score(*x, la_max=LA, w_max=W, ratio=0.3)
            walk_in.append((pk, x[2], lb_dp, md, sc.matlen_a, sc.matlen_b, sc.accept))
        n_acc = int(walk_in[0][6].sum())
        if n_acc < 8:
            raise AssertionError(f"{shape}: only {n_acc} of 32 commit pairs accepted")
        wkw = dict(w_max=W, e_max=E)
        check_walk(torch, res, [(x, wkw) for x in walk_in], "synthetic",
                   f"Bp=32 W={W} E={E} ({n_acc} accepted)")


def phase_kernel_shapes(torch, dev):
    """Each kernel's launch shapes on fresh synthetic batches, every output
    equal to the wrapper's own choice's: K1's thread path at 16, 32 and 64
    pairs a block and its warp path at the prefilter's 2 words a stripe,
    the only width both are built for, K2 at each lanes-per-thread shape
    its plane admits, and K3 at each shape on both paths where its band
    fits."""
    from pacbioassembly_tpu_torch.align import bitwave, tbwave
    from pacbioassembly_tpu_torch.align.screen import size_bucket
    from pacbioassembly_tpu_torch.config import Constants

    rng = np.random.default_rng(77)
    lim = dict(maxn=Constants.ALIGNER_MAXN, maxm=Constants.ALIGNER_MAXM)

    def up(batch):
        return tuple(torch.from_numpy(x).to(dev) for x in batch)

    def fastest(fn, batches):
        return min(timed(torch, fn, x, queued=True)[0] for x in batches for _ in range(2))

    ratio = 0.45
    words = 2
    for B in (32768, 4096, 1024):
        W = 32 * words - 1  # exactly `words` words a stripe
        LB = int((W - 1) / ratio)
        LA = LB + W + 1
        batches = [up(make_pairs(rng, B, LB, LA)) for _ in range(2)]
        kw = dict(la_max=LA, w_max=W, ratio=ratio, **lim)
        auto = bitwave.batch_score_bitwave(*batches[0], **kw)
        ms = {}
        for path, pairs in (("thread", 16), ("thread", 32), ("thread", 64), ("warp", None)):
            def fn(x, path=path, pairs=pairs):
                return bitwave._launch(*x, kind="fullscreen", path=path,
                                       pairs=pairs or bitwave.THREAD_PAIRS, **kw)
            if max_err(torch, fn(batches[0]), auto) != 0:
                raise AssertionError(f"K1 {path} path ({pairs} pairs a block) != the wrapper's "
                                     f"choice (B={B} W={W})")
            ms[f"thread {pairs} pairs a block" if pairs else "warp"] = fastest(fn, batches)
        log(f"[kernels:shapes] K1 B={B} W={W} ({words} words): "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
            + f"; the wrapper takes the thread path at {bitwave.THREAD_PAIRS} pairs a block")
        if B == 32768:
            prefilter_like = (batches, LA, W, ratio)

    # K3 at each (path, lanes) its band admits: the prefilter's geometry (the
    # batches above, 127 band lanes), locate's 1024, 2048 and 4096 buckets
    # (R=0.15) and the full screen's 4096 and 8192 buckets at the main path's B
    k3_geoms = [prefilter_like]
    for B, cap, ratio in ((2048, 1024, 0.15), (2048, 2048, 0.15), (2048, 4096, 0.15),
                          (256, 4096, 0.3), (256, 8192, 0.3)):
        LB, LA, W = size_bucket(cap, ratio)
        k3_geoms.append(([up(make_pairs(rng, B, LB, LA)) for _ in range(2)], LA, W, ratio))
    for batches, LA, W, ratio in k3_geoms:
        log(f"[kernels:shapes] K3 B={len(batches[0][0])} LA={LA} W={W} R={ratio} (band {2 * W + 1}): "
            + k3_shapes(torch, batches, dict(la_max=LA, w_max=W, ratio=ratio)))

    for cap, rows in ((4096, 3584), (8192, 7168)):
        LB, LA, W = size_bucket(cap, 0.3)
        batches = [up(make_pairs(rng, 32, LB, LA, random_share=0.0)) for _ in range(2)]
        kw = dict(la_max=LA, w_max=W, ratio=0.3, rows_max=rows)
        auto = tbwave.batch_parents(*batches[0], **kw)
        S, _ = tbwave.plane_dims(LA, W, rows)
        parts = []
        for lanes in (4, 8, 16):
            if -(-S // lanes) > (1024 if lanes <= 8 else 768):
                continue
            def fn(x, lanes=lanes):
                return tbwave._launch_parents(*x, lanes=lanes, **kw)
            if max_err(torch, fn(batches[0]), auto) != 0:
                raise AssertionError(f"K2 at {lanes} lanes a thread != the wrapper's choice")
            parts.append(f"{lanes} lanes {fastest(fn, batches):.3f} ms")
        log(f"[kernels:shapes] K2 Bp=32 LA={LA} W={W} rows={rows} (S={S}): " + ", ".join(parts))


def k3_shapes(torch, batches, kw, kind="fullscreen", timing=True) -> str:
    """K3 at each (path, lanes) the launch's band admits, each output equal
    to the wrapper's own choice's: with `timing`, their min times over
    `batches`; and the choice, as a log line's tail."""
    from pacbioassembly_tpu_torch.align import wavefront
    from pacbioassembly_tpu_torch.config import Constants

    kw = dict(dict(maxn=Constants.ALIGNER_MAXN, maxm=Constants.ALIGNER_MAXM), **kw)
    auto = wavefront.batch_score_rowdp(*batches[0], kind=kind, **kw)
    md_cap = max(min(kw["w_max"], kw["maxm"] - 1), 0)
    parts = []
    for path, lanes in wavefront.shapes(md_cap):
        def fn(x, path=path, lanes=lanes):
            return wavefront._launch(*x, kind=kind, path=path, lanes=lanes, **kw)
        if max_err(torch, fn(batches[0]), auto) != 0:
            raise AssertionError(f"K3 {path} path at {lanes} lanes != the wrapper's choice ({kw})")
        if timing:
            ms = min(timed(torch, fn, x, queued=True)[0] for x in batches for _ in range(2))
            parts.append(f"{path} {lanes} lanes {ms:.3f} ms")
        else:
            parts.append(f"{path} {lanes} lanes equal")
    path, lanes = wavefront.launch_shape(md_cap)
    return ", ".join(parts) + f"; the wrapper takes {path} {lanes}"


class MainPathInputs:
    """Keeps the inputs of a path's first launches of every kernel variant,
    so that each variant can be held against its plain version at the
    path's own shapes. A variant is one kernel at one static geometry: a
    screening kernel by launch kind and (LA, LB, W, R), K2 by (LA, W), W by
    W. Installs thin wrappers over the kernel wrappers the paths call (the
    screening wrappers' module attributes, which align/screen.py looks up
    at call time, and the names assemble/gather.py and align/traceback.py
    call); each copies its inputs and calls the real wrapper. `kernels`
    limits what is kept."""

    KEEP = 3  # launches kept per variant and batch size

    def __init__(self, kernels=("bitwave", "rowdp", "tbwave", "walk")):
        from pacbioassembly_tpu_torch.align import bitwave, wavefront
        from pacbioassembly_tpu_torch.assemble import gather

        self.kernels = kernels
        self.slots = [(bitwave, "batch_score_bitwave"), (wavefront, "batch_score_rowdp"),
                      (gather, "batch_parents"), (gather, "walk_parents")]
        try:
            from pacbioassembly_tpu_torch.align import traceback
        except ImportError:  # a tree of the port from before align/traceback.py (--port)
            pass
        else:
            self.slots += [(traceback, "batch_parents"), (traceback, "walk_parents")]
        self.real = [getattr(m, n) for m, n in self.slots]
        self.calls: dict = {}   # (kernel, geometry) -> {B: launches}
        self.inputs: dict = {}  # (kernel, geometry, B) -> [(args, kw), ...]
        self.nbytes = 0         # device bytes the kept clones hold

    def _keep(self, kernel, geom, args, kw):
        if not kernel.startswith(self.kernels):
            return
        B = int(args[0].shape[0])
        per_b = self.calls.setdefault((kernel, geom), {})
        per_b[B] = per_b.get(B, 0) + 1
        kept = self.inputs.setdefault((kernel, geom, B), [])
        if len(kept) < self.KEEP:
            kept.append((tuple(x.clone() for x in args), dict(kw)))
            self.nbytes += sum(x.numel() * x.element_size() for x in args)

    def install(self):
        score_k1, score_k3, parents, walk = self.real[:4]

        def screening(name, real):
            def kept(a, la, b, lb, **kw):
                geom = (kw["la_max"], b.shape[1], kw["w_max"], kw["ratio"])
                self._keep(f"{name}_{kw['kind']}", geom, (a, la, b, lb), kw)
                return real(a, la, b, lb, **kw)
            return kept

        def parents_kept(a, la, b, lb, **kw):
            self._keep("tbwave", (kw["la_max"], kw["w_max"]), (a, la, b, lb), kw)
            return parents(a, la, b, lb, **kw)

        def walk_kept(*args, **kw):
            self._keep("walk", (kw["w_max"],), args, kw)
            return walk(*args, **kw)

        wrapped = (screening("bitwave", score_k1), screening("rowdp", score_k3),
                   parents_kept, walk_kept, parents_kept, walk_kept)
        for (mod, name), fn in zip(self.slots, wrapped):
            setattr(mod, name, fn)

    def remove(self):
        for (mod, name), fn in zip(self.slots, self.real):
            setattr(mod, name, fn)

    def variants(self):
        """(kernel, geometry, launches, modal B, kept inputs at that B)."""
        for (kernel, geom), per_b in sorted(self.calls.items(), key=lambda kv: str(kv[0])):
            B = max(per_b, key=lambda b: (per_b[b], b))
            yield kernel, geom, sum(per_b.values()), B, self.inputs[(kernel, geom, B)]


def run_path(torch, name, kept, used, fn, every=True):
    """Drive one path with every launch count set to 0 just before it and
    read just after; the kernels in `used` must have launched (without
    `every`, some of them), no other kernel and no plain version. Returns
    (fn's result, counts)."""
    from pacbioassembly_tpu_torch import _build

    kept.install()
    try:
        _build.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
    finally:
        kept.remove()
    ran = {k for k, v in counts.items() if v}
    if ran != set(used) if every else not ran <= set(used):
        raise AssertionError(f"[{name}] launched {sorted(ran)}, expected "
                             f"{'exactly' if every else 'only'} {sorted(used)}: {counts}")
    log(f"[{name}] launches {{{', '.join(f'{k}: {counts[k]}' for k in sorted(ran))}}}, "
        f"every other kernel and every plain version 0")
    return out, counts


def phase_main_path_kernels(torch, res, kept: MainPathInputs, path):
    """Every kernel variant a path launched, against its plain version on
    the path's own inputs (its most frequent batch size)."""
    seen = set()
    for kernel, geom, n, B, items in kept.variants():
        kw = items[0][1]
        if kernel.startswith(("bitwave", "rowdp")):
            LA, LB, W, R = geom
            items = [(a, {k: v for k, v in w.items() if k != "kind"}) for a, w in items]
            check_score(torch, res, kernel.split("_")[0], kw["kind"], items, "main-path",
                        f"B={B} LA={LA} LB={LB} W={W} R={R}")
            if kernel.startswith("rowdp"):
                log(f"[kernels:main-path] ... K3 builds on these inputs: "
                    + k3_shapes(torch, [a for a, _ in items[:1]], items[0][1], kw["kind"],
                                timing=False))
        elif kernel == "tbwave":
            check_parents(torch, res, items, "main-path",
                          f"Bp={B} LA={geom[0]} W={geom[1]} rows={kw['rows_max']}")
        else:
            check_walk(torch, res, items, "main-path", f"Bp={B} W={geom[0]} E={kw['e_max']}")
        res.rows[-1].update(launches=n, path=path)
        log(f"[kernels:main-path] ... the {path} path launched this variant {n} times")
        seen.add(kernel)
    return seen


def simulate_store(genome_len, coverage, mean_read_len, error, seed, max_read_len=19_000,
                   profile="uniform", path=None):
    """(genome, ReadStore) of simulated reads; with `path`, the records are
    also written there."""
    from pacbioassembly_tpu_torch.assemble import ReadStore
    from pacbioassembly_tpu_torch.codec import binary_io
    from pacbioassembly_tpu_torch.tools.simulate import SimConfig, simulate, split_error_rate

    sub, ins, dele = split_error_rate(error, profile)
    sim = SimConfig(
        genome_len=genome_len, coverage=coverage, mean_read_len=mean_read_len,
        max_read_len=max_read_len, sub_rate=sub, ins_rate=ins, del_rate=dele, seed=seed,
    )
    genome, reads, _ = simulate(sim)
    buf = io.BytesIO()
    binary_io.write_records(buf, reads)
    if path is not None:
        with open(path, "wb") as fh:
            fh.write(buf.getvalue())
    return genome, ReadStore(np.frombuffer(buf.getvalue(), dtype=np.uint8))


def kmer_share(contig, genome, k=16) -> float:
    """Share of the contig's k-mers found in the genome (a cheap check that
    the assembly is the simulated genome, at ~1.4% residual error)."""

    def kmers(codes):
        c = codes.astype(np.uint64)
        v = np.zeros(len(c) - k + 1, np.uint64)
        for t in range(k):
            v = (v << np.uint64(2)) | c[t : len(c) - k + 1 + t]
        return v

    g = np.unique(kmers(genome))
    q = kmers(contig)
    return float(np.isin(q, g).mean())


def device_view(trace_path: str) -> str:
    """Busy share of the card (union of kernel, copy and memset spans over
    the trace's window, first to last event of the profiled rounds) and
    device seconds by kernel, from the chrome trace torch.profiler wrote."""
    with open(trace_path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X" and "ts" in e]
    if not events:
        return "not measured (the trace holds no events)"
    window = (max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in events)
              - min(float(e["ts"]) for e in events)) / 1e6
    spans, by_name = [], {}
    for e in events:
        cat = e.get("cat", "")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        t0, dur = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((t0, t0 + dur))
        if cat == "kernel":
            m = re.search(r"(bitwave_(?:warp_)?kernel(?:<[^>]*>)?|wavefront_kernel<[^>]*>"
                          r"|tbwave_kernel<\d+>|walk_kernel)", e.get("name", ""))
            name = m.group(1) if m else "other kernels"
        else:
            name = "copies and memsets"
        n, s = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, s + dur / 1e6)
    if not spans:
        return "not measured (the trace holds no device spans)"
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + (hi - lo), a
        hi = max(hi, b)
    busy = (busy + (hi - lo)) / 1e6
    parts = ", ".join(f"{k} {s:.4f} s in {n}" for k, (n, s) in
                      sorted(by_name.items(), key=lambda kv: -kv[1][1]))
    return (f"card busy {busy:.4f} s of a {window:.3f} s window = {100 * busy / window:.2f}%; "
            f"device time by kernel: {parts}")


PREFILTER_LABELS = ("pbt:vectors", "pbt:gather", "pbt:screen")


@contextlib.contextmanager
def labelled_prefilter(torch):
    """Label the prefilter pass and its parts as torch.profiler ranges: the
    pass (BatchAssembler._prefilter), its host vectors (_device_vectors),
    the on-device gather (DeviceBatchBuilder.materialize) and the screening
    call (gather.score_batch, the kernel's wrapper); the rest of a pass is
    the result's stack, its fetch to the host and the pass's own loop."""
    from pacbioassembly_tpu_torch.assemble import batch, gather

    slots = [(batch.BatchAssembler, "_prefilter", "pbt:prefilter"),
             (batch.BatchAssembler, "_device_vectors", PREFILTER_LABELS[0]),
             (gather.DeviceBatchBuilder, "materialize", PREFILTER_LABELS[1]),
             (gather, "score_batch", PREFILTER_LABELS[2])]
    real = [getattr(owner, attr) for owner, attr, _ in slots]

    def labelled(fn, label):
        def run(*a, **k):
            with torch.profiler.record_function(label):
                return fn(*a, **k)
        return run

    for (owner, attr, label), fn in zip(slots, real):
        setattr(owner, attr, labelled(fn, label))
    try:
        yield
    finally:
        for (owner, attr, _), fn in zip(slots, real):
            setattr(owner, attr, fn)


def prefilter_view(trace_path: str) -> str:
    """What fills the prefilter passes of a labelled profile window: host
    time by part (inside the passes only; the parts also run for the full
    screen and commits) and device time by kind of the spans that start
    inside a pass, per pass."""
    with open(trace_path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X" and "ts" in e]

    def span(e):
        return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))

    ann = [e for e in events if e.get("cat") == "user_annotation"]
    passes = [span(e) for e in ann if e["name"] == "pbt:prefilter"]
    if not passes:
        return "not measured (no prefilter pass in the window)"
    n = len(passes)
    host = dict.fromkeys(PREFILTER_LABELS, 0.0)
    for e in ann:
        t0, t1 = span(e)
        if e["name"] in host and any(a <= t0 and t1 <= b for a, b in passes):
            host[e["name"]] += t1 - t0
    total = sum(b - a for a, b in passes)
    dev: dict = {}
    torch_kernels: dict = {}
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        t0, t1 = span(e)
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset") or not any(
                a <= t0 <= b for a, b in passes):
            continue
        if cat == "kernel" and re.search(r"bitwave_(?:warp_)?kernel|wavefront_kernel", name):
            key = "screening kernel"
        elif cat == "kernel":
            key = "PyTorch kernels"
            short = re.sub(r"\(.*", "", name)[:60]
            c, d = torch_kernels.get(short, (0, 0.0))
            torch_kernels[short] = (c + 1, d + t1 - t0)
        elif cat == "gpu_memcpy":
            key = "copies " + ("HtoD" if "HtoD" in name else "DtoH" if "DtoH" in name else "DtoD")
        else:
            key = "memsets"
        c, d = dev.get(key, (0, 0.0))
        dev[key] = (c + 1, d + t1 - t0)
    parts = ", ".join(f"{k[4:]} {host[k] / n / 1e3:.3f} ms" for k in PREFILTER_LABELS)
    rest = (total - sum(host.values())) / n / 1e3
    on_card = ", ".join(f"{k} {d / n / 1e3:.4f} ms in {c / n:g}" for k, (c, d) in
                        sorted(dev.items(), key=lambda kv: -kv[1][1]))
    top = ", ".join(f"{k} {d / n / 1e3:.4f} ms in {c / n:g}" for k, (c, d) in
                    sorted(torch_kernels.items(), key=lambda kv: -kv[1][1])[:4])
    return (f"{n} passes, {total / n / 1e3:.3f} ms a pass on the host clock: {parts}, stack + "
            f"fetch + loop {rest:.3f} ms; on the card a pass: {on_card or 'no device spans'}; "
            f"PyTorch's largest: {top or 'none'}")


def state_of(asm) -> dict:
    """What two engines on one trajectory must agree on."""
    ref = asm.ref
    return {
        "history": [dataclasses.asdict(s) for s in asm.history],
        "contig": ref.text().copy(),
        "votes": [getattr(ref, f)[ref.beg : ref.end].copy() for f in ("sel", "sup", "total")],
        "surviving": list(asm.surviving),
    }


def same_state(a: dict, b: dict) -> bool:
    return (a["history"] == b["history"] and np.array_equal(a["contig"], b["contig"])
            and all(np.array_equal(x, y) for x, y in zip(a["votes"], b["votes"]))
            and a["surviving"] == b["surviving"])


def run_slice(torch, asm, name, max_round, kept, used, untimed=None):
    """Drive one engine to max_round on its own metrics log, then report
    s/round and phases; `untimed` maps a round to seconds spent in it on
    the smoke's own records, left out of its round_s. Returns the launch
    counts."""
    with tempfile.TemporaryDirectory() as tmp:
        metrics = os.path.join(tmp, "metrics.jsonl")
        asm.cfg = dataclasses.replace(asm.cfg, max_round=max_round, metrics_path=metrics)
        t0 = time.perf_counter()

        def drive():
            asm.run(out=None)
            # the prefilter needs a round with enough candidates
            while (max(s.ntrials for s in asm.history) < asm.cfg.prefilter_min_batch
                   and asm.nround < 200):
                log(f"[{name}] no round reached {asm.cfg.prefilter_min_batch} candidates by "
                    f"round {asm.nround}: raising the round cap by 20")
                asm.cfg = dataclasses.replace(asm.cfg, max_round=asm.nround + 20)
                asm.run(out=None)

        _, counts = run_path(torch, name, kept, used, drive)
        wall = time.perf_counter() - t0
        with open(metrics) as fh:
            rounds = [json.loads(line) for line in fh]
    rounds = [r for r in rounds if r["event"] == "round"]
    rs = np.array([r["round_s"] - (untimed or {}).get(r["nround"], 0.0) for r in rounds])
    cands = [s.ntrials for s in asm.history]
    log(f"[{name}] {asm.nround} rounds in {wall:.1f} s: {len(asm.reads) - len(asm.surviving)} of "
        f"{len(asm.reads)} reads consumed, contig {asm.ref.length()} bp, candidates/round max "
        f"{max(cands)} median {int(np.median(cands))}, s/round p50 "
        f"{np.percentile(rs, 50):.4f} p95 {np.percentile(rs, 95):.4f}")
    phases = ("seedmap_s", "expand_s", "screen_s", "commit_s", "evolve_s",
              "prefilter_s", "fullscreen_s", "tb_s", "host_commit_s", "elect_s")
    half = rounds[len(rounds) // 2:]
    log(f"[{name}] second-half mean s/round by phase: " + ", ".join(
        f"{k} {np.mean([r.get(k, 0.0) for r in half]):.4f}" for k in phases))
    return counts


def profile_rounds(torch, asm, name, n):
    """n more rounds under the engine's own profiler option, the prefilter
    passes labelled: the card's busy share and device time by kernel, and
    what fills a prefilter pass."""
    with tempfile.TemporaryDirectory() as tmp:
        first = asm.nround + 1
        trace_dir = os.path.join(tmp, "trace")
        asm.cfg = dataclasses.replace(asm.cfg, max_round=asm.nround + n,
                                      profile_dir=trace_dir, metrics_path=None)
        t0 = time.perf_counter()
        with labelled_prefilter(torch):
            asm.run(out=None)
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
        trace = os.path.join(trace_dir, "trace.json")
        view = device_view(trace)
        pf_view = prefilter_view(trace)
    asm.cfg = dataclasses.replace(asm.cfg, profile_dir=None)
    log(f"[device-view:{name}] rounds {first}-{asm.nround} under torch.profiler "
        f"({wall_p:.3f} s on the host clock with the trace export): {view}")
    log(f"[prefilter:{name}] rounds {first}-{asm.nround}: {pf_view}")


K1_SLICE_KERNELS = ("bitwave_prefilter", "bitwave_fullscreen", "tbwave", "walk")
K3_SLICE_KERNELS = ("rowdp_prefilter", "rowdp_fullscreen", "tbwave", "walk")


def slice_engine(torch, dev, genome_len, max_round, screen_kernel="bitwave", parallel_commit=False):
    """The E. coli-scale read store and an engine on it (the K1 path's by
    default); returns (genome, reads, patterns, cfg, engine)."""
    from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler
    from pacbioassembly_tpu_torch.codec import dna
    from pacbioassembly_tpu_torch.config import AssemblyConfig

    t0 = time.perf_counter()
    genome, reads = simulate_store(genome_len, 30.0, 2500, 0.03, 11)
    log(f"[slice] simulated {genome_len / 1e6:.1f} Mb @ 30x: {len(reads)} reads in {time.perf_counter() - t0:.1f} s")
    patterns = dna.load_patterns(SEEDS)
    cfg = AssemblyConfig(
        engine="batch", rng_seed=7, pattern_schedule="roundrobin", max_round=max_round,
        max_seq_len=len(genome) + 500_000, parallel_commit=parallel_commit,
    )
    t0 = time.perf_counter()
    asm = BatchAssembler(cfg, reads, patterns, device=dev, screen_kernel=screen_kernel)
    builder = asm._builder()
    if builder is None:
        raise AssertionError("read matrix does not fit the device matrix cap")
    torch.cuda.synchronize()
    log(f"[slice] set-up {time.perf_counter() - t0:.1f} s (device read matrix "
        f"{builder.reads_mat.numel() / 1e9:.2f} GB)")
    return genome, reads, patterns, cfg, asm


def state_digest(asm) -> str:
    """sha256 over state_of(asm): contig bytes, votes, surviving reads and
    RoundStats, to compare two processes' runs."""
    st = state_of(asm)
    h = hashlib.sha256(json.dumps([st["history"], st["surviving"]]).encode())
    for a in [st["contig"]] + st["votes"]:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def counted_splits():
    """Counts the two-thread host commits (assemble/batch.py's
    ThreadPoolExecutor) while the block runs; yields the count's list."""
    from pacbioassembly_tpu_torch.assemble import batch

    real = batch.ThreadPoolExecutor
    splits = []

    class Counted(real):
        def __init__(self, *a, **k):
            splits.append(1)
            super().__init__(*a, **k)

    batch.ThreadPoolExecutor = Counted
    try:
        yield splits
    finally:
        batch.ThreadPoolExecutor = real


def phase_k1_slice_only(torch, dev, genome_len=4_600_000, max_round=60, parallel_commit=False):
    """Only the K1 path's slice, as phase_slices drives it: its s/round,
    phases and state (and its digest), then its profiled rounds (device
    time by kernel and what fills a prefilter pass), for comparing two
    trees of the port, or the serial host commit with the two-thread one
    (`parallel_commit`; the count of rounds that split is printed)."""
    name = "bitwave slice" + (", parallel commit" if parallel_commit else "")
    _, _, _, _, k1 = slice_engine(torch, dev, genome_len, max_round,
                                  parallel_commit=parallel_commit)
    # (a tree from before the split was ported has no pool to count)
    with counted_splits() if parallel_commit else contextlib.nullcontext([]) as splits:
        run_slice(torch, k1, name, max_round, MainPathInputs(()), K1_SLICE_KERNELS)
    log(f"[{name}] state at round {k1.nround}: contig {k1.ref.length()} bp, "
        f"{len(k1.reads) - len(k1.surviving)} reads consumed, digest {state_digest(k1)}; "
        f"the host commit split in two threads in {len(splits)} of {k1.nround} rounds")
    profile_rounds(torch, k1, name, PROFILED_ROUNDS["bitwave"])


def phase_k3_slice_only(torch, dev, genome_len=4_600_000, max_round=60):
    """Only the K3 path's slice, on its own store (the same seeds as the
    K1 slice's), then locate through K3 onto its contig: s/round, phases,
    state and locate wall time, for comparing two trees of the port."""
    _, _, _, _, k3 = slice_engine(torch, dev, genome_len, max_round, screen_kernel="rowdp")
    run_slice(torch, k3, "rowdp slice", max_round, MainPathInputs(()), K3_SLICE_KERNELS)
    log(f"[rowdp slice] state at round {k3.nround}: contig {k3.ref.length()} bp, "
        f"{len(k3.reads) - len(k3.surviving)} reads consumed")
    phase_locate(torch, dev, k3, k3.ref.text().copy(), {}, {}, kernels=("rowdp",))


def phase_slices(torch, dev, genome_len=4_600_000, max_round=60):
    """The K1 path, then the row-DP path on the same store; returns
    (per-path counts, per-path kept inputs, row-DP engine, genome, the K1
    slice's record for the mesh phase)."""
    from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler

    genome, reads, patterns, cfg, k1 = slice_engine(torch, dev, genome_len, max_round)
    init_len = k1.ref.length()
    kept = {"bitwave slice": MainPathInputs(), "rowdp slice": MainPathInputs(("rowdp",))}
    counts = {}
    # the mesh phase's reference: the state at its round, the reference of
    # the slice's last round before its evolve
    with recorded(k1, MESH_ROUNDS, copy_round=max_round) as rec:
        counts["bitwave slice"] = run_slice(
            torch, k1, "bitwave slice", max_round, kept["bitwave slice"], K1_SLICE_KERNELS,
            untimed=rec["untimed"])
    if len(reads) - len(k1.surviving) <= 0 or k1.ref.length() <= init_len:
        raise AssertionError("the slice consumed no reads or the contig did not grow")
    share = kmer_share(k1.ref.text(), genome)
    if share < 0.5:
        raise AssertionError(f"only {share:.2f} of the contig's 16-mers are in the genome")
    log(f"[bitwave slice] contig {init_len} -> {k1.ref.length()} bp, {share:.3f} of its 16-mers "
        f"in the genome")
    snap = state_of(k1)
    rounds = k1.nround
    ref_round = dict(rec, contig=snap["contig"], at=rounds)
    profile_rounds(torch, k1, "bitwave slice", PROFILED_ROUNDS["bitwave"])

    # the row-DP path: same reads, trial seeds and device read matrix
    rowdp = BatchAssembler(cfg, reads, patterns, device=dev, screen_kernel="rowdp",
                           trial_cache=k1._trial_cache, device_builder=k1._device_builder)
    del k1
    counts["rowdp slice"] = run_slice(
        torch, rowdp, "rowdp slice", rounds, kept["rowdp slice"], K3_SLICE_KERNELS)
    if not same_state(state_of(rowdp), snap):
        raise AssertionError(f"the row-DP path's state at round {rounds} differs from the K1 path's")
    log(f"[rowdp slice] RoundStats, contig bytes, votes and surviving reads equal the K1 "
        f"path's at round {rounds}")
    profile_rounds(torch, rowdp, "rowdp slice", PROFILED_ROUNDS["rowdp"])
    return counts, kept, rowdp, genome, ref_round


def phase_locate(torch, dev, rowdp, contig, counts, kept, n_consumed=1500, n_other=500,
                 kernels=("rowdp", "bitwave")):
    """Map 2,000 reads onto the row-DP path's contig with K3 and with K1
    (or the `kernels` given), the TSVs equal."""
    from pacbioassembly_tpu_torch.codec import dna
    from pacbioassembly_tpu_torch.tools import cli, locate

    reads = rowdp.reads
    surviving = set(rowdp.surviving)
    consumed = [i for i in range(len(reads)) if i not in surviving]
    rng = np.random.default_rng(3)
    pick = np.sort(np.concatenate([
        rng.choice(consumed, n_consumed, replace=False),
        rng.choice(sorted(surviving), n_other, replace=False),
    ]))
    seqs = [reads.codes(int(i)).copy() for i in pick]
    pattern = dna.load_patterns(SEEDS)[0]
    tsv = {}
    for kernel in kernels:
        name = f"{kernel} locate"
        kept[name] = MainPathInputs((kernel,))
        t0 = time.perf_counter()
        (rows, nproc), counts[name] = run_path(
            torch, name, kept[name], (f"{kernel}_locate",),
            lambda: locate.map_reads(contig, pattern, seqs, 0.15, device=dev,
                                     screen_kernel=kernel))
        wall = time.perf_counter() - t0
        tsv[kernel] = rows
        summary = locate.residual_from_rows(rows, nproc)
        log(f"[{name}] {nproc} reads, {summary['mapped']} mapped in {wall:.2f} s; residual_error "
            f"{summary['residual_error']}, mean cost per read base "
            f"{summary['mean_cost_per_read_base']}")
    if any(rows != tsv[kernels[0]] for rows in tsv.values()):
        raise AssertionError("locate: the K3 and K1 TSVs differ")
    mapped = {r[0] for r in tsv[kernels[0]]}
    n_in = sum(1 for q, i in enumerate(pick) if int(i) not in surviving and q in mapped)
    if n_in < n_consumed // 2:
        raise AssertionError(f"locate: only {n_in} of {n_consumed} consumed reads mapped")
    out = io.StringIO()
    t0 = time.perf_counter()
    cli.locate_host_loop(contig, pattern, seqs[:100], 0.15, out=out)
    host = [tuple(int(x) for x in line.split("\t")) for line in out.getvalue().splitlines()]
    if host != [r for r in tsv[kernels[0]] if r[0] < 100]:
        raise AssertionError("locate: the first 100 reads differ from the host loop")
    names = " == ".join({"rowdp": "K3", "bitwave": "K1"}[k] + " TSV" for k in kernels)
    log(f"[locate] {names} ({len(tsv[kernels[0]])} rows, {n_in} of {n_consumed} consumed reads "
        f"mapped); first 100 reads == host loop ({len(host)} rows, "
        f"{time.perf_counter() - t0:.2f} s)")


def phase_two_devices(torch):
    from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler
    from pacbioassembly_tpu_torch.codec import dna
    from pacbioassembly_tpu_torch.config import AssemblyConfig

    _, reads = simulate_store(60_000, 12.0, 1200, 0.03, 5, max_read_len=2000)
    cfg = AssemblyConfig(engine="batch", rng_seed=7, pattern_schedule="roundrobin",
                         max_round=8, prefilter_min_batch=1)
    patterns = dna.load_patterns(SEEDS)
    runs = {}
    for name in ("cuda", "cpu"):
        t0 = time.perf_counter()
        asm = BatchAssembler(cfg, reads, patterns, device=name)
        out = io.StringIO()
        asm.run(out=out)
        runs[name] = (asm, out.getvalue())
        log(f"[two-devices] {name}: {asm.nround} rounds, contig {asm.ref.length()} bp, "
            f"{len(reads) - len(asm.surviving)} reads consumed, {time.perf_counter() - t0:.1f} s")
    (g, gout), (c, cout) = runs["cuda"], runs["cpu"]
    if gout != cout or not same_state(state_of(g), state_of(c)):
        raise AssertionError("cuda and cpu runs differ")
    log("[two-devices] contig bytes, sel/sup/total and surviving reads equal")


# the multi-contig path's kernels, and its two regimes: (name, genome length,
# error, error profile, contigs); the E. coli slice's widths (30x, mean read
# 2,500, seed 11, rng_seed 7), the genome cut from 4.6 Mb for time
CONTIGS_KERNELS = ("bitwave_prefilter", "bitwave_fullscreen", "bitwave_locate", "tbwave", "walk")
CONTIG_REGIMES = (("3pct", 300_000, 0.03, "uniform", 8), ("15pct-clr", 150_000, 0.15, "clr", 4))
CONTIG_LINE = re.compile(r"=== contig (\d+): (\d+) bp from (\d+) reads in (\d+) rounds")


@contextlib.contextmanager
def contig_spy(torch, kept):
    """While the block runs: per engine run (one contig) its wall time and
    the card's allocated memory after it, less what `kept` holds; and
    assemble_contigs' result (contigs, surviving reads)."""
    from pacbioassembly_tpu_torch.assemble import batch

    real_run, real_contigs = batch.BatchAssembler.run, batch.assemble_contigs
    runs, result = [], {}

    def run(self, out=None, log=None):
        t0 = time.perf_counter()
        ref = real_run(self, out=out, log=log)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, torch.cuda.memory_allocated() - kept.nbytes))
        return ref

    def assemble_contigs(*a, **k):
        result["out"] = real_contigs(*a, **k)
        return result["out"]

    batch.BatchAssembler.run, batch.assemble_contigs = run, assemble_contigs
    try:
        yield runs, result
    finally:
        batch.BatchAssembler.run, batch.assemble_contigs = real_run, real_contigs


def contigs_regime(torch, dev, kept, tmp, name, genome_len, error, profile, n_contigs):
    """One regime of the multi-contig path through the CLI, scored; returns
    a summary dict."""
    from pacbioassembly_tpu_torch.align.screen import ladder_size
    from pacbioassembly_tpu_torch.codec import dna
    from pacbioassembly_tpu_torch.tools import cli, coverage, locate, postprocess
    from pacbioassembly_tpu_torch.tools.simulate import SimConfig, simulate

    tag = f"contigs:{name}"
    path = os.path.join(tmp, f"{name}.bin")
    t0 = time.perf_counter()
    genome, reads = simulate_store(genome_len, 30.0, 2500, error, 11, profile=profile, path=path)
    log(f"[{tag}] simulated {genome_len / 1e3:.0f} kb @ 30x, {error:.0%} {profile} error: "
        f"{len(reads)} reads in {time.perf_counter() - t0:.1f} s")
    metrics = os.path.join(tmp, f"{name}.jsonl")
    argv = ["assemble", path, SEEDS, "--engine", "batch", "--device", str(dev),
            "--schedule", "roundrobin", "--rng-seed", "7", "--contigs", str(n_contigs),
            "--metrics", metrics]
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contig_spy(torch, kept) as (runs, result), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"[{tag}] the CLI exited {rc}: {err.getvalue()[-2000:]}")
    lines = out.getvalue().splitlines()
    kept_codes = [dna.text_to_codes(x) for x in lines[1::2]]
    contigs, surviving = result["out"]
    if len(lines) != 2 * len(contigs) or any(
            not h.startswith(f">contig_{i} length={len(c.codes)} reads={c.nreads} rounds={c.nrounds}")
            or not np.array_equal(k, c.codes)
            for i, (h, k, c) in enumerate(zip(lines[0::2], kept_codes, contigs))):
        raise AssertionError(f"[{tag}] the CLI's FASTA differs from assemble_contigs' result")
    errs = err.getvalue().splitlines()
    built = [tuple(int(x) for x in m.groups()) for m in map(CONTIG_LINE.match, errs) if m]
    with open(metrics) as fh:
        recs = [json.loads(line) for line in fh]
    round_s = []
    for r in recs:
        if r["event"] == "run_start":
            round_s.append([])
        elif r["event"] == "round":
            round_s[-1].append(r["round_s"])
    if not (len(built) == len(runs) == len(round_s) >= 1):
        raise AssertionError(f"[{tag}] {len(built)} contigs logged, {len(runs)} engine runs, "
                             f"{len(round_s)} metrics segments")
    for (ci, bp, nreads, nrounds), (w, mem), rs in zip(built, runs, round_s):
        log(f"[{tag}] contig {ci}: {bp} bp from {nreads} reads in {nrounds} rounds, {w:.2f} s; "
            f"s/round p50 {np.percentile(rs, 50):.4f} p95 {np.percentile(rs, 95):.4f}; "
            f"card memory allocated after it {mem / 2**20:.1f} MiB")
    mems = [m for _, m in runs]
    window = 2 * ladder_size(max(bp for _, bp, _, _ in built), 8192)
    if max(mems) > mems[0] + window:
        raise AssertionError(f"[{tag}] the card's allocated memory grew from contig to contig: {mems}")
    dropped = [ln[4:] for ln in errs if ln.startswith("=== dropping")]
    log(f"[{tag}] {len(built)} contigs built, {len(contigs)} kept, in {wall:.1f} s; "
        f"dedupe dropped {len(dropped)}: {dropped}; {errs[-1]}")
    t0 = time.perf_counter()
    ev = coverage.evaluate_assembly(genome, kept_codes)
    log(f"[{tag}] evaluate_assembly ({time.perf_counter() - t0:.2f} s): genome fraction "
        f"{ev['genome_fraction']}, N50 {ev['n50']}, NG50 {ev['ng50']}, misassemblies "
        f"{ev['misassemblies']}, max break {ev['max_break']}")
    summary = {"contigs": len(contigs), "fraction": ev["genome_fraction"],
               "misassemblies": ev["misassemblies"], "surviving": len(surviving)}
    pattern = dna.load_patterns(SEEDS)[0]
    if name == "3pct":
        if not contigs or ev["genome_fraction"] < 0.9 or ev["misassemblies"] != 0:
            raise AssertionError(f"[{tag}] {len(contigs)} contigs, genome fraction "
                                 f"{ev['genome_fraction']}, {ev['misassemblies']} misassemblies")
        # the JAX runner's residual: CCS-like 1%-error reads at 2x (benchmarks/ecoli_scale.py)
        ccs = SimConfig(genome_len=len(genome), coverage=2.0, mean_read_len=2500,
                        sub_rate=0.004, ins_rate=0.003, del_rate=0.003, seed=12)
        _, ccs_reads, _ = simulate(ccs, genome=genome)
        largest = max(kept_codes, key=len)
        t0 = time.perf_counter()
        q = locate.residual_error(largest, pattern, ccs_reads, 0.15, device=dev)
        log(f"[{tag}] residual error of the largest contig ({len(largest)} bp) on the card: "
            f"{q['residual_error']} ({q['mapped']} of {q['total']} CCS-like reads mapped, "
            f"{time.perf_counter() - t0:.2f} s)")
        summary["residual"] = q["residual_error"]
    else:
        t0 = time.perf_counter()
        acct = postprocess.classify_reads(kept_codes, [reads.codes(i) for i in surviving],
                                          pattern, 0.3, device=dev)
        cats = ("mapped", "seeded_only", "unseedable", "too_short")
        log(f"[{tag}] classify_reads of {len(surviving)} surviving reads on the card in "
            f"{time.perf_counter() - t0:.2f} s: " + ", ".join(f"{k} {acct[k]}" for k in cats))
        if sum(acct[k] for k in cats) != len(surviving) or acct["total"] != len(surviving):
            raise AssertionError(f"[{tag}] the read accounting does not sum to the survivors")
    return summary


def two_segment_store():
    """tests/test_batch.py::test_multi_contig_assembly's reads: two unrelated
    8 kb segments at 10x, reads 600-900, 1% each of sub/ins/del."""
    from pacbioassembly_tpu_torch.assemble import ReadStore
    from pacbioassembly_tpu_torch.codec import binary_io
    from pacbioassembly_tpu_torch.tools.simulate import SimConfig, simulate

    rng = np.random.default_rng(3)
    segs = [rng.integers(0, 4, 8000).astype(np.uint8) for _ in range(2)]
    reads = []
    for g in segs:
        _, rl, _ = simulate(SimConfig(genome_len=len(g), coverage=10.0, mean_read_len=700,
                                      min_read_len=600, max_read_len=900, sub_rate=0.01,
                                      ins_rate=0.01, del_rate=0.01, seed=5), genome=g)
        reads += rl
    buf = io.BytesIO()
    binary_io.write_records(buf, reads)
    return ReadStore(np.frombuffer(buf.getvalue(), dtype=np.uint8))


def contigs_cuda_equals_cpu(torch):
    from pacbioassembly_tpu_torch.assemble.batch import assemble_contigs
    from pacbioassembly_tpu_torch.codec import dna
    from pacbioassembly_tpu_torch.config import AssemblyConfig

    reads = two_segment_store()
    cfg = AssemblyConfig(engine="batch", rng_seed=1, pattern_schedule="roundrobin", max_round=40)
    patterns = dna.load_patterns(SEEDS)
    for dedupe in (False, True):
        got, secs = {}, {}
        for d in ("cuda", "cpu"):
            t0 = time.perf_counter()
            contigs, surviving = assemble_contigs(cfg, reads, patterns, 4, dedupe=dedupe, device=d)
            secs[d] = time.perf_counter() - t0
            got[d] = ([(c.codes.tolist(), c.nreads, c.nrounds) for c in contigs], surviving)
        if got["cuda"] != got["cpu"]:
            raise AssertionError(f"[contigs:two-devices] dedupe={dedupe}: cuda != cpu")
        log(f"[contigs:two-devices] dedupe={dedupe}: {len(got['cuda'][0])} contigs "
            f"{[(len(c), n, r) for c, n, r in got['cuda'][0]]}, {len(got['cuda'][1])} reads left; "
            f"ContigResults and surviving reads equal on cuda ({secs['cuda']:.1f} s) and cpu "
            f"({secs['cpu']:.1f} s)")


def phase_contigs(torch, dev, replay=True):
    """The multi-contig path (8): both regimes through the CLI inside one
    launch-count window, then cuda == cpu. Returns (counts, kept inputs;
    none kept without `replay`)."""
    kept = MainPathInputs() if replay else MainPathInputs(())
    with tempfile.TemporaryDirectory() as tmp:
        summary, counts = run_path(
            torch, "contigs", kept, CONTIGS_KERNELS,
            lambda: [contigs_regime(torch, dev, kept, tmp, *r) for r in CONTIG_REGIMES])
    log(f"[contigs] {dict(zip((r[0] for r in CONTIG_REGIMES), summary))}")
    contigs_cuda_equals_cpu(torch)
    return counts, kept


# the mesh path: the engine on 2 shards of one card for MESH_ROUNDS rounds of
# the E. coli slice, held to the K1 slice's state at that round
MESH_ROUNDS = 20
MESH_KERNELS = ("bitwave_prefilter", "bitwave_fullscreen", "tbwave", "walk")
WORKER = os.path.join("tests", "torch_multihost_worker.py")


@contextlib.contextmanager
def recorded(asm, at_round, copy_round=None):
    """While the block runs: `asm`'s rounds timed and their launch logs
    kept, its state_of after round `at_round`, and with `copy_round` its
    reference's state dict after that round's commit, before the round's
    evolve (instance attributes over the engine's run_round and its
    reference's evolve). The copy's seconds are kept in rec["untimed"]
    under its round and left out of rec["round_s"]; run_slice leaves them
    out of the round's metrics too."""
    rec = {"round_s": [], "launches": [], "untimed": {}}
    real_round, real_evolve = asm.run_round, asm.ref.evolve

    def evolve():
        if asm.nround == copy_round:
            t0 = time.perf_counter()
            rec["pre_evolve"] = asm.ref.state_dict()
            rec["untimed"][asm.nround] = time.perf_counter() - t0
        return real_evolve()

    def run_round(log=None):
        t0 = time.perf_counter()
        stats = real_round(log=log)
        rec["round_s"].append(time.perf_counter() - t0 - rec["untimed"].get(asm.nround, 0.0))
        rec["launches"] += asm.launch_log
        if asm.nround == at_round:
            rec["state"] = state_of(asm)
        return stats

    ref = asm.ref
    asm.run_round, ref.evolve = run_round, evolve
    try:
        yield rec
    finally:
        del asm.run_round, ref.evolve


def mesh_engine(torch, dev, reads, patterns, genome_len, want, single_s, kept, counts,
                **shared):
    """Step 1 of the mesh phase: the engine on a 2-shard mesh of the card,
    MESH_ROUNDS rounds, its state equal to the K1 slice's at that round."""
    from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler
    from pacbioassembly_tpu_torch.config import AssemblyConfig
    from pacbioassembly_tpu_torch.parallel import make_mesh

    cfg = AssemblyConfig(engine="batch", rng_seed=7, pattern_schedule="roundrobin",
                         max_round=MESH_ROUNDS, max_seq_len=genome_len + 500_000)
    mesh = make_mesh(devices=[dev, dev])
    asm = BatchAssembler(cfg, reads, patterns, device=dev, mesh=mesh, **shared)
    kept["mesh"] = MainPathInputs()
    t0 = time.perf_counter()
    with recorded(asm, MESH_ROUNDS) as rec:
        _, counts["mesh"] = run_path(torch, "mesh", kept["mesh"], MESH_KERNELS,
                                     lambda: asm.run(out=None))
    wall = time.perf_counter() - t0
    got = rec["state"]
    if got["history"] != want["history"]:
        first = next(r for r, (x, y) in enumerate(zip(got["history"], want["history"]), 1)
                     if x != y)
        raise AssertionError(f"[mesh] round {first}: RoundStats {got['history'][first - 1]} on "
                             f"the mesh, {want['history'][first - 1]} on one device")
    if not same_state(got, want):
        raise AssertionError(f"[mesh] the state at round {MESH_ROUNDS} differs from the K1 "
                             f"slice's (every round's RoundStats equal)")
    ll = rec["launches"]
    by_kind = {k: sum(e["kind"] == k for e in ll) for k in ("pf", "fs", "tbp", "elect")}
    elect_dev = sorted({e["shape"][3] for e in ll if e["kind"] == "elect"})
    # each screening launch split into two shards: one K1 full screen each
    if counts["mesh"]["bitwave_fullscreen"] != 2 * by_kind["fs"] or elect_dev != [2]:
        raise AssertionError(f"[mesh] the round did not take the mesh path: {by_kind}, "
                             f"{counts['mesh']}, elect n_dev {elect_dev}")
    rs, ss = np.array(rec["round_s"]), np.array(single_s[:MESH_ROUNDS])
    log(f"[mesh] {mesh}: {asm.nround} rounds in {wall:.1f} s, contig {asm.ref.length()} bp, "
        f"{len(reads) - len(asm.surviving)} reads consumed; RoundStats, contig bytes, "
        f"sel/sup/total and surviving reads equal the K1 slice's at round {MESH_ROUNDS}")
    log(f"[mesh] launches: fs {by_kind['fs']} (K1 full screens "
        f"{counts['mesh']['bitwave_fullscreen']}: two shards each), pf {by_kind['pf']}, tbp "
        f"(K2 + W from the goals) {by_kind['tbp']}, elect {by_kind['elect']} (n_dev {elect_dev})")
    log(f"[mesh] s/round p50 {np.percentile(rs, 50):.4f} p95 {np.percentile(rs, 95):.4f} on the "
        f"mesh; rounds 1-{len(ss)} of the K1 slice (one device) p50 {np.percentile(ss, 50):.4f} "
        f"p95 {np.percentile(ss, 95):.4f}")


def mesh_two_process(torch, dev, port):
    """Step 2: two gloo ranks on 127.0.0.1, two shards each on the card;
    every rank's sharded screen and summed elect equal the serial port."""
    from pacbioassembly_tpu_torch.align.bitwave import batch_score_bitwave
    from pacbioassembly_tpu_torch.consensus.elect import elect_packed

    with tempfile.TemporaryDirectory() as tmp:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            tcp = sock.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.join(port, WORKER), str(tcp), str(r),
                                   tmp, f"{dev.type}:0"],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                 for r in range(2)]
        try:
            for r, p in enumerate(procs):
                _, err = p.communicate(timeout=180)
                if p.returncode != 0:
                    raise AssertionError(f"[mesh:2 processes] rank {r} exited {p.returncode}: "
                                         f"{err.decode(errors='replace')[-2000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        ranks = [dict(np.load(os.path.join(tmp, f"proc{r}.npz"))) for r in range(2)]
    x = ranks[0]
    ts = [torch.from_numpy(x[f"in_{k}"]).to(dev) for k in ("ops", "vals", "start", "fwd", "en")]
    serial = elect_packed(*ts, int(x["in_L"])).cpu().numpy()
    args = [torch.from_numpy(x[f"in_{k}"]).to(dev) for k in ("a", "la", "b", "lb")]
    scores = batch_score_bitwave(*args, la_max=args[0].shape[1], w_max=int(x["in_W"]), ratio=0.3)
    for r, res in enumerate(ranks):
        votes = np.concatenate([res["sel"], res["sup"], res["total"][:, None]], 1)
        if not np.array_equal(votes, serial) or any(
                not np.array_equal(res[f], getattr(scores, f).cpu().numpy()) for f in scores._fields):
            raise AssertionError(f"[mesh:2 processes] rank {r} differs from the serial port")
    log(f"[mesh:2 processes] 2 gloo ranks x 2 shards on {ranks[0]['devices'][0]} "
        f"({list(ranks[0]['devices'])}): sharded_elect and sharded_screen equal the serial port "
        f"on both ranks ({int(scores.accept.sum())} of {len(scores.accept)} pairs accepted); "
        f"{wall:.1f} s with the processes' start-up; NCCL and cards on two hosts are not exercised")


def mesh_modules(torch, dev, contig, pattern, pre_evolve, at_round):
    """Step 3: the remaining modules on the card against their plain
    versions: the traceback (K1, K2, W) against its CPU run, the word-array
    screen against K1, and the device twins of the seed index and the
    evolve on the K1 slice's contig and reference at `at_round`."""
    from pacbioassembly_tpu_torch.align.bitscan import batch_score_bp
    from pacbioassembly_tpu_torch.align.bitwave import batch_score_bitwave
    from pacbioassembly_tpu_torch.align.screen import size_bucket
    from pacbioassembly_tpu_torch.align.traceback import batch_align_traceback
    from pacbioassembly_tpu_torch.consensus import ConsensusRef
    from pacbioassembly_tpu_torch.consensus.device import evolve_on_device
    from pacbioassembly_tpu_torch.index import build_seedmap
    from pacbioassembly_tpu_torch.index.device import device_build_seedmap, device_lookup

    def host_ms(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), out

    rng = np.random.default_rng(7)
    LB, LA, W = size_bucket(2048, 0.3)
    batch = make_pairs(rng, 32, LB, LA, random_share=0.0)
    rows = min(LA, -(-int(batch[1].max()) // 512) * 512)
    kw = dict(la_max=LA, w_max=W, ratio=0.3, rows_max=rows)
    cpu_ms, want = host_ms(lambda: batch_align_traceback(*(torch.from_numpy(x) for x in batch),
                                                         **kw))
    card = tuple(torch.from_numpy(x).to(dev) for x in batch)
    batch_align_traceback(*card, **kw)
    ms, got = timed(torch, lambda x: batch_align_traceback(*x, **kw), card)
    if any(not torch.equal(getattr(got.scores, f).cpu(), getattr(want.scores, f))
           for f in want.scores._fields) or any(
            not torch.equal(getattr(got, f).cpu(), getattr(want, f)) for f in ("ops", "vals", "nedit")):
        raise AssertionError("[mesh:modules] batch_align_traceback on the card != its CPU run")
    log(f"[mesh:modules] batch_align_traceback (K1 -> K2 -> W) B=32 LA={LA} W={W} rows={rows} "
        f"E={got.ops.shape[1]}: card == cpu ({int(want.scores.accept.sum())} accepted); card "
        f"{ms:.3f} ms, the plain versions on the host {cpu_ms:.1f} ms")

    LB, LA, W = size_bucket(1024, 0.3)
    card = tuple(torch.from_numpy(x).to(dev) for x in make_pairs(rng, 1024, LB, LA))
    kw = dict(la_max=LA, w_max=W, ratio=0.3)
    k1_ms, k1 = timed(torch, lambda x: batch_score_bitwave(*x, **kw), card)
    bp_ms, bp = timed(torch, lambda x: batch_score_bp(*x, **kw), card)
    if max_err(torch, bp, k1) != 0:
        raise AssertionError("[mesh:modules] bitscan.batch_score_bp on the card != K1")
    log(f"[mesh:modules] bitscan.batch_score_bp B=1024 LA={LA} W={W}: == K1 field by field "
        f"({int(k1.accept.sum())} accepted); torch ops on the card {bp_ms:.1f} ms, K1 "
        f"{k1_ms:.3f} ms")

    L = len(contig)
    host_idx_ms, (host, _) = host_ms(build_seedmap, contig, pattern)
    codes = torch.from_numpy(contig).to(dev)
    device_build_seedmap(codes, L, pattern)
    dev_idx_ms, idx = host_ms(device_build_seedmap, codes, L, pattern)
    n = int(idx.n_entries)
    q = np.concatenate([host.keys[:: max(1, len(host.keys) // 20000)],
                        rng.integers(1, 1 << 32, 20000, dtype=np.uint64)]).astype(np.uint32)
    q = q & np.uint32(pattern)
    host_lk_ms, (lo_h, cnt_h) = host_ms(host.lookup_batch, q)
    qd = torch.from_numpy(q.astype(np.int64)).to(dev)
    dev_lk_ms, (lo, cnt) = host_ms(device_lookup, idx, qd)
    hit = cnt_h > 0
    if not (n == host.n_entries
            and np.array_equal(idx.keys[-n:].cpu().numpy(), host.keys.astype(np.int64))
            and np.array_equal(idx.positions[-n:].cpu().numpy(), host.positions)
            and np.array_equal(cnt.cpu().numpy(), cnt_h)
            and np.array_equal((lo.cpu().numpy() - (len(idx.keys) - n))[hit], lo_h[hit])):
        raise AssertionError("[mesh:modules] the device seed index != the host index")
    log(f"[mesh:modules] device_build_seedmap of the round-{at_round} contig ({L} bp, {n} "
        f"entries) == host build_seedmap: card {dev_idx_ms:.2f} ms, host {host_idx_ms:.2f} ms "
        f"(wall, the upload outside); device_lookup of {len(q)} queries ({int(hit.sum())} hits) "
        f"== host lookup_batch: card {dev_lk_ms:.2f} ms, host {host_lk_ms:.2f} ms")

    Lr = len(pre_evolve["codes"])
    refs = [ConsensusRef.from_state_dict(pre_evolve, capacity=6 * Lr + 1024) for _ in range(2)]
    host_ev_ms, _ = host_ms(refs[0].evolve)
    dev_ev_ms, _ = host_ms(evolve_on_device, refs[1], dev)
    if not (np.array_equal(refs[1].text(), refs[0].text()) and all(
            np.array_equal(getattr(refs[1], f)[refs[1].pre : refs[1].post],
                           getattr(refs[0], f)[refs[0].pre : refs[0].post])
            for f in ("sel", "sup", "total"))):
        raise AssertionError("[mesh:modules] evolve_on_device != the host evolve")
    log(f"[mesh:modules] evolve_on_device of the round-{at_round} reference before its evolve "
        f"({Lr} -> {refs[0].length()} boxes) == host ConsensusRef.evolve (full path): card "
        f"{dev_ev_ms:.2f} ms with the copies, host {host_ev_ms:.2f} ms")


def phase_mesh(torch, dev, port, reads, patterns, genome_len, ref_round, kept, counts,
               **shared):
    """The mesh phase (9): the engine on a 2-shard mesh of the card held to
    the K1 slice (`ref_round`: its recorded state, round times, contig and
    pre-evolve reference), the two-process collectives, the remaining
    modules against their plain versions, and the dry run's mesh paths."""
    t0 = time.perf_counter()
    mesh_engine(torch, dev, reads, patterns, genome_len, ref_round["state"],
                ref_round["round_s"], kept, counts, **shared)
    t1 = time.perf_counter()
    mesh_two_process(torch, dev, port)
    t2 = time.perf_counter()
    mesh_modules(torch, dev, ref_round["contig"], patterns[0], ref_round["pre_evolve"],
                 ref_round["at"])
    t3 = time.perf_counter()
    mesh_paths(torch, dev, kept, counts)
    log(f"[mesh] phase: engine {t1 - t0:.1f} s, two processes {t2 - t1:.1f} s, modules "
        f"{t3 - t2:.1f} s, mesh paths {time.perf_counter() - t3:.1f} s")


def phase_mesh_only(torch, dev, port, genome_len=4_600_000):
    """Only the mesh phase (--mesh-path): the K1 slice for MESH_ROUNDS
    rounds on one device as the reference (its round-MESH_ROUNDS contig
    and reference for the modules), then the phase; the kernel variants of
    the mesh round and of the mesh paths against their plain versions."""
    _, reads, patterns, _, k1 = slice_engine(torch, dev, genome_len, MESH_ROUNDS)
    with recorded(k1, MESH_ROUNDS, copy_round=MESH_ROUNDS) as rec:
        k1.run(out=None)
    ref_round = dict(rec, contig=k1.ref.text().copy(), at=MESH_ROUNDS)
    kept, counts = {}, {}
    phase_mesh(torch, dev, port, reads, patterns, genome_len, ref_round, kept, counts,
               trial_cache=k1._trial_cache, device_builder=k1._device_builder)
    del k1
    res = Results(float(nvidia_smi("clocks.max.sm").split()[0]))
    for path, k in kept.items():
        phase_main_path_kernels(torch, res, k, path)


# ------------------------------- the dry run's mesh paths (phase 9, step 4)

# tests/torch_mesh_paths.py: the store and settings of the multi-device dry
# run's three mesh paths (__graft_entry__.py, part 3): (a) the retreat run,
# (b) assemble_contigs(..., 3, dedupe=True), (c) a checkpoint at round 2
# resumed to round 6 (rng_seed 5)
MESH_PATHS = dict(max_round=30, rng_seed=1, pattern_schedule="roundrobin",
                  edge_retreat=2, edge_retreat_bite=48)
MESH_PATHS_CONTIGS = 3
MESH_PATHS_CHECKPOINT = dict(rng_seed=5, saved=2, rounds=6)
MESH_PATHS_KERNELS = ("bitwave_prefilter", "bitwave_fullscreen", "tbwave", "walk")


def mesh_paths_store():
    """(ReadStore, patterns): two unrelated 6,000-base segments (rng 7), each
    at 10x, reads 550-900 (mean 700), 2% each of sub/ins/del, seed 11; one
    pattern of 16 ones."""
    from pacbioassembly_tpu_torch.assemble import ReadStore
    from pacbioassembly_tpu_torch.codec import binary_io, dna
    from pacbioassembly_tpu_torch.tools.simulate import SimConfig, simulate

    rng = np.random.default_rng(7)
    segs = [rng.integers(0, 4, 6000).astype(np.uint8) for _ in range(2)]
    reads = []
    for g in segs:
        _, rl, _ = simulate(SimConfig(genome_len=len(g), coverage=10.0, mean_read_len=700,
                                      min_read_len=550, max_read_len=900, sub_rate=0.02,
                                      ins_rate=0.02, del_rate=0.02, seed=11), genome=g)
        reads += rl
    buf = io.BytesIO()
    binary_io.write_records(buf, reads)
    return (ReadStore(np.frombuffer(buf.getvalue(), dtype=np.uint8)),
            [dna.parse_pattern("1111111111111111")])


@contextlib.contextmanager
def kept_engines():
    """While the block runs: every BatchAssembler built, in order."""
    from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler

    engines = []
    real = BatchAssembler.__init__

    def init(self, *a, **k):
        real(self, *a, **k)
        engines.append(self)

    BatchAssembler.__init__ = init
    try:
        yield engines
    finally:
        BatchAssembler.__init__ = real


def mesh_paths_run(dev, mesh, reads, patterns, ck, paths="abc", **over) -> tuple[dict, dict]:
    """The paths in `paths` on `dev` over `mesh` (None: one shard), `over`
    replacing settings: ({path: result}, {path: (wall s, rounds)}). (a):
    run_fixture's result; (b): the ContigResults, survivors, log and each
    engine's state and counters; (c): run_fixture's results of the
    uninterrupted run ('full'), the run that saves checkpoint file `ck`
    ('saved') and the one resumed from it ('resumed')."""
    from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler, assemble_contigs
    from pacbioassembly_tpu_torch.config import AssemblyConfig

    cfg = AssemblyConfig(**dict(MESH_PATHS, **over))
    got, secs = {}, {}
    if "a" in paths:
        t0 = time.perf_counter()
        got["a"] = run_fixture(BatchAssembler(cfg, reads, patterns, device=dev, mesh=mesh))
        secs["a"] = (time.perf_counter() - t0, got["a"]["counters"][0])
    if "b" in paths:
        t0 = time.perf_counter()
        out = io.StringIO()
        with kept_engines() as engines:
            contigs, surv = assemble_contigs(cfg, reads, patterns, MESH_PATHS_CONTIGS, log=out,
                                             dedupe=True, device=dev, mesh=mesh)
        got["b"] = dict(contigs=[(c.codes.tolist(), c.nreads, c.nrounds) for c in contigs],
                        surviving=surv, log=out.getvalue(),
                        states=[state_of(e) for e in engines],
                        counters=[(e.nround, e.nfailure, e.retreats, e.fruitless_retreats,
                                   e.matches_since_retreat) for e in engines])
        secs["b"] = (time.perf_counter() - t0, sum(e.nround for e in engines))
    if "c" in paths:
        c = MESH_PATHS_CHECKPOINT
        base = dataclasses.replace(cfg, rng_seed=c["rng_seed"])
        t0 = time.perf_counter()
        runs = {}
        for name, kw in (("full", dict(max_round=c["rounds"])),
                         ("saved", dict(max_round=c["saved"], checkpoint_path=ck,
                                        checkpoint_every=c["saved"])),
                         ("resumed", dict(max_round=c["rounds"], resume_path=ck))):
            asm = BatchAssembler(dataclasses.replace(base, **kw), reads, patterns, device=dev,
                                 mesh=mesh)
            runs[name] = run_fixture(asm)
        got["c"] = runs
        secs["c"] = (time.perf_counter() - t0, c["rounds"] + c["rounds"])
    return got, secs


def same_run(a: dict, b: dict) -> bool:
    """run_fixture results: state, counters and log."""
    return same_state(a, b) and a["counters"] == b["counters"] and a["log"] == b["log"]


# the step's runs on the card: (key, path, settings over MESH_PATHS); a_pf is
# (a) with the prefilter forced on, as the store's rounds stay under its
# candidate threshold
MESH_PATHS_RUNS = (("a", "a", {}), ("b", "b", {}), ("c", "c", {}),
                   ("a_pf", "a", dict(prefilter_min_batch=1)))


def check_mesh_paths(tag, got, want):
    """`got`'s runs against `want`'s (the cpu's (b) and (c); (a) is the
    retreat run of (b)'s first engine)."""
    b, wb = got["b"], want["b"]
    if (b["contigs"], b["surviving"], b["log"], b["counters"]) != (
            wb["contigs"], wb["surviving"], wb["log"], wb["counters"]) or not all(
            same_state(x, y) for x, y in zip(b["states"], wb["states"])):
        raise AssertionError(f"[mesh paths] {tag}: (b) assemble_contigs differs")
    want_a = dict(wb["states"][0], counters=wb["counters"][0],
                  log=wb["log"][: wb["log"].index("=== contig 0")])
    if not same_run(got["a"], want_a):
        raise AssertionError(f"[mesh paths] {tag}: (a) the retreat run differs")
    if not same_run(got["c"]["full"], want["c"]["full"]):
        raise AssertionError(f"[mesh paths] {tag}: (c) the uninterrupted run differs")
    check_resumed(tag, got["c"]["resumed"], want["c"]["full"])


def check_resumed(tag, resumed, full):
    """A run resumed from (c)'s checkpoint against the uninterrupted one."""
    saved = MESH_PATHS_CHECKPOINT["saved"]
    if not (same_state(resumed, dict(full, history=full["history"][saved:]))
            and resumed["counters"] == full["counters"]):
        raise AssertionError(f"[mesh paths] {tag}: (c) the resumed run differs")


def mesh_paths(torch, dev, kept, counts):
    """Step 4 of the mesh phase: the dry run's three paths on 2 shards of
    the card, held to the port's cpu run (one shard) and to their 1-shard
    card runs; the checkpoint saved on 2 shards resumed on one; (a) once
    more with the prefilter forced on, 2 shards == 1 shard on the card. Per
    path the wall time, rounds and s/round on 2 and on 1 shard, and the
    launches by kernel variant."""
    from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler
    from pacbioassembly_tpu_torch.config import AssemblyConfig
    from pacbioassembly_tpu_torch.parallel import make_mesh

    t_step = time.perf_counter()
    reads, patterns = mesh_paths_store()
    kept["mesh-paths"] = MainPathInputs()
    calls = kept["mesh-paths"].calls
    by_run = {}

    def runs(mesh, ck, variants=False):
        got, secs = {}, {}
        for key, p, over in MESH_PATHS_RUNS:
            before = {k: sum(v.values()) for k, v in calls.items()}
            g, s = mesh_paths_run(dev, mesh, reads, patterns, ck, paths=p, **over)
            got[key], secs[key] = g[p], s[p]
            if variants:
                by_run[key] = {k: sum(v.values()) - before.get(k, 0) for k, v in calls.items()}
        return got, secs

    with tempfile.TemporaryDirectory() as tmp:
        ck = {k: os.path.join(tmp, f"{k}.npz") for k in ("m2", "one", "cpu")}
        (m2, secs2), counts["mesh-paths"] = run_path(
            torch, "mesh-paths", kept["mesh-paths"], MESH_PATHS_KERNELS,
            lambda: runs(make_mesh(devices=[dev, dev]), ck["m2"], variants=True))
        t_card = time.perf_counter()
        one, secs1 = runs(None, ck["one"])
        c = MESH_PATHS_CHECKPOINT
        cross = run_fixture(BatchAssembler(
            AssemblyConfig(**dict(MESH_PATHS, rng_seed=c["rng_seed"], max_round=c["rounds"],
                                  resume_path=ck["m2"])), reads, patterns, device=dev))
        t_cpu = time.perf_counter()
        cpu, _ = mesh_paths_run("cpu", None, reads, patterns, ck["cpu"], paths="bc")
        t_end = time.perf_counter()
    check_mesh_paths("2 shards of the card against the cpu", m2, cpu)
    check_mesh_paths("1 shard of the card against the cpu", one, cpu)
    check_resumed("the 2-shard checkpoint resumed on 1 shard of the card", cross,
                  cpu["c"]["full"])
    if not same_run(m2["a_pf"], one["a_pf"]):
        raise AssertionError("[mesh paths] (a) with the prefilter forced on: 2 shards != 1 shard")
    a, b = m2["a"], m2["b"]
    if not (a["counters"][2] == 2 and b["surviving"] == [] and len(b["contigs"]) == 2):
        raise AssertionError(f"[mesh paths] not the dry run's paths: (a) counters "
                             f"{a['counters']}, (b) {len(b['contigs'])} contigs, "
                             f"{len(b['surviving'])} reads left")
    names = {"a": "(a) retreat run", "b": "(b) assemble_contigs(3, dedupe)",
             "c": "(c) checkpoint at 2, resumed to 6 (+ 6 uninterrupted)",
             "a_pf": "(a) with prefilter_min_batch=1"}
    for key, _, _ in MESH_PATHS_RUNS:
        (w2, r2), (w1, r1) = secs2[key], secs1[key]
        variants = ", ".join(f"{k[0]} {k[1]}: {n}" for k, n in sorted(
            by_run[key].items(), key=lambda kv: str(kv[0])) if n)
        log(f"[mesh paths] {names[key]}: {r2} rounds, 2 shards {w2:.3f} s "
            f"({w2 / r2:.4f} s/round), 1 shard {w1:.3f} s ({w1 / r1:.4f} s/round); "
            f"launches by variant: {variants or 'none'}")
    log(f"[mesh paths] (a) {a['counters'][0]} rounds, {a['counters'][2]} retreats, "
        f"{len(a['contig'])} bp, {len(a['surviving'])} reads left; (b) contigs "
        f"{[len(x[0]) for x in b['contigs']]}, {len(b['surviving'])} reads left; (c) resumed "
        f"on 2 shards and on 1 == uninterrupted; every run on 2 shards == 1 shard, and (a), "
        f"(b), (c) == cpu")
    log(f"[mesh paths] step {t_end - t_step:.1f} s: card 2 shards {t_card - t_step:.1f} s, "
        f"card 1 shard {t_cpu - t_card:.1f} s, cpu {t_end - t_cpu:.1f} s")


# ----------------------------------------------- stall recovery (phase 10)

# tests/torch_retreat.py's fixtures (a) and (b): the stall store of
# tests/test_batch.py::test_edge_retreat_recovers_from_stall, cut one round
# after its retreat (round 19), and the fruitless store of
# tests/test_batch.py::test_fruitless_retreat_escape, whose retreats are
# fixed bites until the fruitless escape ends the run
STALL_KERNELS = ("bitwave_fullscreen", "tbwave", "walk")
STALL_ROUNDS = 20


def retreat_fixtures():
    """[(name, ReadStore, patterns, config)] of fixtures (a) and (b)."""
    from pacbioassembly_tpu_torch.assemble import ReadStore
    from pacbioassembly_tpu_torch.codec import binary_io, dna
    from pacbioassembly_tpu_torch.config import AssemblyConfig
    from pacbioassembly_tpu_torch.tools.simulate import SimConfig, simulate

    def store(reads):
        buf = io.BytesIO()
        binary_io.write_records(buf, reads)
        return ReadStore(np.frombuffer(buf.getvalue(), dtype=np.uint8))

    _, stall, _ = simulate(SimConfig(genome_len=30_000, coverage=14.0, mean_read_len=800,
                                     min_read_len=600, max_read_len=1000, sub_rate=0.05,
                                     ins_rate=0.05, del_rate=0.05, seed=21))
    rng = np.random.default_rng(0)
    _, few, _ = simulate(SimConfig(genome_len=3000, coverage=3.0, mean_read_len=900,
                                   min_read_len=600, max_read_len=1200, sub_rate=0.01,
                                   ins_rate=0.01, del_rate=0.01, seed=1))
    junk = [rng.integers(0, 4, 800).astype(np.uint8) for _ in range(3)]
    return [
        ("stall", store(stall), dna.load_patterns(SEEDS),
         AssemblyConfig(engine="batch", rng_seed=5, pattern_schedule="random", edge_retreat=8,
                        max_round=STALL_ROUNDS)),
        ("fruitless", store(few + junk), [dna.parse_pattern("1111111111111111")],
         AssemblyConfig(engine="batch", rng_seed=0, pattern_schedule="roundrobin",
                        edge_retreat=50, edge_retreat_bite=8, edge_retreat_fruitless=2)),
    ]


@contextlib.contextmanager
def retreat_spy():
    """While the block runs: the cells each ConsensusRef.retreat_edges and
    retreat_fixed call trimmed."""
    from pacbioassembly_tpu_torch.consensus.state import ConsensusRef

    trims = {"edges": [], "fixed": []}
    real = {k: getattr(ConsensusRef, f"retreat_{k}") for k in trims}

    def spy(kind):
        def call(self, *a, **kw):
            trims[kind].append(real[kind](self, *a, **kw))
            return trims[kind][-1]
        return call

    for k in trims:
        setattr(ConsensusRef, f"retreat_{k}", spy(k))
    try:
        yield trims
    finally:
        for k in trims:
            setattr(ConsensusRef, f"retreat_{k}", real[k])


def run_fixture(asm) -> dict:
    """state_of(asm) after its run, with its retreat counters and log."""
    out = io.StringIO()
    asm.run(out=None, log=out)
    return dict(state_of(asm), log=out.getvalue(),
                counters=(asm.nround, asm.nfailure, asm.retreats, asm.fruitless_retreats,
                          asm.matches_since_retreat))


def phase_stall(torch, dev, kept, counts):
    """Phase 10: fixtures (a) and (b) on the card and on the port's cpu,
    equal; a retreat and a fixed bite on the card; K1's full screen, K2 and
    W launch, no plain version."""
    from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler

    t0 = time.perf_counter()
    fixtures = retreat_fixtures()
    kept["stall"] = MainPathInputs()

    def on_card():
        return {name: run_fixture(BatchAssembler(cfg, reads, patterns, device=dev))
                for name, reads, patterns, cfg in fixtures}

    with retreat_spy() as trims:
        card, counts["stall"] = run_path(torch, "stall", kept["stall"], STALL_KERNELS, on_card)
    t1 = time.perf_counter()
    if not (any(trims["edges"]) and any(trims["fixed"])):
        raise AssertionError(f"[stall] no trimmed fringe or no fixed bite on the card: {trims}")
    for name, reads, patterns, cfg in fixtures:
        got, want = card[name], run_fixture(BatchAssembler(cfg, reads, patterns, device="cpu"))
        if not (same_state(got, want) and got["log"] == want["log"]
                and got["counters"] == want["counters"]):
            raise AssertionError(f"[stall] {name}: cuda != cpu")
        lines = [ln for ln in got["log"].splitlines() if ln.startswith("--- edge retreat")]
        nround, _, retreats, fruitless, _ = got["counters"]
        log(f"[stall] {name}: {nround} rounds, contig {len(got['contig'])} bp, {retreats} "
            f"retreats ({fruitless} fruitless), {lines[-1] if lines else 'no retreat'}; "
            f"RoundStats, contig bytes, votes, surviving reads, counters and log equal on cuda "
            f"and cpu")
    log(f"[stall] cells trimmed on the card: fringe {trims['edges']}, fixed bites "
        f"{trims['fixed']}; phase {time.perf_counter() - t0:.1f} s (card {t1 - t0:.1f} s)")


# ------------------------------------------- the engine's branches (phase 11)

# tests/torch_branches.py: synth2 with the quirks of
# tests/test_pipeline_variants.py, one pattern, round-robin
SYNTH2 = os.path.join(REPO, "tests", "data")
BRANCH_CASES = {
    "locked": dict(locked=True, max_round=5),
    "dump": dict(ratio=0.25, max_trial=16, dump_path="-", max_round=10),
    "host_traceback": dict(device_traceback=False, max_round=10),
}
BRANCH_KERNELS = ("bitwave_fullscreen", "tbwave", "walk")


def branch_run(dev, case) -> dict:
    """One case of BRANCH_CASES on `dev`: state_of, the printed consensus
    and the dump."""
    from pacbioassembly_tpu_torch.assemble import ReadStore
    from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler
    from pacbioassembly_tpu_torch.codec import dna
    from pacbioassembly_tpu_torch.config import AssemblyConfig

    cfg = AssemblyConfig(engine="batch", initial_ref_path=os.path.join(SYNTH2, "synth2_init.txt"),
                         pattern_schedule="roundrobin", quirk_init_newline=True,
                         quirk_seed_at=True, **BRANCH_CASES[case])
    reads = ReadStore.from_file(os.path.join(SYNTH2, "synth2_reads.bin"), cfg)
    dump = io.StringIO() if cfg.dump_path else None
    asm = BatchAssembler(cfg, reads, dna.load_patterns(os.path.join(SYNTH2, "oneseed_full.txt")),
                         dump=dump, device=dev)
    out = io.StringIO()
    t0 = time.perf_counter()
    asm.run(out=out)
    return dict(state_of(asm), out=out.getvalue(), dump=dump.getvalue() if dump else "",
                wall=time.perf_counter() - t0, nround=asm.nround)


def phase_branches(torch, dev, kept, counts):
    """Phase 11: the engine's branches off the main path on the card and on
    the port's cpu, equal (printed consensus, dump bytes, RoundStats,
    contig, votes, survivors): `-l` (no K2, no W: every alignment on the
    host; the output also equal to golden_consensus_locked.txt under the
    newline-as-'T' rule), `-d` (K2 and W launch) and
    `device_traceback=False` (no K2, no W)."""
    from pacbioassembly_tpu_torch import _build

    t0 = time.perf_counter()
    kept["branches"] = MainPathInputs()
    per_case = {}

    def on_card():
        got = {}
        for case in BRANCH_CASES:
            before = dict(_build.LAUNCHES)
            got[case] = branch_run(dev, case)
            per_case[case] = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v > before[k]}
        return got

    card, counts["branches"] = run_path(torch, "branches", kept["branches"], BRANCH_KERNELS,
                                        on_card)
    t1 = time.perf_counter()
    golden = open(os.path.join(SYNTH2, "golden_consensus_locked.txt")).read()
    for case in BRANCH_CASES:
        got, want = card[case], branch_run("cpu", case)
        if not (same_state(got, want) and got["out"] == want["out"]
                and got["dump"] == want["dump"]):
            raise AssertionError(f"[branches] {case}: cuda != cpu")
        k2w = {k: per_case[case].get(k, 0) for k in ("tbwave", "walk")}
        if (case == "dump") != all(k2w.values()) or (case != "dump" and any(k2w.values())):
            raise AssertionError(f"[branches] {case}: K2 / W launches {k2w}")
        if case == "locked" and not (len(golden) == len(got["out"]) and all(
                g == m or (g == "\n" and m == "T") for g, m in zip(golden, got["out"]))):
            raise AssertionError("[branches] locked: not golden_consensus_locked.txt")
        log(f"[branches] {case}: {got['nround']} rounds, contig {len(got['contig'])} bp, "
            f"{len(got['surviving'])} reads left, dump {len(got['dump'])} bytes; launches "
            f"{per_case[case]}; printed consensus, dump, RoundStats, contig, votes and survivors "
            f"equal on cuda ({got['wall']:.3f} s) and cpu ({want['wall']:.3f} s)")
    log(f"[branches] phase {time.perf_counter() - t0:.1f} s (card {t1 - t0:.1f} s)")


# ---------------------------------------------------------------- --genome

RESULTS = os.path.join(REPO, "benchmarks", "results")
# benchmarks/ecoli_scale.py's config with the flags of both committed runs
# (--contigs 64 --edge-retreat 400 --retreat-bite 96 --retreat-min-len 20000
# --retreat-fruitless 3, uncapped rounds; max_seq_len = genome_len + 500 kb)
GENOME_CONFIG = dict(engine="batch", rng_seed=7, pattern_schedule="random",
                     dedupe_diagonals=True, edge_retreat=400, edge_retreat_bite=96,
                     edge_retreat_min_len=20_000, edge_retreat_fruitless=3, max_trial=32,
                     max_seq_len=5_100_000, checkpoint_every=50)


@dataclasses.dataclass(frozen=True)
class GenomeRun:
    """One committed whole-genome run of the JAX package (benchmarks/results/
    <name>_{metrics.jsonl,summary.json,...}) that --genome <key> is held to:
    the read store it assembled (simulate_store's arguments), the engine
    config and number of contigs, and the file its contigs are compared
    with: contig 0 alone (`contig0`, a gzipped text line) or every contig
    the dedupe keeps (`assembly`, a gzipped FASTA)."""

    name: str
    store: dict
    label: str
    contig0: str | None = None
    assembly: str | None = None
    config: dict = dataclasses.field(default_factory=lambda: dict(GENOME_CONFIG))
    contigs: int = 64

    @property
    def prefix(self) -> str:
        return os.path.join(RESULTS, self.name)


E_COLI = dict(genome_len=4_600_000, coverage=30.0, mean_read_len=2500, seed=11,
              max_read_len=19_000)
GENOME_RUNS = {
    "3pct": GenomeRun("ecoli_wg_3pct_r5", dict(E_COLI, error=0.03, profile="uniform"),
                      "3% uniform error", contig0="ecoli_wg_3pct_r5_contig0.txt.gz"),
    "clr": GenomeRun("ecoli_wg_15pct_clr_r5", dict(E_COLI, error=0.15, profile="clr"),
                     "15% CLR error (1:12:4 substitutions, insertions, deletions)",
                     assembly="ecoli_wg_15pct_clr_r5_assembly.fasta.gz"),
}
GENOME_GATED = ("nround", "pattern", "ref_len", "nmatches", "ntrials", "nreads_left", "retreats")
GENOME_SHOWN = ("prefilter_kept", "host_aligns", "device_commits", "fullscreen_n",
                "seedmap_size", "dropped_candidates")
GENOME_PHASES = ("seedmap_s", "expand_s", "screen_s", "commit_s", "evolve_s", "lookup_s",
                 "prefilter_s", "fullscreen_s", "tb_s", "host_commit_s", "elect_s")
GENOME_KERNELS = ("bitwave_prefilter", "bitwave_fullscreen", "tbwave", "walk")
RESIDUAL_MIN_LEN = 50_000  # ecoli_scale.py: contigs that get a residual of their own
CLASSIFY_MIN_CONTIG = 10_000  # classify_reads' default: contigs it maps onto
ACCOUNTING = ("total", "mapped", "seeded_only", "unseedable", "too_short")


def committed_segments(path) -> list[dict]:
    """A metrics JSONL as one {nround: row} per engine run (one contig)."""
    segs = []
    with open(path) as fh:
        for line in fh:
            r = json.loads(line)
            if r["event"] == "run_start":
                segs.append({})
            elif r["event"] == "round":
                segs[-1][r["nround"]] = r
    return segs


def assembly_fasta(contigs) -> str:
    """benchmarks/results' assembly FASTA of the kept contigs (in build
    order): longest first, `>contig_k len=L src=contig_j.txt` with j the
    contig's place in the kept list, 80 bases a line."""
    from pacbioassembly_tpu_torch.codec import dna

    order = sorted(range(len(contigs)), key=lambda j: -len(contigs[j]))
    out = []
    for k, j in enumerate(order):
        text = dna.codes_to_text(contigs[j])
        out.append(f">contig_{k} len={len(text)} src=contig_{j}.txt\n")
        out.extend(text[i:i + 80] + "\n" for i in range(0, len(text), 80))
    return "".join(out)


def committed_residuals(summary) -> tuple[list, float | None]:
    """(per kept contig its residual or None, the aggregate) as the summary
    holds them: benchmarks/ecoli_scale.py puts each in coverage_eval."""
    return ([c.get("residual_error") for c in summary["coverage_eval"]["per_contig"]],
            summary.get("assembly_residual_error"))


@contextlib.contextmanager
def gated_rounds(want, rows, diffs, run_name, every=100):
    """While the block runs, each round an engine writes to its metrics
    (MetricsLogger.round) is appended to rows[-1], one list per contig, and
    held to the same round of want[len(rows) - 1] on GENOME_GATED: the first
    divergent round raises with both rows. The GENOME_SHOWN fields that
    differ go to `diffs`. Every `every` rounds a progress line."""
    from pacbioassembly_tpu_torch.utils import metrics

    real = metrics.MetricsLogger.round
    t0 = time.perf_counter()

    def gated(self, stats, extra=None):
        rec = real(self, stats, extra)
        ci = len(rows) - 1
        rows[ci].append(rec)
        ref = (want[ci] if ci < len(want) else {}).get(rec["nround"])
        if ref is None or any(rec[k] != ref[k] for k in GENOME_GATED):
            raise AssertionError(
                f"[genome] contig {ci} round {rec['nround']} diverges from "
                f"{run_name} on {GENOME_GATED}:\n  port: {json.dumps(rec)}\n"
                f"  committed: {json.dumps(ref)}")
        d = {k: [rec.get(k), ref.get(k)] for k in GENOME_SHOWN if rec.get(k) != ref.get(k)}
        if d:
            diffs.append(dict(contig=ci, nround=rec["nround"], **d))
        if rec["nround"] % every == 0:
            log(f"[genome] contig {ci} round {rec['nround']}: ref_len {rec['ref_len']}, "
                f"{rec['nreads_left']} reads left, retreats {rec['retreats']}, "
                f"{time.perf_counter() - t0:.1f} s into this run")
        return rec

    metrics.MetricsLogger.round = gated
    try:
        yield
    finally:
        metrics.MetricsLogger.round = real


class EngineLog:
    """The engines' log, appended to a file; retreat lines echoed."""

    def __init__(self, path):
        self.fh = open(path, "a")

    def write(self, s):
        self.fh.write(s)
        if s.startswith("--- edge retreat"):
            log(f"[genome] {s.rstrip()}")

    def close(self):
        self.fh.close()


def save_contigs(path, results, surviving):
    tmp = path + ".tmp.npz"
    np.savez(tmp, codes=np.concatenate([c.codes for c in results]),
             lens=np.array([len(c.codes) for c in results]),
             nreads=np.array([c.nreads for c in results]),
             nrounds=np.array([c.nrounds for c in results]),
             surviving=np.array(surviving, dtype=np.int64))
    os.replace(tmp, path)


def load_contigs(path):
    from pacbioassembly_tpu_torch.assemble.batch import ContigResult

    z = np.load(path)
    cuts = np.cumsum(z["lens"])[:-1]
    results = [ContigResult(c.astype(np.uint8), int(n), int(r))
               for c, n, r in zip(np.split(z["codes"], cuts), z["nreads"], z["nrounds"])]
    return results, z["surviving"].astype(np.int64).tolist()


def genome_assemble(torch, dev, out, resume, reads, patterns, cfg, n_contigs, want, kept,
                    run_name):
    """The per-contig loop of benchmarks/ecoli_scale.py on `dev`: up to
    n_contigs engines at rng_seed + ci on the surviving reads, sharing the
    trial cache and the device builder, each with its round checkpoint
    out/ck_<ci>.npz (resumed with `resume`); the finished contigs go to
    out/wg_state.npz and their records to out/wg_contigs.json after each
    one. Every round is held to `want` (gated_rounds). Returns (contigs,
    surviving reads, records of every contig, the SHOWN differences)."""
    from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler, ContigResult

    state, info = os.path.join(out, "wg_state.npz"), os.path.join(out, "wg_contigs.json")
    results, surviving, records = [], None, []
    if resume and os.path.exists(state):
        results, surviving = load_contigs(state)
        with open(info) as fh:
            records = json.load(fh)
        log(f"[genome] resuming after {len(results)} contigs ({len(surviving)} reads left)")
    rows, diffs = [[] for _ in results], []
    cache = builder = None
    engine_log = EngineLog(os.path.join(out, "engine.log"))
    try:
        with gated_rounds(want, rows, diffs, run_name):
            for ci in range(len(results), n_contigs):
                if surviving is not None and not surviving:
                    break
                ck = os.path.join(out, f"ck_{ci}.npz")
                resumed = resume and os.path.exists(ck)
                c = dataclasses.replace(cfg, rng_seed=cfg.rng_seed + ci, checkpoint_path=ck,
                                        resume_path=ck if resumed else None)
                asm = BatchAssembler(c, reads, patterns, surviving=surviving, trial_cache=cache,
                                     device_builder=builder, device=dev)
                before = len(asm.surviving)
                rows.append([])
                t0 = time.perf_counter()
                asm.run(out=None, log=engine_log)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if asm.nround != max(want[ci]):
                    raise AssertionError(f"[genome] contig {ci} ended at round {asm.nround}, the "
                                         f"committed run's at round {max(want[ci])}")
                results.append(ContigResult(codes=asm.ref.text().copy(),
                                            nreads=before - len(asm.surviving),
                                            nrounds=asm.nround))
                rs = [r["round_s"] for r in rows[-1]]
                records.append(dict(
                    contig=ci, len=len(results[-1].codes), reads=results[-1].nreads,
                    rounds=asm.nround, rounds_here=len(rs), resumed=resumed, pid=os.getpid(),
                    wall_s=wall,
                    round_s_p50=float(np.percentile(rs, 50)),
                    round_s_p95=float(np.percentile(rs, 95)), retreats=asm.retreats,
                    card_mib=(torch.cuda.memory_allocated() - kept.nbytes) / 2**20,
                    **{k: float(sum(r.get(k, 0.0) for r in rows[-1])) for k in GENOME_PHASES}))
                r = records[-1]
                log(f"[genome] contig {ci}: {r['len']} bp from {r['reads']} reads in "
                    f"{r['rounds']} rounds ({r['rounds_here']} in this run), {wall:.1f} s; "
                    f"s/round p50 {r['round_s_p50']:.4f} p95 {r['round_s_p95']:.4f}; "
                    f"{r['retreats']} retreats; card memory allocated after it "
                    f"{r['card_mib']:.1f} MiB; phases " + ", ".join(
                        f"{k} {r[k]:.1f}" for k in GENOME_PHASES))
                surviving = asm.surviving
                cache, builder = asm._trial_cache, asm._device_builder
                del asm
                save_contigs(state, results, surviving)
                with open(info, "w") as fh:
                    json.dump(records, fh)
                if os.path.exists(ck):
                    os.remove(ck)  # the contig is finished; its round checkpoint is obsolete
    finally:
        engine_log.close()
    with open(os.path.join(out, "shown_differences.jsonl"), "a") as fh:
        for d in diffs:
            fh.write(json.dumps(d) + "\n")
    return results, surviving, records, diffs


def saved_gate(out, name, compute):
    """A gate's result kept in out/<name>.json: computed (and saved) by the
    first call that reaches it, read back by a resumed one. Returns (result,
    seconds it took)."""
    path = os.path.join(out, f"{name}.json")
    if os.path.exists(path):
        with open(path) as fh:
            got = json.load(fh)
        log(f"[genome] {name}: read back from {path} (computed by an earlier call, "
            f"{got['seconds']:.1f} s)")
        return got["result"], got["seconds"]
    t0 = time.perf_counter()
    result = compute()
    seconds = time.perf_counter() - t0
    with open(path + ".tmp", "w") as fh:
        json.dump({"result": result, "seconds": seconds}, fh)
    os.replace(path + ".tmp", path)
    return result, seconds


def genome_gates(torch, dev, run, summary, cfg, genome, reads, patterns, results, surviving,
                 kept, out):
    """The end gates against the committed run, in benchmarks/ecoli_scale.py's
    order: the contigs built and dropped by the dedupe, the reads consumed,
    the contigs against the committed file byte for byte, the residual error
    of the largest kept contig and of each kept contig of RESIDUAL_MIN_LEN
    or more with their aggregate (on the card), the coverage evaluation
    holding them, and the surviving reads classified (on the card). The
    residuals and the classification are kept in `out` as each finishes
    (saved_gate). Returns a dict of what the gates read."""
    import gzip

    from pacbioassembly_tpu_torch.codec import dna
    from pacbioassembly_tpu_torch.tools import coverage, locate
    from pacbioassembly_tpu_torch.tools.postprocess import classify_reads, dedupe_contigs
    from pacbioassembly_tpu_torch.tools.simulate import SimConfig, simulate

    kept_idx, dropped = dedupe_contigs([c.codes for c in results])
    for d in dropped:
        d["len"] = len(results[d["idx"]].codes)
    consumed = len(reads) - len(surviving)
    committed = summary.get("contigs_dropped_contained", [])  # left out when none
    kept_codes = [results[i].codes for i in kept_idx]
    kept_rounds = sum(results[i].nrounds for i in kept_idx)
    log(f"[genome] {len(results)} contigs built, dedupe dropped {len(dropped)}: {dropped}; "
        f"{consumed} of {len(reads)} reads consumed, {len(surviving)} survive; the "
        f"{len(kept_idx)} kept contigs took {kept_rounds} of "
        f"{sum(c.nrounds for c in results)} rounds")
    if (dropped != committed or consumed != summary["reads_consumed"]
            or len(reads) != summary["n_reads"]
            or len(surviving) != summary["n_reads"] - summary["reads_consumed"]
            or len(results) != len(dropped) + len(summary["contig_lens"])
            or sorted(map(len, kept_codes), reverse=True) != summary["contig_lens"]
            or kept_rounds != summary["rounds"]):
        raise AssertionError(
            f"[genome] contigs or reads differ from the committed summary: dropped "
            f"{committed}, contig_lens {summary['contig_lens']}, {summary['rounds']} rounds in "
            f"the kept contigs, {summary['reads_consumed']} of {summary['n_reads']} consumed")
    if run.contig0:
        with gzip.open(os.path.join(RESULTS, run.contig0), "rt") as fh:
            want0 = dna.text_to_codes(fh.read().strip())
        got0 = results[0].codes
        if not np.array_equal(got0, want0):
            n = min(len(got0), len(want0))
            first = int(np.argmax(got0[:n] != want0[:n])) if (got0[:n] != want0[:n]).any() else n
            raise AssertionError(f"[genome] contig 0 ({len(got0)} bp) != the committed contig "
                                 f"({len(want0)} bp); first difference at {first}")
        log(f"[genome] contig 0 == {run.contig0} byte for byte ({len(got0)} bp)")
    else:
        with gzip.open(os.path.join(RESULTS, run.assembly), "rt") as fh:
            want_fa = fh.read()
        got_fa = assembly_fasta(kept_codes)
        if got_fa != want_fa:
            got_r, want_r = got_fa.splitlines(), want_fa.splitlines()
            first = next((i for i, (x, y) in enumerate(zip(got_r, want_r)) if x != y),
                         min(len(got_r), len(want_r)))
            raise AssertionError(
                f"[genome] the {len(kept_codes)} kept contigs != {run.assembly}: first "
                f"different line {first}: port {got_r[first][:100] if first < len(got_r) else None!r}, "
                f"committed {want_r[first][:100] if first < len(want_r) else None!r}")
        log(f"[genome] the {len(kept_codes)} kept contigs == {run.assembly} byte for byte "
            f"({len(got_fa)} bytes, {sum(map(len, kept_codes))} bp)")
    log(f"[genome] the committed run took {summary['wall_s']} s on a TPU v5e (the JAX package)")

    # benchmarks/ecoli_scale.py's residuals: CCS-like reads at 2x, seed + 1,
    # onto the largest kept contig and onto each of RESIDUAL_MIN_LEN or more
    ccs = SimConfig(genome_len=len(genome), coverage=2.0, mean_read_len=2500,
                    sub_rate=0.004, ins_rate=0.003, del_rate=0.003, seed=run.store["seed"] + 1)
    _, ccs_reads, _ = simulate(ccs, genome=genome)
    best = max(range(len(kept_codes)), key=lambda i: len(kept_codes[i]))
    own = [i for i, c in enumerate(kept_codes)
           if len(kept_codes) == 1 or len(c) >= RESIDUAL_MIN_LEN]
    scored = own + [best] * (best not in own)

    def residuals():
        qs = {}
        for i in scored:
            t0 = time.perf_counter()
            qs[str(i)] = locate.residual_error(kept_codes[i], patterns[0], ccs_reads, 0.15,
                                               device=dev)
            log(f"[genome] residual of kept contig {i} ({len(kept_codes[i])} bp) on the card "
                f"in {time.perf_counter() - t0:.1f} s: {qs[str(i)]}")
        return qs

    def on_card(name, fn):
        return saved_gate(
            out, name, lambda: run_path(torch, f"genome:{name}", kept, ("bitwave_locate",), fn)[0])

    qs, residual_s = on_card("residuals", residuals)
    qs = {int(i): q for i, q in qs.items()}
    keys = ("mapped", "total", "residual_error", "total_cost", "total_len")
    got_q = {k: qs[best][k] for k in keys}
    want_q = {k: summary["quality"][k] for k in keys}
    log(f"[genome] residual error of the largest contig ({len(kept_codes[best])} bp): {got_q}")
    if got_q != want_q:
        raise AssertionError(f"[genome] residual {got_q} != the committed {want_q}")
    per_contig = [(qs[i]["residual_error"] if i in own else None) for i in range(len(kept_codes))]
    agg_len = sum(qs[i]["total_len"] for i in own)
    aggregate = round(sum(qs[i]["total_cost"] for i in own) / agg_len, 4) if agg_len else None
    want_pc, want_agg = committed_residuals(summary)
    log(f"[genome] residuals of {len(own)} kept contigs on the card ({residual_s:.1f} s): "
        f"{per_contig}, aggregate {aggregate}")
    if per_contig != want_pc or aggregate != want_agg:
        raise AssertionError(f"[genome] residuals {per_contig}, aggregate {aggregate} != the "
                             f"committed {want_pc}, {want_agg}")

    t0 = time.perf_counter()
    ev = coverage.evaluate_assembly(genome, kept_codes)
    for c, r in zip(ev["per_contig"], per_contig):
        c["residual_error"] = r
    evaluate_s = time.perf_counter() - t0
    got_ev = json.loads(json.dumps(ev))
    log(f"[genome] evaluate_assembly ({evaluate_s:.1f} s): genome covered "
        f"{ev['genome_covered']}, fraction {ev['genome_fraction']}, N50 {ev['n50']}, "
        f"misassemblies {ev['misassemblies']}, max break {ev['max_break']}")
    if got_ev != summary["coverage_eval"]:
        raise AssertionError(f"[genome] coverage {got_ev} != the committed "
                             f"{summary['coverage_eval']}")

    accounting, classify_s = None, None
    committed_acc = summary.get("unconsumed_accounting")  # left out when every read was consumed
    want_acc = committed_acc and {k: committed_acc[k] for k in ACCOUNTING}
    if surviving:
        def classify():
            got = classify_reads(kept_codes, [reads.codes(i) for i in surviving], patterns[0],
                                 cfg.ratio, CLASSIFY_MIN_CONTIG, device=dev)
            return {k: got[k] for k in ACCOUNTING}
        accounting, classify_s = on_card("classify", classify)
        log(f"[genome] classify_reads on the card: {accounting} in {classify_s:.1f} s (the "
            f"committed run: {committed_acc and committed_acc['classify_s']} s on a TPU v5e "
            f"and its host)")
    if accounting != want_acc:
        raise AssertionError(f"[genome] read accounting {accounting} != the committed {want_acc}")
    return dict(residual=got_q, per_contig_residual=per_contig, assembly_residual=aggregate,
                residual_s=residual_s, evaluate_s=evaluate_s, accounting=accounting,
                classify_s=classify_s, genome_covered=ev["genome_covered"],
                misassemblies=ev["misassemblies"], max_break=ev["max_break"])


def phase_genome(torch, dev, res, out, resume, key="3pct"):
    """The --genome mode: GENOME_RUNS[key]'s 4.6 Mb E. coli store,
    assembled with stall recovery into up to run.contigs contigs on the
    card, held round for round to the committed run, then its end gates
    and every kernel variant it launched against its plain version."""
    from pacbioassembly_tpu_torch.align.screen import ladder_size
    from pacbioassembly_tpu_torch.codec import dna
    from pacbioassembly_tpu_torch.config import AssemblyConfig

    run = GENOME_RUNS[key]
    os.makedirs(out, exist_ok=True)
    if not resume:
        for f in os.listdir(out):
            if f.startswith(("ck_", "wg_", "metrics", "engine", "shown_", "residuals",
                             "classify")):
                os.remove(os.path.join(out, f))
    with open(run.prefix + "_summary.json") as fh:
        summary = json.load(fh)
    t0 = time.perf_counter()
    genome, reads = simulate_store(**run.store)
    patterns = dna.load_patterns(SEEDS)
    log(f"[genome] {run.name}: simulated 4.6 Mb @ 30x, {run.label}, seed {run.store['seed']}: "
        f"{len(reads)} reads in {time.perf_counter() - t0:.1f} s")
    want = committed_segments(run.prefix + "_metrics.jsonl")
    cfg = AssemblyConfig(**run.config, metrics_path=os.path.join(out, "metrics.jsonl"))
    kept = MainPathInputs()
    # a run from the first round launches every kernel of the path, a
    # resumed one some of them
    fresh = not (resume and any(f.startswith(("ck_", "wg_state")) for f in os.listdir(out)))
    t0 = time.perf_counter()
    (results, surviving, records, diffs), counts = run_path(
        torch, "genome", kept, GENOME_KERNELS,
        lambda: genome_assemble(torch, dev, out, resume, reads, patterns, cfg, run.contigs,
                                want, kept, run.name),
        every=fresh)
    wall = time.perf_counter() - t0
    here = [r["card_mib"] for r in records if r["pid"] == os.getpid()]
    window_mib = 2 * ladder_size(max(r["len"] for r in records), 8192) / 2**20
    log(f"[genome] assembly wall {wall:.1f} s in this run, "
        f"{sum(r['wall_s'] for r in records):.1f} s over the contigs of every run; "
        f"{sum(r['rounds_here'] for r in records)} rounds in {len(records)} contigs held to "
        f"{run.name} on {GENOME_GATED}; {len(diffs)} rounds differ only outside them"
        + (f", first {diffs[:3]}" if diffs else ""))
    if len(results) != len(want) or [r.nrounds for r in results] != [max(w) for w in want]:
        raise AssertionError(f"[genome] {len(results)} contigs, the committed run {len(want)}")
    if here and max(here) > here[0] + window_mib:
        raise AssertionError(f"[genome] the card's allocated memory grew from contig to contig: "
                             f"{here}")
    gates = genome_gates(torch, dev, run, summary, cfg, genome, reads, patterns, results,
                         surviving, kept, out)
    phase_main_path_kernels(torch, res, kept, f"genome-{key}")
    print(json.dumps({"genome": {
        "run": run.name, "contigs": records,
        "assembly_wall_s": sum(r["wall_s"] for r in records),
        "rounds": sum(r["rounds"] for r in records),
        "phase_sums_s": {k: sum(r[k] for r in records if k in r) for k in GENOME_PHASES},
        "shown_differences": len(diffs), **gates,
        "launches": {k: counts[k] for k in GENOME_KERNELS},
        "kernels": [r for r in res.rows if r.get("path") == f"genome-{key}"]}}), flush=True)


ROUTES = {
    "bitwave": ("pacbioassembly_tpu_torch/csrc/bitwave.cu", "pacbioassembly_tpu/align/bitwave.py:148"),
    "rowdp": ("pacbioassembly_tpu_torch/csrc/wavefront.cu", "pacbioassembly_tpu/align/wavefront.py:67"),
    "tbwave": ("pacbioassembly_tpu_torch/csrc/tbwave.cu", "pacbioassembly_tpu/align/tbwave.py:58"),
    "walk": ("pacbioassembly_tpu_torch/csrc/walk.cu", "pacbioassembly_tpu/align/tbwave.py:254"),
}


def thread_build(_build) -> dict | None:
    """ptxas's report of K1's thread build (registers, stack, spills), when
    this process built the kernels."""
    import ast

    for line in _build.ptxas_report:
        name, _, props = line.partition(": ")
        if name.startswith("bitwave_kernel"):
            return dict(ast.literal_eval(props), kernel=name)
    return None


def kernel_line(res: Results, counts, ptxas=None) -> list[dict]:
    """One entry per kernel counter; ms, plain_ms and bound_ms at the
    paths' variant with the most launches; launches summed over the
    paths (each path's counts were read right after it)."""
    from pacbioassembly_tpu_torch import _build

    out = []
    for k in _build.KERNELS:
        src, repl = ROUTES[k.split("_")[0]]
        main = [r for r in res.rows if r["kernel"] == k and r["where"] == "main-path"]
        if not main:
            raise AssertionError(f"kernel {k} has no main-path replay")
        top = max(main, key=lambda r: r["launches"])
        out.append({
            "name": k, "route": "cuda", "source": src, "replaces": repl,
            "launches": sum(c[k] for c in counts.values()), "max_abs_err": res.err[k],
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None, "shape": top["shape"],
            "wrapper_ms": top["wrapper_ms"],
        })
        if k == "bitwave_prefilter" and ptxas is not None:
            out[-1]["ptxas"] = ptxas
    return out


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--kernels", action="store_true",
                      help="drive only the kernels against their plain versions at the "
                           "synthetic shapes (phase 2 without the launch shapes), to compare "
                           "two trees of the port")
    mode.add_argument("--k1-slice", action="store_true",
                      help="drive only the K1 path's E. coli slice and its profiled rounds "
                           "(phase 3), to compare two trees of the port")
    mode.add_argument("--k3-slice", action="store_true",
                      help="drive only the K3 path's E. coli slice on its own store and "
                           "locate through K3 onto its contig, to compare two trees of the port")
    mode.add_argument("--contigs-path", action="store_true",
                      help="drive only the multi-contig path (phase 8), to compare two trees "
                           "of the port")
    mode.add_argument("--mesh-path", action="store_true",
                      help="drive only the mesh phase (9): the engine on 2 shards of the card "
                           "against MESH_ROUNDS rounds of the K1 slice, the two-process "
                           "collectives, the remaining modules and the dry run's mesh paths")
    mode.add_argument("--genome", nargs="?", const="3pct", choices=sorted(GENOME_RUNS),
                      help="the whole 4.6 Mb E. coli genome with stall recovery, every round "
                           "held to a committed run of the JAX package: 3pct (the default; "
                           "benchmarks/results/ecoli_wg_3pct_r5, about 10 minutes) or clr "
                           "(ecoli_wg_15pct_clr_r5, 64 contigs)")
    ap.add_argument("--out", default=None,
                    help="with --genome: the directory of its checkpoints, metrics and logs "
                         "(default: a temporary one)")
    ap.add_argument("--resume", action="store_true",
                    help="with --genome --out DIR: go on from DIR's finished contigs and the "
                         "current contig's round checkpoint")
    ap.add_argument("--parallel-commit", action="store_true",
                    help="with --k1-slice: the engine's two-thread host commit "
                         "(cfg.parallel_commit)")
    ap.add_argument("--port", default=REPO,
                    help="directory whose pacbioassembly_tpu_torch is driven (default: "
                         "this checkout), e.g. an unpacked `git archive` of another commit")
    args = ap.parse_args()
    if args.parallel_commit and not args.k1_slice:
        ap.error("--parallel-commit goes with --k1-slice")
    if (args.out or args.resume) and not args.genome:
        ap.error("--out and --resume go with --genome")
    if args.resume and not args.out:
        ap.error("--resume needs --out DIR")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    port = os.path.abspath(args.port)
    if not os.path.isdir(os.path.join(port, "pacbioassembly_tpu_torch")):
        print(f"chip_smoke: no pacbioassembly_tpu_torch in {port}: run the script from a checkout "
              f"of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, port)
    from pacbioassembly_tpu_torch import _build

    t_all = time.perf_counter()
    smi = nvidia_smi()
    clock = float(nvidia_smi("clocks.max.sm").split()[0])
    name = torch.cuda.get_device_name(0)
    log(f"[device] {smi}, max SM clock {clock:.0f} MHz | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {name} | port {os.path.dirname(os.path.dirname(_build.__file__))}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    built = _build.build_seconds
    log(f"[device] kernels ready in {time.perf_counter() - t0:.1f} s "
        f"({'built' if built is not None else 'cached'}: nvcc {built or 0:.1f} s)")
    ptxas = thread_build(_build)
    log(f"[device] K1 thread build: {ptxas if ptxas else 'not measured (cached build)'}")

    one_phase = (args.kernels or args.k1_slice or args.k3_slice or args.contigs_path
                 or args.mesh_path or args.genome)
    if args.kernels:
        phase_kernels(torch, dev, Results(clock))
    elif args.k1_slice:
        phase_k1_slice_only(torch, dev, parallel_commit=args.parallel_commit)
    elif args.k3_slice:
        phase_k3_slice_only(torch, dev)
    elif args.contigs_path:
        phase_contigs(torch, dev, replay=False)
    elif args.mesh_path:
        phase_mesh_only(torch, dev, os.path.abspath(args.port))
    elif args.genome:
        with (contextlib.nullcontext(args.out) if args.out
              else tempfile.TemporaryDirectory()) as out:
            phase_genome(torch, dev, Results(clock), out, args.resume, args.genome)
    else:
        for line in _build.ptxas_report:
            log(f"[device] ptxas {line}")
        res = Results(clock)
        phase_kernels(torch, dev, res)
        phase_kernel_shapes(torch, dev)
        counts, kept, rowdp, genome, ref_round = phase_slices(torch, dev)
        phase_locate(torch, dev, rowdp, rowdp.ref.text().copy(), counts, kept)
        counts["contigs"], kept["contigs"] = phase_contigs(torch, dev)
        phase_mesh(torch, dev, os.path.abspath(args.port), rowdp.reads, rowdp.patterns,
                   len(genome), ref_round, kept, counts, trial_cache=rowdp._trial_cache,
                   device_builder=rowdp._device_builder)
        phase_stall(torch, dev, kept, counts)
        phase_branches(torch, dev, kept, counts)
        seen = set()
        for path, k in kept.items():
            seen |= phase_main_path_kernels(torch, res, k, path)
        if seen != set(_build.KERNELS):
            raise AssertionError(f"kernels with no main-path inputs kept: {set(_build.KERNELS) - seen}")
        del kept, rowdp
        phase_two_devices(torch)
        kernels = kernel_line(res, counts, ptxas)

    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    if not one_phase:
        print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
