#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pacbioassembly_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ with nvcc at first use, then:

  1. device: the card's name and power limit (nvidia-smi), the build time;
  2. kernels vs plain versions on the card, exact equality, on simulated
     overlaps at 3% and 15% error plus random non-overlaps: K1
     (bitwave.cu) at the prefilter geometry (B=4096, LB=128, W=58, R=0.45)
     and at the 2048, 4096 and 8192 full-screen buckets (B=1024, R=0.3);
     K2 (tbwave.cu) and W (walk.cu) at Bp=32 in the same three buckets; a
     256-pair sample against the native host aligner;
  3. the main path at E. coli scale: 4.6 Mb at 30x, reads of mean 2,500,
     3% uniform error, seed 11; BatchAssembler on cuda, rng_seed 7,
     round-robin over tests/data/seeds.txt, 60 rounds (more if no round
     has yet reached the prefilter's candidate threshold); every kernel's
     launch counter must be > 0 and every plain counter 0. The inputs of
     the run's first launches of every kernel variant are kept;
  4. every kernel variant the main path launched, held against its plain
     version on those kept inputs at the main path's own shapes;
  5. the device view: 10 more rounds under torch.profiler (the engine's
     profile_dir), the card's busy share and device time by kernel;
  6. the same port on cuda and on cpu, 8 rounds of a 60 kb genome: equal
     contig bytes, votes and surviving reads.

Kernel times are CUDA events: a kernel's is the min over fresh inputs, a
plain version's is its one checked run (each plain version runs once on
a tiny batch first, so that PyTorch's lazy kernel loading stays out of
the timed runs). Prints one JSON line of kernel
results, the nvidia-smi line, and last `{"ok": true, "device": {...}}`.
Any failure exits non-zero before that. Needs no network and imports no
JAX; the shared host layers come through pacbioassembly_tpu_torch.host.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEEDS = os.path.join(REPO, "tests", "data", "seeds.txt")
BUCKETS = (2048, 4096, 8192)  # full-screen buckets the E. coli slice launches at
PROFILED_ROUNDS = 10


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed(torch, fn, x):
    """(card ms, result) of fn(x), by CUDA events."""
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
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
    from pacbioassembly_tpu_torch.host import SimConfig, mutate_read

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


class Results:
    """Per kernel: the largest error seen and the timed shapes."""

    def __init__(self):
        self.err: dict[str, int] = {}
        self.rows: list[dict] = []

    def add(self, kernel, where, shape, err, ms, plain_ms):
        if err != 0:
            raise AssertionError(f"{kernel} ({where}, {shape}): kernel != plain (max abs err {err})")
        self.err[kernel] = max(self.err.get(kernel, 0), err)
        self.rows.append(dict(kernel=kernel, where=where, shape=shape, ms=ms, plain_ms=plain_ms))
        log(f"[kernels:{where}] {kernel} {shape}: equal; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")


def _kernel_ms(torch, fn, items):
    """Min card time of the kernel over the fresh inputs that share the
    first input's static arguments (the first itself when none does)."""
    same = [x for x in items[1:] if x[1] == items[0][1]] or items[:1]
    return min(timed(torch, lambda x: fn(*x[0], **x[1]), x)[0] for x in same)


def check_score(torch, res, kind, items, where, shape):
    """K1 against the plain row DP: exact on the first of `items`, a list
    of (args, kwargs); returns the plain scores."""
    from pacbioassembly_tpu_torch.align import scan
    from pacbioassembly_tpu_torch.align.bitwave import batch_score_bitwave

    args, kw = items[0]
    k = batch_score_bitwave(*args, kind=kind, **kw)
    plain_ms, p = timed(torch, lambda x: scan.batch_score(*x, **kw), args)
    ms = _kernel_ms(torch, lambda *a, **k_: batch_score_bitwave(*a, kind=kind, **k_), items)
    res.add(f"bitwave_{kind}", where, shape, max_err(torch, k, p), ms, plain_ms)
    return p


def check_parents(torch, res, items, where, shape):
    """K2 against the plain parents DP (plane, md, len_b)."""
    from pacbioassembly_tpu_torch.align import tbwave

    args, kw = items[0]
    k = tbwave.batch_parents(*args, **kw)
    plain_ms, p = timed(torch, lambda x: tbwave.batch_parents_plain(*x, **kw), args)
    ms = _kernel_ms(torch, tbwave.batch_parents, items)
    res.add("tbwave", where, shape, max_err(torch, k, p), ms, plain_ms)


def check_walk(torch, res, items, where, shape):
    """W against the plain walk on the same planes and goal cells."""
    from pacbioassembly_tpu_torch.align import tbwave

    args, kw = items[0]
    k = tbwave.walk_parents(*args, **kw)
    plain_ms, p = timed(torch, lambda y: tbwave.walk_parents_plain(*y, **kw), args)
    ms = _kernel_ms(torch, tbwave.walk_parents, items)
    res.add("walk", where, shape, max_err(torch, k, p), ms, plain_ms)


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
    from pacbioassembly_tpu_torch.align.screen import size_bucket
    from pacbioassembly_tpu_torch.host import exact_align, pbcore

    warm_plain(torch, dev)
    rng = np.random.default_rng(2024)

    def up(batch):
        return tuple(torch.from_numpy(x).to(dev) for x in batch)

    geoms = [("prefilter", 4096, 128, 0.45)] + [("fullscreen", 1024, c, 0.3) for c in BUCKETS]
    for kind, B, LB, ratio in geoms:
        if kind == "prefilter":
            W = 1 + int(LB * ratio)
            LA = LB + W + 1
        else:
            LB, LA, W = size_bucket(LB, ratio)
        batches = [up(make_pairs(rng, B, LB, LA)) for _ in range(4)]
        kw = dict(la_max=LA, w_max=W, ratio=ratio)
        shape = f"B={B} LA={LA} LB={LB} W={W} R={ratio}"
        p = check_score(torch, res, kind, [(x, kw) for x in batches], "synthetic", shape)
        n_acc = int(p.accept.sum())
        failed = int(((~p.accept) & (p.dp_rows > 10) & (p.dp_rows < LB // 2)).sum())
        if not (0 < n_acc < B and failed > 0):
            raise AssertionError(f"{shape}: degenerate inputs ({n_acc} of {B} accepted, "
                                 f"{failed} early-failed)")
        log(f"[kernels:synthetic] ... {n_acc} accepted, {failed} early-failed")
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


class MainPathInputs:
    """Keeps the inputs of the main path's first launches of every kernel
    variant, so that each variant can be held against its plain version
    at the slice's own shapes. A variant is one kernel at one static
    geometry: K1 by launch kind and (LA, LB, W, R), K2 by (LA, W), W by W.
    Installs thin wrappers over the names assemble/gather.py calls; each
    wrapper copies its inputs and calls the real kernel wrapper."""

    KEEP = 3  # launches kept per variant and batch size

    def __init__(self, gather):
        self.gather = gather
        self.calls: dict = {}   # (kernel, geometry) -> {B: launches}
        self.inputs: dict = {}  # (kernel, geometry, B) -> [(args, kw), ...]
        self.real = (gather.batch_score_bitwave, gather.batch_parents, gather.walk_parents)

    def _keep(self, kernel, geom, args, kw):
        B = int(args[0].shape[0])
        per_b = self.calls.setdefault((kernel, geom), {})
        per_b[B] = per_b.get(B, 0) + 1
        kept = self.inputs.setdefault((kernel, geom, B), [])
        if len(kept) < self.KEEP:
            kept.append((tuple(x.clone() for x in args), dict(kw)))

    def install(self):
        score, parents, walk = self.real

        def score_kept(a, la, b, lb, **kw):
            geom = (kw["la_max"], b.shape[1], kw["w_max"], kw["ratio"])
            self._keep(f"bitwave_{kw['kind']}", geom, (a, la, b, lb), kw)
            return score(a, la, b, lb, **kw)

        def parents_kept(a, la, b, lb, **kw):
            self._keep("tbwave", (kw["la_max"], kw["w_max"]), (a, la, b, lb), kw)
            return parents(a, la, b, lb, **kw)

        def walk_kept(*args, **kw):
            self._keep("walk", (kw["w_max"],), args, kw)
            return walk(*args, **kw)

        g = self.gather
        g.batch_score_bitwave, g.batch_parents, g.walk_parents = score_kept, parents_kept, walk_kept

    def remove(self):
        g = self.gather
        g.batch_score_bitwave, g.batch_parents, g.walk_parents = self.real

    def variants(self):
        """(kernel, geometry, launches, modal B, kept inputs at that B)."""
        for (kernel, geom), per_b in sorted(self.calls.items(), key=lambda kv: str(kv[0])):
            B = max(per_b, key=lambda b: (per_b[b], b))
            yield kernel, geom, sum(per_b.values()), B, self.inputs[(kernel, geom, B)]


def phase_main_path_kernels(torch, res, kept: MainPathInputs):
    """Every kernel variant the slice launched, against its plain version
    on the slice's own inputs (its most frequent batch size)."""
    seen = set()
    for kernel, geom, n, B, items in kept.variants():
        kw = items[0][1]
        if kernel.startswith("bitwave"):
            LA, LB, W, R = geom
            items = [(a, {k: v for k, v in w.items() if k != "kind"}) for a, w in items]
            check_score(torch, res, kw["kind"], items, "main-path",
                        f"B={B} LA={LA} LB={LB} W={W} R={R}")
        elif kernel == "tbwave":
            check_parents(torch, res, items, "main-path",
                          f"Bp={B} LA={geom[0]} W={geom[1]} rows={kw['rows_max']}")
        else:
            check_walk(torch, res, items, "main-path", f"Bp={B} W={geom[0]} E={kw['e_max']}")
        res.rows[-1].update(launches=n)
        log(f"[kernels:main-path] ... the slice launched this variant {n} times")
        seen.add(kernel)
    from pacbioassembly_tpu_torch import _build

    if seen != set(_build.KERNELS):
        raise AssertionError(f"kernels with no main-path inputs kept: {set(_build.KERNELS) - seen}")


def simulate_store(genome_len, coverage, mean_read_len, error, seed, max_read_len=19_000):
    from pacbioassembly_tpu_torch.host import ReadStore, SimConfig, binary_io, simulate

    sim = SimConfig(
        genome_len=genome_len, coverage=coverage, mean_read_len=mean_read_len,
        max_read_len=max_read_len, sub_rate=error / 3, ins_rate=error / 3,
        del_rate=error / 3, seed=seed,
    )
    genome, reads, _ = simulate(sim)
    buf = io.BytesIO()
    binary_io.write_records(buf, reads)
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
            m = re.search(r"(bitwave_kernel<\d+>|tbwave_kernel|walk_kernel)", e.get("name", ""))
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


def phase_slice(torch, dev, genome_len=4_600_000, max_round=60):
    from pacbioassembly_tpu_torch import _build
    from pacbioassembly_tpu_torch.assemble import gather
    from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler
    from pacbioassembly_tpu_torch.host import AssemblyConfig, dna

    t0 = time.perf_counter()
    genome, reads = simulate_store(genome_len, 30.0, 2500, 0.03, 11)
    log(f"[slice] simulated {genome_len / 1e6:.1f} Mb @ 30x: {len(reads)} reads in {time.perf_counter() - t0:.1f} s")
    patterns = dna.load_patterns(SEEDS)
    kept = MainPathInputs(gather)
    with tempfile.TemporaryDirectory() as tmp:
        metrics = os.path.join(tmp, "metrics.jsonl")
        cfg = AssemblyConfig(
            engine="batch", rng_seed=7, pattern_schedule="roundrobin", max_round=max_round,
            max_seq_len=len(genome) + 500_000, metrics_path=metrics,
        )
        t0 = time.perf_counter()
        asm = BatchAssembler(cfg, reads, patterns, device=dev)
        init_len = asm.ref.length()
        builder = asm._builder()
        if builder is None:
            raise AssertionError("read matrix does not fit the device matrix cap")
        torch.cuda.synchronize()
        log(f"[slice] set-up {time.perf_counter() - t0:.1f} s (device read matrix "
            f"{builder.reads_mat.numel() / 1e9:.2f} GB)")
        kept.install()
        try:
            _build.reset_counts()
            t0 = time.perf_counter()
            asm.run(out=None)
            while max(s.ntrials for s in asm.history) < cfg.prefilter_min_batch and asm.nround < 200:
                log(f"[slice] no round reached {cfg.prefilter_min_batch} candidates by round "
                    f"{asm.nround}: raising the round cap by 20")
                asm.cfg = dataclasses.replace(asm.cfg, max_round=asm.nround + 20)
                asm.run(out=None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(_build.LAUNCHES)
        finally:
            kept.remove()
        with open(metrics) as fh:
            rounds = [json.loads(line) for line in fh]
        rounds = [r for r in rounds if r["event"] == "round"]

        if any(counts[k] == 0 for k in _build.KERNELS):
            raise AssertionError(f"a kernel of the main path never launched: {counts}")
        if any(counts[k] != 0 for k in _build.PLAIN):
            raise AssertionError(f"a plain version ran on the main path: {counts}")
        consumed = len(reads) - len(asm.surviving)
        if consumed <= 0 or asm.ref.length() <= init_len:
            raise AssertionError("the slice consumed no reads or the contig did not grow")
        share = kmer_share(asm.ref.text(), genome)
        if share < 0.5:
            raise AssertionError(f"only {share:.2f} of the contig's 16-mers are in the genome")
        rs = np.array([r["round_s"] for r in rounds])
        cands = [s.ntrials for s in asm.history]
        log(f"[slice] {asm.nround} rounds in {wall:.1f} s: {consumed} of {len(reads)} reads "
            f"consumed, contig {init_len} -> {asm.ref.length()} bp ({share:.3f} of its 16-mers "
            f"in the genome), candidates/round max {max(cands)} median {int(np.median(cands))}, "
            f"s/round p50 {np.percentile(rs, 50):.4f} p95 {np.percentile(rs, 95):.4f}")
        log(f"[slice] launches {counts}")
        phases = ("seedmap_s", "expand_s", "screen_s", "commit_s", "evolve_s",
                  "prefilter_s", "fullscreen_s", "tb_s", "host_commit_s", "elect_s")
        half = rounds[len(rounds) // 2:]
        log("[slice] second-half mean s/round by phase: " + ", ".join(
            f"{k} {np.mean([r.get(k, 0.0) for r in half]):.4f}" for k in phases))

        # device view: the next rounds under the engine's own profiler option
        first = asm.nround + 1
        trace_dir = os.path.join(tmp, "trace")
        asm.cfg = dataclasses.replace(asm.cfg, max_round=asm.nround + PROFILED_ROUNDS,
                                      profile_dir=trace_dir, metrics_path=None)
        t0 = time.perf_counter()
        asm.run(out=None)
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
        view = device_view(os.path.join(trace_dir, "trace.json"))
        log(f"[device-view] rounds {first}-{asm.nround} under torch.profiler "
            f"({wall_p:.3f} s on the host clock with the trace export): {view}")
    return counts, kept


def phase_two_devices(torch):
    from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler
    from pacbioassembly_tpu_torch.host import AssemblyConfig, dna

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
    if gout != cout or g.history != c.history or g.surviving != c.surviving:
        raise AssertionError("cuda and cpu runs differ")
    for f in ("sel", "sup", "total"):
        if not np.array_equal(getattr(g.ref, f)[g.ref.beg : g.ref.end],
                              getattr(c.ref, f)[c.ref.beg : c.ref.end]):
            raise AssertionError(f"cuda and cpu {f} differ")
    log("[two-devices] contig bytes, sel/sup/total and surviving reads equal")


REPLACES = {
    "bitwave_prefilter": ("pacbioassembly_tpu_torch/csrc/bitwave.cu",
                          "pacbioassembly_tpu/align/bitwave.py:148"),
    "bitwave_fullscreen": ("pacbioassembly_tpu_torch/csrc/bitwave.cu",
                           "pacbioassembly_tpu/align/bitwave.py:148"),
    "tbwave": ("pacbioassembly_tpu_torch/csrc/tbwave.cu",
               "pacbioassembly_tpu/align/tbwave.py:58"),
    "walk": ("pacbioassembly_tpu_torch/csrc/walk.cu",
             "pacbioassembly_tpu/align/tbwave.py:254"),
}


def kernel_line(res: Results, counts) -> list[dict]:
    """One entry per kernel counter; ms and plain_ms at the main path's
    variant with the most launches."""
    out = []
    for k, (src, repl) in REPLACES.items():
        main = [r for r in res.rows if r["kernel"] == k and r["where"] == "main-path"]
        top = max(main, key=lambda r: r["launches"])
        out.append({
            "name": k, "route": "cuda", "source": src, "replaces": repl,
            "launches": counts[k], "max_abs_err": res.err[k],
            "ms": top["ms"], "plain_ms": top["plain_ms"], "shape": top["shape"],
        })
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from pacbioassembly_tpu_torch import _build

    t_all = time.perf_counter()
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {name}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    built = _build.build_seconds
    log(f"[device] kernels ready in {time.perf_counter() - t0:.1f} s "
        f"({'built' if built is not None else 'cached'}: nvcc {built or 0:.1f} s)")

    res = Results()
    phase_kernels(torch, dev, res)
    counts, kept = phase_slice(torch, dev)
    phase_main_path_kernels(torch, res, kept)
    del kept
    phase_two_devices(torch)

    kernels = kernel_line(res, counts)
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
