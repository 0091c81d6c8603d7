"""Entry of the read-mapping mixes (`locate`): the locator's `map_reads`, one call at a time.

Set-up: the store is generated (reference/store.py: the configuration's
reads in the order of the run's seed); its genome stands in for the
finished contig. Each call maps `reads_per_call`
reads, drawn in turn from the store, onto it with the cell's screening
kernel at `ratio`, under the configuration's first seed pattern; one call
warms up. The window ends with the first call that ends after `seconds`.

The check: `check_reads` reads drawn from the seed among all the window's
calls, each mapped by the plain locator (reference/locate.py); their rows
(or their absence) must equal the program's.
"""

from __future__ import annotations

import time

import numpy as np

from ..harness import STEP, WINDOW, Trace, read_trace
from ..reference import locate as ref_locate
from .rounds import Launches


def run(r) -> dict:
    torch = r.torch
    from pacbioassembly_tpu_torch.align import bitwave
    from pacbioassembly_tpu_torch.assemble import gather
    from pacbioassembly_tpu_torch.tools import locate
    from ..reference import store as gen

    conf, mix = r.config, r.mix
    data = gen.generate(conf["store"], r.seed, r.dev)
    if r.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(r.dev)
    codes, offs, lens = data["codes"], data["offsets"], data["lengths"]
    seqs = [codes[o: o + n] for o, n in zip(offs.tolist(), lens.tolist())]
    contig = data["genome"]
    pattern = r.patterns[0]
    per = mix["reads_per_call"]
    blocks = len(seqs) // per

    def call(k):
        part = seqs[(k % blocks) * per: (k % blocks + 1) * per]
        return part, locate.map_reads(contig, pattern, part, mix["ratio"], device=r.dev,
                                      screen_kernel=conf["screen_kernel"])

    call(0)  # warm-up
    launches = Launches(bitwave, gather) if r.trace else None
    if launches:
        launches.install()
    done = []
    setup_s = r.clock()
    r.open_window()
    try:
        with Trace(torch, r.trace) as tr:
            with tr.span(WINDOW):
                t0 = time.perf_counter()
                k = 1
                while True:
                    with tr.span(STEP):
                        part, (rows, nproc) = call(k)
                    te = time.perf_counter()
                    done.append((part, rows, nproc))
                    k += 1
                    if te - t0 >= r.seconds:
                        break
                window_s = time.perf_counter() - t0
        r.close_window()
    finally:
        if launches:
            launches.remove()
    processed = sum(n for _, _, n in done)
    r.log(f"window: {len(done)} calls in {window_s:.3f} s, {processed} reads processed, "
          f"{sum(len(x) for _, x, _ in done)} rows")

    t1 = time.perf_counter()
    rng = np.random.default_rng(r.seed % (1 << 63))
    picks = rng.choice(len(done) * per, min(mix["check_reads"], len(done) * per), replace=False)
    index = ref_locate.contig_index(contig, pattern)
    got, reads = [], []
    for p in sorted(picks.tolist()):
        part, rows, _ = done[p // per]
        big = [s for s in part if len(s) >= ref_locate.MIN_READ]
        q = p % per
        if len(part[q]) < ref_locate.MIN_READ:
            continue
        nseq = sum(1 for s in part[:q] if len(s) >= ref_locate.MIN_READ)
        row = next((x[1:] for x in rows if x[0] == nseq), None)
        got.append(None if row is None else tuple(int(v) for v in row))
        reads.append(big[nseq])
    want = ref_locate.rows_for(contig, index, pattern, reads, mix["ratio"], r.dev)
    bad = sum(int(g != w) for g, w in zip(got, want))
    r.log(f"check: {len(reads)} reads ({sum(w is not None for w in want)} mapped by the "
          f"reference) in {time.perf_counter() - t1:.1f} s")
    trace = read_trace(tr.events, lambda host, t: "map_reads" if any(
        a <= t <= b for a, b, _ in host) else "between calls") if r.trace else None
    return {
        "setup_s": setup_s,
        "attempted": len(done), "failed": 0,
        "end_to_end": {"mapped_reads_per_s": processed / window_s},
        "readings": {"trace": trace, "least_s": launches.least_seconds() if launches else {}},
        "checks": {"rows_diff": {"value": bad, "limit": 0},
                   "reads_unchecked": {"value": int(not reads), "limit": 0}},
    }
