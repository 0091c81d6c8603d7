"""Entry of the round-loop mixes (`grow`): the engine's own rounds, timed whole.

Set-up: the store is generated (reference/store.py: the configuration's
reads in the order of the run's seed, those within `fixed_span` of the
engine's first read held in place, so that every seed assembles the same
region in the same commit order) and handed to the program as binary records; the engine is built with its
trial-seed cache and device read matrix, then warmed up by its first
rounds, until every kernel the window uses has launched, the engine is on
contig `window_contig` (default 0) and that contig is `warm_contig_len`
long (twice the seed index's window: the steady round, where the whole
genome spends nearly all its rounds). A warm-up that has not met its
gate after WARMUP_MAX rounds stops the run (exit 1), naming what it
lacks. The window runs
rounds through the engine's public `run` (max_round one past the current
round: the round and its stall recovery), the checkpoint of the published
cadence saved by the entry every `checkpoint_every` rounds into TMPDIR and
timed with its round; when a contig ends, the next starts as
`assemble_contigs` starts it (the survivors, the shared trial-seed cache
and device read matrix, rng_seed + contig number). The window ends with the
first round that ends after `seconds`.

The check, all of it on rounds of the window: the start of contig 0
against the reference's own start; every pair that the screen accepted in
every window round, scored again by the plain DP from the round-start
consensus (reference/engine.py::audit_accepts); `check.rounds` rounds
drawn across the window, one in each of as many equal parts of its first
`check.span` share of `seconds` (the first round to start after a time
drawn from the seed in that part), each replayed by the reference from
the program's state before it, stage by stage; and the last checkpoint read
back from its file and loaded by the engine, against the state it saved.
With `parallel_commit` (the engine's two-thread host commit), the window
has to hold a round that took the split, and each replayed round has to
take it where the reference's guard does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

import numpy as np

from ..harness import CHECKPOINT, STEP, WINDOW, Stop, Trace, host_phase, read_trace
from ..reference import bound, engine as ref_engine

PHASES = ("seedmap_s", "expand_s", "screen_s", "commit_s", "evolve_s")
# launch counters the warm-up waits for: the kernels on the card, their plain versions on the CPU
KERNELS = {"cuda": ("bitwave_prefilter", "bitwave_fullscreen", "tbwave", "walk"),
           "cpu": ("plain_batch_score", "plain_parents", "plain_walk")}
WARMUP_MAX = 400  # rounds


def warm_unmet(launches: dict, device: str, contig: int, length: int, mix: dict) -> list[str]:
    """The warm-up's gate: what it still lacks (empty once it is met)."""
    out = []
    cold = [k for k in KERNELS[device] if not launches[k]]
    if cold:
        out.append(f"counters still at 0: {cold}")
    if contig < mix.get("window_contig", 0):
        out.append(f"on contig {contig}, window_contig {mix['window_contig']}")
    if length < mix["warm_contig_len"]:
        out.append(f"contig {contig} is {length} bp, warm_contig_len {mix['warm_contig_len']}")
    return out


def snapshot(asm) -> dict:
    st = asm.ref.state_dict()
    return {
        "state": {k: st[k] for k in ("codes", "sel", "sup", "total", "beg", "end")},
        "surviving": list(asm.surviving), "nround": asm.nround, "nfailure": asm.nfailure,
        "retreats": asm.retreats, "fruitless_retreats": asm.fruitless_retreats,
        "matches_since_retreat": asm.matches_since_retreat, "rng": asm.rng.bit_generator.state,
    }


def state_diff(a: dict, b: dict) -> int:
    """Cells that differ between two consensus states (a length or window
    difference counts the longer side's cells)."""
    if len(a["codes"]) != len(b["codes"]) or (a["beg"], a["end"]) != (b["beg"], b["end"]):
        return max(len(a["codes"]), len(b["codes"]), 1)
    bad = a["codes"] != b["codes"]
    bad |= a["total"] != b["total"]
    bad |= (a["sel"] != b["sel"]).any(axis=1) | (a["sup"] != b["sup"]).any(axis=1)
    return int(bad.sum())


class Capture:
    """Thin wrappers over the round's stages: on a captured round they keep
    what each stage produced (the candidates, the screen's decisions and
    the goal cells the commit reads, the consensus after the commit)."""

    def __init__(self, batch):
        self.batch, self.on, self.got = batch, False, {}
        self.accepted = None  # a list: every round's accepted pairs are kept
        cls = batch.BatchAssembler
        self.real = (batch.expand_candidates, cls.screen, cls.commit)

    def install(self):
        expand, screen, commit = self.real
        cap = self

        def expand_kept(*a, **k):
            out = expand(*a, **k)
            if cap.on:
                c = out[0]
                cap.got["cands"] = {f: np.array(getattr(c, f)) for f in
                                    ("read", "j", "forward", "r_offset", "rank")}
            return out

        def screen_kept(asm, cands):
            acc = screen(asm, cands)
            if cap.accepted is not None:
                idx = np.nonzero(acc)[0]
                ref, surv, rows = asm.ref, asm.surviving, np.asarray(cands.read)[idx]
                cap.accepted.append({
                    "codes": ref.buf[ref.pre:ref.post].copy(), "beg": ref.beg - ref.pre,
                    "read": np.array([surv[i] for i in rows.tolist()], np.int64),
                    "j": np.array(cands.j)[idx], "forward": np.array(cands.forward)[idx],
                    "r_offset": np.array(cands.r_offset)[idx],
                    "ma": asm._scr_ma[idx].copy(), "mb": asm._scr_mb[idx].copy()})
            if cap.on:
                cap.got.update(accept=acc.copy(), prefilter_kept=asm.prefilter_kept,
                               ma=np.array(asm._scr_ma), mb=np.array(asm._scr_mb))
            return acc

        def commit_kept(asm, cands, accept):
            n = commit(asm, cands, accept)
            if cap.on:
                st = asm.ref.state_dict()
                cap.got["committed"] = {k: st[k] for k in ("codes", "sel", "sup", "total", "beg", "end")}
            return n

        self.batch.expand_candidates = expand_kept
        self.batch.BatchAssembler.screen = screen_kept
        self.batch.BatchAssembler.commit = commit_kept

    def remove(self):
        self.batch.expand_candidates = self.real[0]
        self.batch.BatchAssembler.screen, self.batch.BatchAssembler.commit = self.real[1:]


class Launches:
    """In a traced run: the pairs each K1 and K2 launch was given, for the
    least-work count of the roofline (reference/bound.py)."""

    def __init__(self, bitwave, gather):
        self.mods = (bitwave, gather)
        self.real = (bitwave.batch_score_bitwave, gather.batch_parents)
        self.k1, self.k2 = [], []

    def install(self):
        score, parents = self.real

        def score_kept(a, la, b, lb, **kw):
            out = score(a, la, b, lb, **kw)
            self.k1.append((la, lb, tuple(a.shape), tuple(b.shape), out.dp_rows, kw))
            return out

        def parents_kept(a, la, b, lb, **kw):
            out = parents(a, la, b, lb, **kw)
            self.k2.append((la, lb, tuple(a.shape), tuple(b.shape), tuple(out[0].shape), kw))
            return out

        self.mods[0].batch_score_bitwave = score_kept
        self.mods[1].batch_parents = parents_kept

    def remove(self):
        self.mods[0].batch_score_bitwave, self.mods[1].batch_parents = self.real

    def least_seconds(self) -> dict:
        k1 = sum(bound.least_seconds(*bound.screen_work(
            la, lb, sa, sb, rows, la_max=kw["la_max"], w_max=kw["w_max"], ratio=kw["ratio"],
            maxn=kw["maxn"], maxm=kw["maxm"])) for la, lb, sa, sb, rows, kw in self.k1)
        k2 = sum(bound.least_seconds(*bound.parents_work(
            la, lb, sa, sb, ps, la_max=kw["la_max"], w_max=kw["w_max"], ratio=kw["ratio"]))
            for la, lb, sa, sb, ps, kw in self.k2)
        return {"K1": k1 if self.k1 else None, "K2": k2 if self.k2 else None}


class Splits:
    """Counts the host commits that took the engine's two-thread split: the
    split is where the commit opens its pool of two threads
    (batch.ThreadPoolExecutor)."""

    def __init__(self, batch):
        self.batch, self.real, self.n = batch, batch.ThreadPoolExecutor, 0

    def install(self):
        splits = self

        class Counted(self.real):
            def __init__(self, *a, **k):
                splits.n += 1
                super().__init__(*a, **k)

        self.batch.ThreadPoolExecutor = Counted

    def remove(self):
        self.batch.ThreadPoolExecutor = self.real


class Engines:
    """The engine of the current contig; when a contig ends, the next starts
    on the survivors (`make(contig, surviving)`)."""

    def __init__(self, make):
        self.make, self.contig = make, 0
        self.asm = make(0, None)

    def step(self) -> bool:
        """One round and its stall recovery; False once no read is left."""
        asm = self.asm
        asm.cfg.max_round = asm.nround + 1
        asm.run()
        if asm.nfailure >= len(asm.patterns):
            self.contig += 1
            self.asm = self.make(self.contig, asm.surviving)
            return bool(self.asm.surviving)
        return True


def run(r) -> dict:
    """Drive the cell; `r` is the run (run.py::Run): torch, dev, config,
    mix, seed, seconds, trace, clock, open_window, close_window, patterns."""
    torch = r.torch
    from pacbioassembly_tpu_torch import _build
    from pacbioassembly_tpu_torch.align import bitwave
    from pacbioassembly_tpu_torch.assemble import batch, gather
    from pacbioassembly_tpu_torch.assemble.checkpoint import load_checkpoint, save_checkpoint
    from pacbioassembly_tpu_torch.assemble.reads import ReadStore
    from pacbioassembly_tpu_torch.config import AssemblyConfig
    from ..reference import store as gen

    conf, eng = r.config, r.config["engine"]
    # the engine's first read and its region stay where they are; the others move
    data = gen.generate(conf["store"], r.seed, r.dev, engine=eng, fixed_span=r.mix["fixed_span"])
    if r.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(r.dev)
    reads = ReadStore(data["records"], min_read_len=eng["min_read_len"],
                      max_read_len=eng["max_read_len"])
    patterns = r.patterns
    cfg0 = AssemblyConfig(**eng)
    every = eng["checkpoint_every"]
    cache = batch.TrialSeedCache(reads, cfg0)
    builder = gather.DeviceBatchBuilder(reads, cfg0, r.dev)

    def engine_for(ci, surviving):
        c = dataclasses.replace(cfg0, rng_seed=cfg0.rng_seed + ci)
        return batch.BatchAssembler(c, reads, patterns, surviving=surviving, trial_cache=cache,
                                    device_builder=builder, device=r.dev,
                                    screen_kernel=conf["screen_kernel"])

    eng_ = Engines(engine_for)
    start = snapshot(eng_.asm)

    cap = Capture(batch)
    splits = Splits(batch)
    records, saved, times, ck_s, phases, nmatch, split_of = [], None, [], [], [], 0, []
    tmp = tempfile.TemporaryDirectory(prefix="portbench_")  # removed at exit if not before
    ck_path = os.path.join(tmp.name, "ck.npz")

    def play(sampled, tr) -> tuple[bool, float, object]:
        """One timed round (its save included); keeps a sampled round for
        the check."""
        nonlocal saved
        asm = eng_.asm
        nr = asm.nround + 1
        pre = snapshot(asm) if sampled else None
        cap.on, cap.got = sampled, {}
        n0 = splits.n
        ts = time.perf_counter()
        with tr.span(STEP):
            left = eng_.step()
            if nr % every == 0:
                tc = time.perf_counter()
                with tr.span(CHECKPOINT):
                    save_checkpoint(ck_path, asm)
                ck_s.append(time.perf_counter() - tc)
        te = time.perf_counter()
        cap.on = False
        split_of.append(splits.n > n0)
        if nr % every == 0:
            saved = snapshot(asm)
        if sampled:
            records.append((pre, dict(cap.got, split=split_of[-1]),
                            dataclasses.asdict(asm.history[-1]), snapshot(asm)))
        return left, te - ts, asm

    # warm-up: the first rounds, until every kernel of the window has launched,
    # the engine is on contig `window_contig` and that contig has reached the
    # steady round (both ends' seed windows full)
    _build.reset_counts()
    for _ in range(WARMUP_MAX):
        play(False, Trace(torch, False))
        unmet = warm_unmet(_build.LAUNCHES, r.dev.type, eng_.contig, eng_.asm.ref.length(), r.mix)
        if not unmet:
            break
    else:
        tmp.cleanup()
        raise Stop(f"the warm-up did not meet its gate in {WARMUP_MAX} rounds (contig "
                   f"{eng_.contig} at round {eng_.asm.nround}): " + "; ".join(unmet))
    ck_s.clear()
    split_of.clear()
    r.log(f"warm-up: contig {eng_.contig} at round {eng_.asm.nround}, "
          f"{eng_.asm.ref.length()} bp, launches {dict(_build.LAUNCHES)}")

    check = r.mix["check"]
    k = check["rounds"]
    u = np.random.default_rng(r.seed % (1 << 63)).random(k)
    pending = [(i + u[i]) / k * check["span"] * r.seconds for i in range(k)]
    launches = Launches(bitwave, gather) if r.trace else None
    restarts0, retreats0 = eng_.contig, eng_.asm.retreats
    stalls, ntrials = 0, []
    cap.accepted = []
    cap.install()
    splits.install()
    if launches:
        launches.install()
    setup_s = r.clock()
    warm = dict(_build.LAUNCHES)
    r.open_window()
    try:
        with Trace(torch, r.trace) as tr:
            with tr.span(WINDOW):
                t0 = time.perf_counter()
                while True:
                    sampled = bool(pending) and time.perf_counter() - t0 >= pending[0]
                    if sampled:
                        pending.pop(0)
                    left, dt, asm = play(sampled, tr)
                    stalls += asm.history[-1].nmatches == 0
                    times.append(dt)
                    phases.append({k: asm.phase_s.get(k, 0.0) for k in
                                   PHASES + ("lookup_s", "host_commit_s")})
                    nmatch += asm.history[-1].nmatches
                    ntrials.append(asm.history[-1].ntrials)
                    if not left or time.perf_counter() - t0 >= r.seconds:
                        break
                window_s = time.perf_counter() - t0
        r.close_window()
    finally:
        cap.remove()
        splits.remove()
        if launches:
            launches.remove()
    restarts = eng_.contig - restarts0
    retreats = eng_.asm.retreats - retreats0 if restarts == 0 else "?"
    r.log(f"window: {len(times)} rounds in {window_s:.3f} s, {nmatch} reads, "
          f"{len(ck_s)} saves, {restarts} restarts, {stalls} rounds with no read, "
          f"{retreats} edge retreats, {len(records)} rounds kept for the check "
          f"({[p['nround'] + 1 for p, *_ in records]}); {sum(split_of)} of {len(times)} rounds "
          f"took the two-thread host commit; candidates a round: median "
          f"{np.median(ntrials):.0f}, max {max(ntrials)}; launches in the window "
          f"{ {k: v - warm[k] for k, v in _build.LAUNCHES.items() if v > warm[k]} }")

    checks = verify(r, data, eng, patterns, start, records, cap.accepted, saved, ck_path,
                    lambda: engine_for(0, None), load_checkpoint)
    if eng["parallel_commit"]:
        # the split the cell exists for has to have run in the window
        checks["split_rounds_missing"] = {"value": int(not any(split_of)), "limit": 0}
    cap.accepted = None
    tmp.cleanup()

    trace = read_trace(tr.events, host_phase(phases, PHASES)) if r.trace else None
    return {
        "setup_s": setup_s,
        "attempted": len(times), "failed": 0,
        "end_to_end": {
            "assembled_reads_per_s": nmatch / window_s,
            "round_s_p90": float(np.percentile(times, 90)),
        },
        "readings": {
            "phases": phases, "checkpoint_s": ck_s, "round_s": times, "trace": trace,
            "least_s": launches.least_seconds() if launches else {},
        },
        "checks": checks,
    }


def verify(r, data, eng, patterns, start, records, accepted, saved, ck_path, fresh_engine,
           load_checkpoint) -> dict:
    """The compared numbers, each with its limit (all exact: limit 0)."""
    t0 = time.perf_counter()
    reads = ref_engine.Reads(data["codes"], data["offsets"], data["lengths"],
                             eng["min_read_len"], eng["max_read_len"])
    st0, rng0 = ref_engine.initial_state(reads, eng["rng_seed"])
    diff = {k: 0 for k in ("start", "accepted", "candidates", "screen", "votes", "contig",
                           "reads", "counters", "checkpoint")}
    if eng["parallel_commit"]:
        diff["split"] = 0  # replayed rounds split by one of the program and the reference only
    diff["start"] = state_diff(start["state"], st0) + int(start["rng"] != rng0)
    seeds, valid = ref_engine.trial_seeds(reads, eng["max_trial"], eng["overlap_min"])
    r.log(f"check: trial seeds of {len(reads)} reads in {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    pairs, diff["accepted"] = ref_engine.audit_accepts(accepted, reads, eng, r.dev)
    r.log(f"check: {pairs} accepted pairs of {len(accepted)} window rounds scored again "
          f"in {time.perf_counter() - t1:.1f} s")
    for pre, got, stats, post in records:
        t1 = time.perf_counter()
        want = ref_engine.replay_round(pre, reads, seeds, valid, patterns, eng, r.dev)
        r.log(f"check: round {pre['nround'] + 1} replayed in {time.perf_counter() - t1:.1f} s "
              f"({len(want['cands']['read'])} candidates, {want['nmatches']} reads consumed, "
              f"{want['host_aligns']} host aligns, "
              f"host commit {'split' if want['split'] else 'in read order'}; "
              f"the program's {'split' if got.get('split') else 'in read order'})")
        if "split" in diff:
            diff["split"] += int(bool(got.get("split")) != want["split"])
        cw, cg = want["cands"], got.get("cands")
        if cg is None or len(cg["read"]) != len(cw["read"]):
            diff["candidates"] += max(len(cw["read"]), 1)
        else:
            bad = np.zeros(len(cw["read"]), bool)
            for f in cw:
                bad |= cg[f] != cw[f]
            diff["candidates"] += int(bad.sum())
            acc = got["accept"]
            both = acc & want["accept"]
            diff["screen"] += int((acc != want["accept"]).sum()
                                  + (got["ma"][both] != want["ma"][both]).sum()
                                  + (got["mb"][both] != want["mb"][both]).sum())
        diff["screen"] += int(got.get("prefilter_kept") != want["prefilter_kept"])
        diff["counters"] += sum(int(stats[k] != v) for k, v in (
            ("pattern", want["pattern"]), ("seedmap_size", want["n_indexed"]),
            ("dropped_candidates", want["dropped"]), ("nmatches", want["nmatches"]),
            ("ntrials", len(cw["read"]))))
        diff["votes"] += (state_diff(got["committed"], want["committed"])
                          if "committed" in got else 1)
        diff["contig"] += state_diff(post["state"], want["state"])
        diff["reads"] += len(set(post["surviving"]) ^ set(want["surviving"]))
        diff["counters"] += sum(int(post[k] != want[k]) for k in (
            "nfailure", "retreats", "fruitless_retreats", "matches_since_retreat", "rng"))
    if saved is not None:
        t1 = time.perf_counter()
        with np.load(ck_path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            on_disk = {"codes": z["codes"], "sel": z["sel"], "sup": z["sup"], "total": z["total"],
                       "beg": meta["beg"], "end": meta["end"]}
            diff["checkpoint"] += state_diff(on_disk, saved["state"])
            diff["checkpoint"] += len(set(z["surviving"].tolist()) ^ set(saved["surviving"]))
            diff["checkpoint"] += int(json.loads(str(z["rng"])) != saved["rng"])
            diff["checkpoint"] += sum(int(meta[k] != saved[k]) for k in
                                      ("nround", "nfailure", "retreats"))
        back = fresh_engine()
        load_checkpoint(ck_path, back)
        diff["checkpoint"] += state_diff(snapshot(back)["state"], saved["state"])
        diff["checkpoint"] += int(back.surviving != saved["surviving"])
        del back
        r.log(f"check: checkpoint of round {saved['nround']} read back in "
              f"{time.perf_counter() - t1:.1f} s")
    r.log(f"check: start, {len(records)} rounds replayed "
          f"({[p['nround'] + 1 for p, *_ in records]}), "
          f"checkpoint {'round ' + str(saved['nround']) if saved else 'not saved in the window'}"
          f" in {time.perf_counter() - t0:.1f} s")
    checks = {f"{k}_diff": {"value": v, "limit": 0} for k, v in diff.items()}
    # drawn window rounds that were never replayed (the window ended first)
    checks["rounds_unchecked"] = {"value": r.mix["check"]["rounds"] - len(records), "limit": 0}
    return checks
