"""The batch engine's branches off its main path, on tests/data/synth2_*
with the quirks of tests/test_pipeline_variants.py (the `-f` file's newline
kept as a base, the seed-at quirk), one pattern, round-robin:

  locked          `-l`: the reference frozen, every alignment through the
                  host try_align, 5 rounds;
  dump            `-d`: ratio 0.25, 16 trials, each committed alignment's
                  (reference, read) pair written, 10 rounds;
  host_traceback  `device_traceback=False`: every commit on the host, 10
                  rounds.

No JAX here: tests/test_torch_gpu.py uses it too."""

from __future__ import annotations

import io
import os

DATA = os.path.join(os.path.dirname(__file__), "data")
READS = os.path.join(DATA, "synth2_reads.bin")
INIT = os.path.join(DATA, "synth2_init.txt")
PATTERNS = os.path.join(DATA, "oneseed_full.txt")
GOLDEN_LOCKED = os.path.join(DATA, "golden_consensus_locked.txt")

BASE = dict(engine="batch", initial_ref_path=INIT, pattern_schedule="roundrobin",
            quirk_init_newline=True, quirk_seed_at=True)
CASES = {
    "locked": dict(locked=True, max_round=5),
    "dump": dict(ratio=0.25, max_trial=16, dump_path="-", max_round=10),
    "host_traceback": dict(device_traceback=False, max_round=10),
}


def settings(case: str, **kw) -> dict:
    return dict(BASE, **CASES[case], **kw)


def port_run(case: str, device="cpu", mesh=None, **kw) -> dict:
    """The port's BatchAssembler on `case`: dict(engine, out, dump, votes0
    (sel, sup, total before the run), commits (each round's
    commit_phase_s), dump_sites (the function that wrote each dump line))."""
    from pacbioassembly_tpu_torch.assemble import ReadStore
    from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler
    from pacbioassembly_tpu_torch.codec import dna
    from pacbioassembly_tpu_torch.config import AssemblyConfig

    cfg = AssemblyConfig(**settings(case, **kw))
    dump = SiteDump() if cfg.dump_path else None
    asm = BatchAssembler(cfg, ReadStore.from_file(READS, cfg), dna.load_patterns(PATTERNS),
                         dump=dump, device=device, mesh=mesh)
    votes0 = tuple(getattr(asm.ref, f).copy() for f in ("sel", "sup", "total"))
    commits = []
    real_round = asm.run_round

    def run_round(log=None):
        stats = real_round(log=log)
        commits.append(dict(asm.commit_phase_s))
        return stats

    asm.run_round = run_round
    out = io.StringIO()
    asm.run(out=out)
    del asm.run_round
    return dict(engine=asm, out=out.getvalue(), dump=dump.getvalue() if dump else "",
                votes0=votes0, commits=commits, dump_sites=dump.sites if dump else [])


class SiteDump(io.StringIO):
    """A dump stream that notes the name of the function behind each write:
    `commit` (the device-commit path) or `run` (the host try_align path)."""

    def __init__(self):
        super().__init__()
        self.sites: list[str] = []

    def write(self, s):
        import sys

        self.sites.append(sys._getframe(1).f_code.co_name)
        return super().write(s)


def golden_match(golden: str, out: str) -> bool:
    """tests/test_pipeline_variants.py's rule: the reference keeps the `-f`
    file's raw newline as a base where the engines print 'T'."""
    return len(golden) == len(out) and all(
        g == m or (g == "\n" and m == "T") for g, m in zip(golden, out))
