"""The check fails a broken timed path: each fault a cell can have, and the control.

Each case runs a tiny cell on the CPU (past the harness's look for a card)
with the program broken underneath, and sees `correct` come out false:
  unchanged  a step returns its state unchanged (the commit consumes nothing;
             the locator returns no row)
  half       half of the batch left out (the screen rejects the second half
             of each round's candidates; the locator maps the first half of
             each call's reads only)
  altered    an answer altered where it is produced (a base of the contig,
             another each round, after the round; one row's cost)
  control    the truncated-screen control (run.py: every screening launch
             scored on the first 128 bases of its b side)
The exchange between chips does not exist in these one-card cells.
"""

from __future__ import annotations

import numpy as np
import pytest

from conftest import run_cell, tiny


def break_rounds(monkeypatch, fault):
    from pacbioassembly_tpu_torch.assemble import batch

    cls = batch.BatchAssembler
    if fault == "unchanged":
        commit = cls.commit
        monkeypatch.setattr(cls, "commit",
                            lambda self, cands, accept: commit(self, cands, accept & False))
    elif fault == "half":
        screen = cls.screen

        def half(self, cands):
            acc = screen(self, cands)
            acc[len(acc) // 2:] = False
            return acc

        monkeypatch.setattr(cls, "screen", half)
    elif fault == "altered":
        run_round = cls.run_round

        def altered(self, log=None):
            stats = run_round(self, log)
            # a base that moves with the round: one base flipped twice would
            # read right again
            self.ref.buf[self.ref.beg + self.nround % max(self.ref.length(), 1)] ^= 1
            return stats

        monkeypatch.setattr(cls, "run_round", altered)


def break_locate(monkeypatch, fault):
    from pacbioassembly_tpu_torch.tools import locate

    real = locate.map_reads

    def broken(contig, pattern, seqs, ratio, **kw):
        seqs = list(seqs)
        if fault == "half":
            rows, _ = real(contig, pattern, seqs[: len(seqs) // 2], ratio, **kw)
            return rows, len(seqs)
        rows, n = real(contig, pattern, seqs, ratio, **kw)
        if fault == "unchanged":
            return [], n
        return [(r[0], r[1], r[2] + 1, r[3], r[4]) if i == 0 else r
                for i, r in enumerate(rows)], n

    monkeypatch.setattr(locate, "map_reads", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "control"])
@pytest.mark.parametrize("cell", ["ecoli_clr15.grow", "ecoli_3pct.locate"])
def test_broken_path_is_not_correct(monkeypatch, cell, fault):
    conf, mix = tiny(cell)
    if fault != "control":
        (break_rounds if cell.endswith(".grow") else break_locate)(monkeypatch, fault)
    rc, res = run_cell(cell, 2**32 + 17, 1.0, config=conf, mix=mix, control=fault == "control")
    assert rc == 0 and res is not None
    assert not res["correct"]
    failed = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    print(cell, fault, {k: res["checks"][k]["value"] for k in failed})
    assert failed
    assert np.isfinite(list(res["metrics"].values())[0]["value"])
