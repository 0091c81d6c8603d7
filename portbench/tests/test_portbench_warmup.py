"""The warm-up of the round entry: its gate, and the stop where it is not met.

The warm-up waits until every launch counter of KERNELS[device] has
launched, the engine is on contig `window_contig` and that contig is
`warm_contig_len` long. One that has not met its gate after WARMUP_MAX
rounds ends the run with no result and names what it lacks. On the tiny
CPU store the plain K2 and walk (`plain_parents`, `plain_walk`) launch
together, in the first round that commits a read through the device
traceback: round 1 with the published engine seed 7, round 7 with 11.
"""

from __future__ import annotations

import io
from contextlib import redirect_stdout

import pytest

from conftest import run, run_cell, tiny
from portbench.entries import rounds

CLR = "ecoli_clr15.grow"
# the checks of a grow cell without the two-thread commit
GROW_CHECKS = {"start_diff", "accepted_diff", "candidates_diff", "screen_diff", "votes_diff",
               "contig_diff", "reads_diff", "counters_diff", "checkpoint_diff",
               "rounds_unchecked"}


def test_warm_unmet_names_each_condition():
    mix = {"warm_contig_len": 40_000}
    launches = dict.fromkeys(rounds.KERNELS["cuda"], 1)
    assert rounds.warm_unmet(launches, "cuda", 0, 40_000, mix) == []
    launches["bitwave_prefilter"] = 0
    got = rounds.warm_unmet(launches, "cuda", 0, 39_999, dict(mix, window_contig=1))
    assert got == ["counters still at 0: ['bitwave_prefilter']", "on contig 0, window_contig 1",
                   "contig 0 is 39999 bp, warm_contig_len 40000"]
    launches["bitwave_prefilter"] = 1
    assert rounds.warm_unmet(launches, "cuda", 1, 40_000, dict(mix, window_contig=1)) == []


@pytest.mark.parametrize("cell,warm", [
    (CLR, "contig 0 at round 1, 3152 bp"),
    ("ecoli_3pct.grow", "contig 0 at round 1, 3348 bp"),
])
def test_warm_up_opens_the_window_where_it_did(capsys, cell, warm):
    """The round and length where the tiny cells' windows opened before the
    warm-up could stop, with the same checks."""
    conf, mix = tiny(cell)
    rc, res = run_cell(cell, 2**31 + 11, 1.0, config=conf, mix=mix)
    assert rc == 0 and res["correct"], res["checks"]
    assert set(res["checks"]) == GROW_CHECKS
    assert f"warm-up: {warm}, launches " in capsys.readouterr().err


def test_an_unmet_warm_up_stops_the_run(capsys, monkeypatch):
    """WARMUP_MAX cut to one round, an engine seed whose first walk comes in
    round 7, a contig that is never reached and a length never grown: the
    run exits 1, prints no result and names each of the three."""
    monkeypatch.setattr(rounds, "WARMUP_MAX", 1)
    conf, mix = tiny(CLR)
    conf["engine"]["rng_seed"] = 11
    mix.update(window_contig=1, warm_contig_len=10**9)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", CLR, "--seed", str(2**31 + 11), "--seconds", "1.0",
                       "--trace", "0"], device="cpu", config=conf, mix=mix)
    assert rc == 1 and out.getvalue() == ""
    err = capsys.readouterr().err
    assert "the warm-up did not meet its gate in 1 rounds (contig 0 at round 1)" in err
    assert "counters still at 0: ['plain_parents', 'plain_walk']" in err
    assert "on contig 0, window_contig 1" in err
    assert "warm_contig_len 1000000000" in err
    assert "window:" not in err
