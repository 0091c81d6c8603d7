"""The control at each cell's own size on the card: it must come out not correct.

The control is the timed path with every screening launch of the
measured window scored on the first 128 bases of its b side
(run.py::install_control, installed as the window opens, so that the
window starts from the state and at the sizes of a sound run), the shortcut the
prefilter's window would tempt: it breaks the configurations' guarantee
that a read is committed (or a row reported) only where its whole
alignment holds at the ratio. Each case runs the cell as the benchmark
does, with the manifest's own window (`run_seconds`), so that only rounds
and calls of the window are compared, and prints the numbers compared;
the upper readings of PERF.md's limits come from these. Marked `gpu`;
skips without a card.

    python -m pytest portbench/tests/test_portbench_control.py -m gpu -s -p no:cacheprovider
"""

from __future__ import annotations

import json

import pytest

from conftest import harness, run_cell

pytestmark = pytest.mark.gpu
SEEDS = (3_000_000_001, 3_000_000_002, 3_000_000_003)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["ecoli_clr15.grow", "ecoli_3pct.grow", "ecoli_3pct.locate"])
def test_control_is_not_correct(cell, seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seconds = float(harness.manifest()["run_seconds"])
    rc, res = run_cell(cell, seed, seconds, device=None, control=True)
    assert rc == 0 and res is not None
    print("control", cell, seed, json.dumps({k: c["value"] for k, c in res["checks"].items()}))
    assert not res["correct"]
