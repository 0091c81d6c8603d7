"""Port: the locator from the command line. `python -m
pacbioassembly_tpu_torch locate genome 1111111111111111 --device cpu`
(batched screening through the row-DP kernel's wrapper, here its plain
version) and `--host-loop` (the sequential exact-aligner loop) both print
the reference locator's golden TSV, on the stdin and genome of
tests/test_pipeline.py::test_locator_parity."""

import io
import os

import pytest
import torch

from pacbioassembly_tpu_torch import _build
from pacbioassembly_tpu_torch.tools.cli import main

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


def data(name):
    return os.path.join(DATA, name)


@pytest.mark.parametrize("mode", ["batched", "host-loop"])
def test_port_locator_matches_golden(capsys, monkeypatch, mode):
    monkeypatch.setattr("sys.stdin", io.StringIO(open(data("synth_reads.txt")).read()))
    monkeypatch.setenv("PBTPU_SCREEN_BACKEND", "pallas")
    argv = ["locate", data("synth_genome.txt"), "1111111111111111", "--device", "cpu"]
    if mode == "host-loop":
        argv.append("--host-loop")
    _build.reset_counts()
    assert main(argv) == 0
    captured = capsys.readouterr()
    assert captured.out == open(data("golden_locator.txt")).read()
    assert captured.err.strip().endswith("totally 80 sequences processed")
    # the batched mode screened on the plain row DP (no kernel on a CPU)
    plain = _build.LAUNCHES["plain_batch_score"]
    assert (plain > 0) == (mode == "batched")
    assert all(_build.LAUNCHES[k] == 0 for k in _build.KERNELS)
