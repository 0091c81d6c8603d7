"""Port: the command line. `python -m pacbioassembly_tpu_torch assemble
... --engine batch --device cpu` prints the same per-round consensus as the
in-process BatchAssembler with the same flags, and writes one metrics
record per round; `--contigs > 1` and `--device cuda` without a GPU
raise instead of falling back."""

import io
import json

import pytest
import torch

from pacbioassembly_tpu_torch.assemble import ReadStore
from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler
from pacbioassembly_tpu_torch.config import AssemblyConfig
from pacbioassembly_tpu_torch.tools.cli import main

from torch_slice import patterns, write_fixture

torch.set_num_threads(1)


def _argv(fx, *extra):
    return [
        "assemble", fx["bin"], fx["seeds"], "--engine", "batch",
        "--schedule", "roundrobin", "--rng-seed", "4", "-m", "3",
        "-f", fx["init"], "-q", *extra,
    ]


def test_cli_cpu_matches_in_process(tmp_path, capsys):
    fx = write_fixture(tmp_path)
    metrics = str(tmp_path / "metrics.jsonl")
    assert main(_argv(fx, "--device", "cpu", "--metrics", metrics)) == 0
    cli_out = capsys.readouterr().out

    cfg = AssemblyConfig(
        engine="batch", rng_seed=4, pattern_schedule="roundrobin", max_round=3,
        initial_ref_path=fx["init"],
    )
    asm = BatchAssembler(cfg, ReadStore.from_file(fx["bin"], cfg), patterns(), device="cpu")
    out = io.StringIO()
    asm.run(out=out)
    assert cli_out == out.getvalue()
    assert len(cli_out.splitlines()) == 3

    recs = [json.loads(line) for line in open(metrics)]
    rounds = [r for r in recs if r["event"] == "round"]
    assert recs[0]["event"] == "run_start" and len(rounds) == 3
    assert [r["nmatches"] for r in rounds] == [s.nmatches for s in asm.history]
    assert all("screen_s" in r and "launches" in r for r in rounds)


def test_cli_refuses_what_it_cannot_do(tmp_path, monkeypatch):
    fx = write_fixture(tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(_argv(fx, "--device", "cpu", "--contigs", "2"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        main(_argv(fx, "--device", "cuda"))
