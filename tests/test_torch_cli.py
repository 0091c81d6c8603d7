"""Port: the command line. `python -m pacbioassembly_tpu_torch assemble
... --engine batch --device cpu` prints the same per-round consensus as the
in-process BatchAssembler with the same flags, and writes one metrics
record per round; `assemble --contigs 2` prints the same FASTA and the same
log as the JAX CLI; `--contigs` with the exact engine is refused as the
JAX CLI refuses it, and `--device cuda` without a GPU raises instead of
falling back."""

import io
import json

import jax
import pytest
import torch

from pacbioassembly_tpu.tools import cli as jax_cli
from pacbioassembly_tpu_torch.assemble import ReadStore
from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler
from pacbioassembly_tpu_torch.config import AssemblyConfig
from pacbioassembly_tpu_torch.tools.cli import main

from torch_contigs import SEEDS, SETTINGS, SMALL, write_two_segments
from torch_jax_native import jax_native_loader  # noqa: F401  (builds the JAX library aside)
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


def test_cli_refuses_what_it_cannot_do(tmp_path, monkeypatch, capsys):
    fx = write_fixture(tmp_path)
    # --contigs needs the batch engine: both CLIs print the same refusal
    exact = ["assemble", fx["bin"], fx["seeds"], "--contigs", "2"]
    assert jax_cli.main(exact) == 1
    want = capsys.readouterr().err
    assert main(exact) == 1
    assert capsys.readouterr().err == want == "--contigs requires --engine batch\n"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        main(_argv(fx, "--device", "cuda"))
    with pytest.raises(RuntimeError, match="is_available"):
        main(_argv(fx, "--device", "cuda", "--contigs", "2"))


def test_contigs_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """`assemble --contigs 2` on a two-segment store (tests/torch_contigs.py),
    the JAX CLI pinned to one device: stdout (FASTA) and stderr (the round
    log, the contig lines and the summary) equal byte for byte."""
    store = write_two_segments(tmp_path, **SMALL)
    dev0 = jax.devices()[0]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev0])
    argv = ["assemble", store, SEEDS, "--engine", "batch", "--schedule", "roundrobin",
            "--rng-seed", str(SETTINGS["rng_seed"]), "-m", str(SETTINGS["max_round"]),
            "--contigs", "2"]
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr()
    assert main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want.out and got.err == want.err
    headers = [ln for ln in got.out.splitlines() if ln.startswith(">")]
    assert [h.split()[0] for h in headers] == [">contig_0", ">contig_1"]
    assert headers[0].startswith(">contig_0 length=3") and " rounds=4" in headers[0]
    assert got.err.splitlines()[-1] == "2 contigs, 88 of 90 reads consumed"
