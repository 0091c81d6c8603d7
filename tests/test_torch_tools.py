"""Port: the host-only commands of the CLI (convert 0/1/2, import, visualize,
quality, stat-hash) and tools/fastx.py's parser against the JAX CLI and
parser: on the same stdin and arguments, the same exit code, stdout, stderr
and output files, byte for byte."""

import io
import os

import numpy as np
import pytest

from pacbioassembly_tpu.codec import binary_io, dna
from pacbioassembly_tpu.tools import cli as jax_cli
from pacbioassembly_tpu.tools.fastx import parse_fastx as jax_parse_fastx
from pacbioassembly_tpu_torch.tools import cli as port_cli
from pacbioassembly_tpu_torch.tools.fastx import parse_fastx

from torch_jax_native import jax_native_loader  # noqa: F401  (builds the JAX library aside)

DATA = os.path.join(os.path.dirname(__file__), "data")


def _reads(n=6, seed=11):
    rng = np.random.default_rng(seed)
    return [dna.codes_to_text(rng.integers(0, 4, int(rng.integers(20, 300))).astype(np.uint8))
            for _ in range(n)]


def _alignable_pairs():
    """visualize's stdin: (ref, seg) word pairs, the seg a mutated copy of
    the ref's start, one pair that cannot align, and a trailing odd word."""
    rng = np.random.default_rng(12)
    words = []
    for k in range(4):
        ref = rng.integers(0, 4, 400).astype(np.uint8)
        seg = ref[: 300 + 20 * k].copy()
        pos = rng.choice(len(seg), 9, replace=False)
        seg[pos[:3]] = (seg[pos[:3]] + 1) % 4
        seg = np.delete(seg, pos[3:6])
        seg = np.insert(seg, pos[6:] % len(seg), 2)
        words += [dna.codes_to_text(ref), dna.codes_to_text(seg)]
    junk = rng.integers(0, 4, 200).astype(np.uint8)
    words += [dna.codes_to_text(junk), dna.codes_to_text(rng.integers(0, 4, 200).astype(np.uint8))]
    return " ".join(words[:4]) + "\n" + "\n".join(words[4:]) + "\nACGT\n"


def _fasta():
    reads = _reads()
    return "".join(f">r{i} read {i}\n{r[:60]}\n{r[60:]}\n" for i, r in enumerate(reads)) + ">empty\n"


def _fastq():
    reads = _reads(seed=13)
    rng = np.random.default_rng(14)
    return "".join(
        f"@q{i}\n{r}\n+\n{''.join(chr(33 + int(q)) for q in rng.integers(0, 41, len(r)))}\n"
        for i, r in enumerate(reads)
    )


# name -> (argv with {tmp} for the case's directory, stdin, input files to
# write {name: text}, output files to compare)
CASES = {
    "convert0": (["convert", "0"], "\n".join(_reads()) + "\n", {}, []),
    "convert0_mismatch": (["convert", "0"], "ACGT ACGNT\nTTTT\n", {}, []),
    "convert1": (["convert", "1", "{tmp}/out.bin"], "\n".join(_reads()) + "\n\n", {}, ["out.bin"]),
    "convert2": (["convert", "2", os.path.join(DATA, "synth_reads.bin")], "", {}, []),
    "import_fasta": (["import", "{tmp}/in.fa", "{tmp}/out.bin", "--min-len", "100",
                      "--quality-out", "{tmp}/q.txt"], "", {"in.fa": _fasta()},
                     ["out.bin", "q.txt"]),
    "import_fastq": (["import", "{tmp}/in.fq", "{tmp}/out.bin", "--quality-out", "{tmp}/q.txt"],
                     "", {"in.fq": _fastq()}, ["out.bin", "q.txt"]),
    "import_headerless": (["import", "{tmp}/in.txt", "{tmp}/out.bin"], "",
                          {"in.txt": "\n".join(_reads(seed=15)) + "\n"}, ["out.bin"]),
    "visualize": (["visualize"], _alignable_pairs(), {}, []),
    "visualize_ratio": (["visualize", "-r", "0.15"], _alignable_pairs(), {}, []),
    "quality": (["quality"], "IIII\n!!!!+5\n\n" + _fastq().splitlines()[3] + "\n", {}, []),
    "stat-hash": (["stat-hash"], "\n".join(_reads(seed=16)) + "\n" + "A" * 5000 + "\nNNN", {}, []),
}


def _run(main, argv, stdin, tmp, files, outs, monkeypatch, capsys):
    tmp.mkdir()
    for name, text in files.items():
        (tmp / name).write_text(text)
    monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    rc = main([a.replace("{tmp}", str(tmp)) for a in argv])
    cap = capsys.readouterr()
    return rc, cap.out, cap.err.replace(str(tmp), "{tmp}"), [(tmp / o).read_bytes() for o in outs]


@pytest.mark.parametrize("case", sorted(CASES))
def test_tool_equals_jax_cli(case, tmp_path, monkeypatch, capsys):
    argv, stdin, files, outs = CASES[case]
    got = _run(port_cli.main, argv, stdin, tmp_path / "port", files, outs, monkeypatch, capsys)
    want = _run(jax_cli.main, argv, stdin, tmp_path / "jax", files, outs, monkeypatch, capsys)
    assert got == want
    rc, out, err, blobs = got
    assert rc == (1 if case == "convert0_mismatch" else 0)
    if case == "convert0":
        assert out == ""  # every word survives the round trip
    else:
        assert out or blobs
    if case.startswith("import"):
        texts = list(binary_io.binary_file_to_texts(str(tmp_path / "port" / "out.bin")))
        assert texts and err.startswith(f"wrote {len(texts)} records")
    if case.startswith("visualize"):
        assert "cannot align" in err and len(out.splitlines()) == 3 * 4


@pytest.mark.parametrize("text", [_fasta(), _fastq(), "\n".join(_reads()) + "\n", "",
                                  ">r1\nACGT\nACGT\n>r2\nTTTT\n",
                                  "@r1\nACGT\n+\nIIII\n@r2\nGGCC\n+\n!!!!\n"])
def test_parse_fastx_equals_jax(text):
    got = list(parse_fastx(io.StringIO(text)))
    assert got == list(jax_parse_fastx(io.StringIO(text)))
    if text.startswith(">r1\nACGT"):
        assert got == [("r1", "ACGTACGT", None), ("r2", "TTTT", None)]
    if text.startswith("@r1"):
        assert got == [("r1", "ACGT", "IIII"), ("r2", "GGCC", "!!!!")]
