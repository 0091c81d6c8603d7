"""chip_smoke.py's readers of the committed whole-genome runs of the JAX
package (benchmarks/results/), which `chip_smoke.py --genome [3pct|clr]`
holds the port to on the card: the per-round metrics as one segment per
contig, the CLR run's assembly FASTA against the build indices its
summary's dedupe keeps, and each run's store and engine config against
benchmarks/ecoli_scale.py with the flags of that run. No engine runs here;
this guards the gates' own logic where no card is present."""

import gzip
import importlib.util
import inspect
import json
import os
import re
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


smoke = load("chip_smoke", "chip_smoke.py")

# benchmarks/results/README.md: the flags of each committed run (the r5 rows
# take the r4 rows' regime and knobs with --contigs 64)
FLAGS = {
    "3pct": ["--error-rate", "0.03"],
    "clr": ["--error-profile", "clr"],
}
RETREAT_FLAGS = ["--contigs", "64", "--edge-retreat", "400", "--retreat-bite", "96",
                 "--retreat-min-len", "20000", "--retreat-fruitless", "3"]


def read_assembly_fasta(path) -> list[tuple[int, int, str]]:
    """(k, j, sequence) of each record `>contig_k len=L src=contig_j.txt` of
    a gzipped assembly FASTA; L is held to the sequence's length."""
    recs = []
    with gzip.open(path, "rt") as fh:
        for line in fh:
            if line.startswith(">"):
                k, L, j = re.fullmatch(r">contig_(\d+) len=(\d+) src=contig_(\d+)\.txt\n",
                                       line).groups()
                recs.append([int(k), int(j), int(L), []])
            else:
                recs[-1][3].append(line.strip())
    out = [(k, j, "".join(s)) for k, j, _, s in recs]
    assert [len(s) for _, _, s in out] == [L for _, _, L, _ in recs]
    return out


def summary(key):
    with open(smoke.GENOME_RUNS[key].prefix + "_summary.json") as fh:
        return json.load(fh)


@pytest.mark.parametrize("key, n_segments, n_rounds", [("clr", 64, 4191), ("3pct", 6, 1383)])
def test_committed_segments(key, n_segments, n_rounds):
    run = smoke.GENOME_RUNS[key]
    segs = smoke.committed_segments(run.prefix + "_metrics.jsonl")
    assert len(segs) == n_segments <= run.contigs
    assert sum(len(s) for s in segs) == n_rounds
    # every segment is one engine run from round 1, with no round missing
    assert all(sorted(s) == list(range(1, len(s) + 1)) for s in segs)
    assert all(k in segs[0][1] for k in smoke.GENOME_GATED + smoke.GENOME_SHOWN)


@pytest.mark.parametrize("key", ["clr", "3pct"])
def test_summary_rounds_are_the_kept_contigs(key):
    """The summary's `rounds` sums the kept contigs' rounds only, after the
    dedupe (benchmarks/ecoli_scale.py): 3,449 of the CLR run's 4,191."""
    s = summary(key)
    segs = smoke.committed_segments(smoke.GENOME_RUNS[key].prefix + "_metrics.jsonl")
    dropped = {d["idx"] for d in s.get("contigs_dropped_contained", [])}
    kept = [i for i in range(len(segs)) if i not in dropped]
    assert sum(max(segs[i]) for i in kept) == s["rounds"]
    assert len(kept) == len(s["contig_lens"])
    assert s["n_reads"] - s["reads_consumed"] == s["reads_unconsumed"]
    # the last round of each segment holds the reads its contig left
    left = [segs[i][max(segs[i])]["nreads_left"] for i in range(len(segs))]
    assert left[-1] == s["reads_unconsumed"]


def test_clr_fasta_maps_onto_the_kept_build_indices():
    run, s = smoke.GENOME_RUNS["clr"], summary("clr")
    recs = read_assembly_fasta(os.path.join(smoke.RESULTS, run.assembly))
    assert [k for k, _, _ in recs] == list(range(24))
    assert [len(seq) for _, _, seq in recs] == s["contig_lens"]
    dropped = [d["idx"] for d in s["contigs_dropped_contained"]]
    assert len(dropped) == len(set(dropped)) == 40
    kept_build = [i for i in range(run.contigs) if i not in dropped]
    by_j = {j: seq for _, j, seq in recs}
    assert sorted(by_j) == list(range(len(kept_build)))
    # the kept list in build order: coverage_eval's per-contig lengths
    assert [len(by_j[j]) for j in sorted(by_j)] == [
        c["len"] for c in s["coverage_eval"]["per_contig"]]
    # contig_1 src=contig_2.txt: build index 2, 918,117 bp
    k1 = next(r for r in recs if r[0] == 1)
    assert kept_build[k1[1]] == 2 and len(k1[2]) == 918_117
    # each dropped contig's length and target are a build index's
    for d in s["contigs_dropped_contained"]:
        assert d["into"] in kept_build and d["covered"] >= 0.8


def test_assembly_fasta_writes_the_committed_bytes():
    from pacbioassembly_tpu_torch.codec import dna

    run = smoke.GENOME_RUNS["clr"]
    path = os.path.join(smoke.RESULTS, run.assembly)
    recs = read_assembly_fasta(path)
    kept = [dna.text_to_codes(seq) for _, _, seq in sorted(recs, key=lambda r: r[1])]
    with gzip.open(path, "rt") as fh:
        assert smoke.assembly_fasta(kept) == fh.read()


@pytest.mark.parametrize("key", ["clr", "3pct"])
def test_committed_residuals(key):
    s = summary(key)
    per_contig, agg = smoke.committed_residuals(s)
    lens = [c["len"] for c in s["coverage_eval"]["per_contig"]]
    own = [r for r, n in zip(per_contig, lens)
           if len(lens) == 1 or n >= smoke.RESIDUAL_MIN_LEN]
    assert None not in own and len(own) == (12 if key == "clr" else 1)
    assert per_contig.count(None) == len(lens) - len(own)
    assert agg == (0.0469 if key == "clr" else 0.014)
    assert s["quality"]["residual_error"] == max(zip(lens, per_contig))[1]


class Stop(Exception):
    pass


@pytest.mark.parametrize("key", ["clr", "3pct"])
def test_run_table_equals_ecoli_scale(key, monkeypatch, tmp_path):
    """GENOME_RUNS[key]'s store and config are benchmarks/ecoli_scale.py's
    with the run's flags: its SimConfig, caught as the script builds it, and
    its AssemblyConfig, caught the same way with the store already on disk."""
    import pacbioassembly_tpu.config as jax_config
    import pacbioassembly_tpu.tools.simulate as jax_sim
    import pacbioassembly_tpu.utils as jax_utils

    ecoli = load("ecoli_scale", os.path.join("benchmarks", "ecoli_scale.py"))
    run, s = smoke.GENOME_RUNS[key], summary(key)
    argv = ["ecoli_scale.py", *FLAGS[key], *RETREAT_FLAGS, "--out", str(tmp_path)]
    monkeypatch.setattr("sys.argv", argv)
    monkeypatch.setattr(jax_utils, "enable_compilation_cache", lambda: None)
    caught = {}

    def catch(what):
        def f(*a, **kw):
            caught[what] = (a, kw)
            raise Stop
        return f

    with monkeypatch.context() as mp:
        mp.setattr(jax_sim, "simulate", catch("sim"))
        with pytest.raises(Stop):
            ecoli.main()
    (sim,), _ = caught["sim"]
    st = run.store
    sub, ins, dele = jax_sim.split_error_rate(st["error"], st["profile"])
    assert (sim.genome_len, sim.coverage, sim.mean_read_len, sim.max_read_len, sim.seed,
            sim.sub_rate, sim.ins_rate, sim.del_rate) == (
        st["genome_len"], st["coverage"], st["mean_read_len"], st["max_read_len"], st["seed"],
        sub, ins, dele)
    assert (s["genome_len"], s["coverage"], s["error_rate"], s["error_profile"]) == (
        st["genome_len"], st["coverage"], st["error"], st["profile"])

    # with the store on disk the script goes on to its AssemblyConfig
    tag = "" if st["profile"] == "uniform" else f"_{st['profile']}"
    open(os.path.join(tmp_path, f"reads_{st['genome_len']}_{st['coverage']:g}_"
                                f"{st['error']:g}{tag}_{st['seed']}.bin"), "wb").close()
    monkeypatch.setattr(jax_config, "AssemblyConfig", catch("cfg"))
    with pytest.raises(Stop):
        ecoli.main()
    _, kw = caught["cfg"]
    for k in ("metrics_path", "checkpoint_path", "resume_path"):
        kw.pop(k)
    assert kw.pop("max_round") is None
    assert kw == run.config
    assert run.contigs == int(RETREAT_FLAGS[1])
    # ecoli_scale.py classifies with classify_reads' own min_contig
    import pacbioassembly_tpu.tools.postprocess as jax_post

    sig = inspect.signature(jax_post.classify_reads)
    assert sig.parameters["min_contig"].default == smoke.CLASSIFY_MIN_CONTIG
