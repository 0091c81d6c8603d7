"""Port: the host layers the port keeps as its own copies (config, codec,
align types/banded/dispatch/bitparallel, native pbcore, index/seedmap, consensus/state,
assemble reads/checkpoint/driver, tools/simulate, tools/coverage,
tools/fastx, utils/metrics) against
their originals in the JAX package, on the same seeded numpy inputs. One
parametrised test, one case per copied layer; everything is exact. The
checkpoint case carries a run across in both directions, and the native
case pins that the port builds and loads its own library."""

import dataclasses
import io
import os
import types

import numpy as np
import pytest

import pacbioassembly_tpu.align as jax_align
import pacbioassembly_tpu.align.banded as jax_banded
import pacbioassembly_tpu.align.bitparallel as jax_bitparallel
import pacbioassembly_tpu.assemble as jax_assemble
import pacbioassembly_tpu.assemble.checkpoint as jax_ckpt
import pacbioassembly_tpu.codec as jax_codec
import pacbioassembly_tpu.config as jax_config
import pacbioassembly_tpu.consensus as jax_consensus
import pacbioassembly_tpu.index as jax_index
import pacbioassembly_tpu.native.pbcore as jax_pbcore
import pacbioassembly_tpu.tools.coverage as jax_coverage
import pacbioassembly_tpu.tools.fastx as jax_fastx
import pacbioassembly_tpu.tools.simulate as jax_simulate
import pacbioassembly_tpu.utils.metrics as jax_metrics
import pacbioassembly_tpu_torch.align as port_align
import pacbioassembly_tpu_torch.align.banded as port_banded
import pacbioassembly_tpu_torch.align.bitparallel as port_bitparallel
import pacbioassembly_tpu_torch.assemble as port_assemble
import pacbioassembly_tpu_torch.assemble.checkpoint as port_ckpt
import pacbioassembly_tpu_torch.codec as port_codec
import pacbioassembly_tpu_torch.config as port_config
import pacbioassembly_tpu_torch.consensus as port_consensus
import pacbioassembly_tpu_torch.index as port_index
import pacbioassembly_tpu_torch.native.pbcore as port_pbcore
import pacbioassembly_tpu_torch.tools.coverage as port_coverage
import pacbioassembly_tpu_torch.tools.fastx as port_fastx
import pacbioassembly_tpu_torch.tools.simulate as port_simulate
import pacbioassembly_tpu_torch.utils.metrics as port_metrics

from test_sharding import _random_edit_streams
from torch_jax_native import jax_native_loader  # noqa: F401  (builds the JAX library aside)
from torch_parity import overlap_cases, random_cases

DATA = os.path.join(os.path.dirname(__file__), "data")
SIM = dict(genome_len=5000, coverage=6.0, mean_read_len=700, min_read_len=520,
           max_read_len=1000, sub_rate=0.03, ins_rate=0.03, del_rate=0.03, seed=9)


def _records(simulate_mod, codec):
    genome, reads, truth = simulate_mod.simulate(simulate_mod.SimConfig(**SIM))
    buf = io.BytesIO()
    codec.write_records(buf, reads)
    return genome, buf.getvalue(), truth


def check_config():
    assert dataclasses.asdict(port_config.AssemblyConfig()) == dataclasses.asdict(
        jax_config.AssemblyConfig()
    )
    consts = [k for k in vars(jax_config.Constants) if k.isupper()]
    assert len(consts) > 5
    for k in consts:
        assert getattr(port_config.Constants, k) == getattr(jax_config.Constants, k), k


def check_codec():
    rng = np.random.default_rng(1)
    for n in (1, 3, 4, 17, 1000):
        codes = rng.integers(0, 4, n).astype(np.uint8)
        text = jax_codec.codes_to_text(codes)
        assert port_codec.codes_to_text(codes) == text
        np.testing.assert_array_equal(port_codec.text_to_codes(text), jax_codec.text_to_codes(text))
        packed = port_codec.pack_codes(codes)
        np.testing.assert_array_equal(packed, jax_codec.pack_codes(codes))
        np.testing.assert_array_equal(port_codec.unpack_codes(packed, n), codes)
        assert port_codec.record_from_codes(codes) == jax_codec.record_from_codes(codes)
        if n >= 16:
            pos = rng.integers(0, n - 15, 64)
            np.testing.assert_array_equal(
                port_codec.encode_seeds(codes, pos), jax_codec.encode_seeds(codes, pos)
            )
            rec = np.frombuffer(jax_codec.record_from_codes(codes), np.uint8)
            for p in pos[:8].tolist():
                assert port_codec.encode_seed(codes, p) == jax_codec.encode_seed(codes, p)
                assert port_codec.seed_at(rec, p) == jax_codec.seed_at(rec, p)
                assert port_codec.seed_at_quirk(rec, p) == jax_codec.seed_at_quirk(rec, p)
    for pat in open(os.path.join(DATA, "seeds.txt")).read().split():
        assert port_codec.parse_pattern(pat) == jax_codec.parse_pattern(pat)
    _, blob, _ = _records(jax_simulate, jax_codec)
    buf = np.frombuffer(blob, np.uint8)
    for got, want in zip(port_codec.scan_records(buf), jax_codec.scan_records(buf)):
        np.testing.assert_array_equal(got, want)


def check_seedmap():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, 30_000).astype(np.uint8)
    codes[20_000:21_000] = codes[5_000:6_000]  # repeated keys
    pattern = jax_codec.parse_pattern("111*11*1*1*11111")
    for mrl in (jax_config.Constants.MAX_READ_LEN, 4_000):
        (pi, pn), (ji, jn) = (
            port_index.build_seedmap(codes, pattern, max_read_len=mrl),
            jax_index.build_seedmap(codes, pattern, max_read_len=mrl),
        )
        assert pn == jn
        np.testing.assert_array_equal(pi.keys, ji.keys)
        np.testing.assert_array_equal(pi.positions, ji.positions)
        q = np.concatenate([ji.keys[rng.integers(0, len(ji.keys), 500)],
                            rng.integers(1, 1 << 32, 500, dtype=np.uint64).astype(np.uint32)])
        q = q & np.uint32(pattern)
        for got, want in zip(pi.lookup_batch(q), ji.lookup_batch(q)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(pi.lookup(int(q[0])), ji.lookup(int(q[0])))


def _fuzz_pairs():
    rng = np.random.default_rng(3)
    cases = overlap_cases(rng, 24, src_len=900, seg_lo=200, seg_hi=600, err=0.08, a_lo=100, a_hi=800)
    return cases + random_cases(rng, 8, a_hi=600, b_hi=600)


def _same_result(got, want):
    if want is None:
        assert got is None
        return False
    for f in ("matlen_a", "matlen_b", "cost", "len_a", "len_b", "max_dst", "diag_cost"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.ops, want.ops)
    np.testing.assert_array_equal(got.vals, want.vals)
    return True


def check_exact_align_native():
    lib = port_pbcore.load()
    # the port's own library, built into its own build/ directory
    assert os.path.dirname(lib._name) == os.path.join(
        os.path.dirname(os.path.dirname(port_pbcore.__file__)), "build"
    )
    # the JAX package's, built for this module outside pacbioassembly_tpu/native/
    jlib = jax_pbcore.load()
    assert os.path.dirname(jlib._name) != os.path.dirname(jax_pbcore._SRC_PATH)
    assert lib._name != jlib._name
    hits = 0
    for a, b in _fuzz_pairs():
        for ratio in (0.3, 0.15):
            hits += _same_result(port_pbcore.align(lib, a, b, ratio),
                                 jax_pbcore.align(jlib, a, b, ratio))
            _same_result(port_align.exact_align(a, b, ratio), jax_align.exact_align(a, b, ratio))
    assert hits >= 10


def check_exact_align_numpy():
    hits = 0
    for a, b in _fuzz_pairs():
        for ratio in (0.3, 0.15):
            hits += _same_result(port_banded.align_banded(a, b, ratio),
                                 jax_banded.align_banded(a, b, ratio))
    assert hits >= 10


def check_bitparallel():
    """bp_score, the bit-parallel exactness root, on the fuzz pairs at
    three ratios."""
    hits = 0
    for a, b in _fuzz_pairs():
        for ratio in (0.3, 0.15, 0.45):
            got = port_bitparallel.bp_score(a, b, ratio)
            assert got == jax_bitparallel.bp_score(a, b, ratio)
            hits += got is not None
    assert hits >= 10


def _evolved(consensus, seed_codes, streams):
    ops, vals, start, forward = streams
    ref = consensus.ConsensusRef(seed_codes.copy(), capacity=3 * len(seed_codes))
    for rnd in range(3):
        for i in range(rnd, len(start), 3):
            ne = int((ops[i] != 0).sum())
            ref.elect(int(start[i]), ops[i, :ne], vals[i, :ne], bool(forward[i]))
        ref.evolve()
    return ref


def check_consensus():
    rng = np.random.default_rng(4)
    L = 300
    seed_codes = rng.integers(0, 4, L).astype(np.uint8)
    streams = _random_edit_streams(rng, 48, L, 30)
    got = _evolved(port_consensus, seed_codes, streams).state_dict()
    want = _evolved(jax_consensus, seed_codes, streams).state_dict()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), k)


def check_simulate():
    pg, pblob, ptruth = _records(port_simulate, port_codec)
    jg, jblob, jtruth = _records(jax_simulate, jax_codec)
    np.testing.assert_array_equal(pg, jg)
    assert pblob == jblob and len(pblob) > 1000
    np.testing.assert_array_equal(np.asarray(ptruth), np.asarray(jtruth))


def check_reads():
    path = os.path.join(DATA, "synth_reads.bin")
    p = port_assemble.ReadStore.from_file(path, port_config.AssemblyConfig())
    j = jax_assemble.ReadStore.from_file(path, jax_config.AssemblyConfig())
    assert len(p) == len(j) > 10
    np.testing.assert_array_equal(p.offsets, j.offsets)
    np.testing.assert_array_equal(p.lengths, j.lengths)
    for i in range(len(j)):
        np.testing.assert_array_equal(p.codes(i), j.codes(i))
        assert p.quirk_seed(i, 5) == j.quirk_seed(i, 5)


def check_driver():
    """The exact engine, 3 rounds of the pipeline's spaced-seed fixture."""
    def run(config, assemble, codec):
        cfg = config.AssemblyConfig(
            initial_ref_path=os.path.join(DATA, "synth_init.txt"), max_round=3,
            pattern_schedule="roundrobin", quirk_init_newline=True, quirk_seed_at=True,
        )
        reads = assemble.ReadStore.from_file(os.path.join(DATA, "synth_reads.bin"), cfg)
        asm = assemble.Assembler(cfg, reads, codec.dna.load_patterns(os.path.join(DATA, "oneseed_spaced.txt")))
        out = io.StringIO()
        asm.run(out=out)
        return asm, out.getvalue()

    (p, pout), (j, jout) = run(port_config, port_assemble, port_codec), run(
        jax_config, jax_assemble, jax_codec
    )
    assert [dataclasses.asdict(s) for s in p.history] == [dataclasses.asdict(s) for s in j.history]
    assert pout == jout and pout and len(p.history) == 3
    assert p.surviving == j.surviving


def _engine_state(consensus, rng_seed):
    rng = np.random.default_rng(rng_seed)
    streams = _random_edit_streams(rng, 20, 200, 20)
    ref = _evolved(consensus, rng.integers(0, 4, 200).astype(np.uint8), streams)
    asm = types.SimpleNamespace(
        ref=ref, rng=rng, surviving=[1, 4, 9, 16], nround=7, nfailure=1,
        retreats=2, fruitless_retreats=1, matches_since_retreat=3,
    )
    rng.integers(0, 100, 5)  # move the generator past its seed state
    return asm


def _fresh(consensus):
    ref = consensus.ConsensusRef(np.zeros(8, np.uint8), capacity=600)
    return types.SimpleNamespace(ref=ref, rng=np.random.default_rng(0), surviving=[],
                                 nround=0, nfailure=0, retreats=0, fruitless_retreats=0,
                                 matches_since_retreat=0)


def check_checkpoint(tmp_path):
    """A run moves between the engines through the .npz checkpoint, both
    ways: what one writes, the other restores field for field."""
    for src_ckpt, src_cons, dst_ckpt, dst_cons in (
        (jax_ckpt, jax_consensus, port_ckpt, port_consensus),
        (port_ckpt, port_consensus, jax_ckpt, jax_consensus),
    ):
        src = _engine_state(src_cons, 5)
        path = str(tmp_path / f"{src_ckpt.__name__}.npz")
        src_ckpt.save_checkpoint(path, src)
        dst = _fresh(dst_cons)
        dst_ckpt.load_checkpoint(path, dst)
        assert isinstance(dst.ref, dst_cons.ConsensusRef)
        for k in ("surviving", "nround", "nfailure", "retreats", "fruitless_retreats",
                  "matches_since_retreat"):
            assert getattr(dst, k) == getattr(src, k), k
        assert dst.rng.integers(0, 1 << 30, 4).tolist() == src.rng.integers(0, 1 << 30, 4).tolist()
        sd, dd = src.ref.state_dict(), dst.ref.state_dict()
        for k in sd:
            np.testing.assert_array_equal(np.asarray(dd[k]), np.asarray(sd[k]), k)


def check_metrics():
    recs = []
    for metrics, assemble in ((port_metrics, port_assemble), (jax_metrics, jax_assemble)):
        stream = io.StringIO()
        log = metrics.MetricsLogger(stream=stream)
        stats = assemble.driver.RoundStats(3, 7, 100, 2000, 5, 40, 12, 123456)
        rec = log.round(stats, extra={"screen_s": 0.5})
        log.event("run_start", resume=False)
        recs.append(({k: v for k, v in rec.items() if k not in ("t", "round_s", "dp_cells_per_s")},
                     stream.getvalue().count("\n")))
    assert recs[0] == recs[1]
    with port_metrics.profiled(None):
        pass  # no trace directory: no profiler, no jax


def check_coverage():
    """evaluate_assembly and its parts on a chimeric, a clean, a shuffled
    and a junk contig of one genome."""
    rng = np.random.default_rng(6)
    g = rng.integers(0, 4, 120_000).astype(np.uint8)
    noisy = g[5_000:40_000].copy()
    pos = rng.choice(len(noisy), 700, replace=False)
    noisy[pos] = (noisy[pos] + 1) % 4
    contigs = [noisy, np.concatenate([g[50_000:60_000], g[90_000:100_000]]),
               np.concatenate([g[110_000:118_000], g[62_000:70_000]]),
               rng.integers(0, 4, 3_000).astype(np.uint8), g[70_000:70_010].copy()]
    (pk, pp), (jk, jp) = port_coverage._unique_anchors(g), jax_coverage._unique_anchors(g)
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pp, jp)
    for c in contigs:
        assert port_coverage.contig_intervals(c, pk, pp) == jax_coverage.contig_intervals(c, jk, jp)
        assert port_coverage.contig_chains(c, pk, pp) == jax_coverage.contig_chains(c, jk, jp)
    for kw in ({}, {"max_gap": 200, "break_tol": 5_000}):
        got = port_coverage.evaluate_assembly(g, contigs, **kw)
        assert got == jax_coverage.evaluate_assembly(g, contigs, **kw)
    assert got["misassemblies"] >= 2 and 0.4 < got["genome_fraction"] < 0.7


def check_fastx(tmp_path):
    """The parser on FASTA, FASTQ and headerless text, and the import
    command's records and quality stream."""
    rng = np.random.default_rng(7)
    seqs = [port_codec.codes_to_text(rng.integers(0, 4, int(n)).astype(np.uint8))
            for n in rng.integers(5, 400, 8)]
    quals = ["".join(chr(33 + int(q)) for q in rng.integers(0, 41, len(s))) for s in seqs]
    texts = {
        "fa": "".join(f">s{i} x\n{s[:50]}\n{s[50:]}\n\n" for i, s in enumerate(seqs)),
        "fq": "".join(f"@s{i}\n{s}\n+\n{q}\n" for i, (s, q) in enumerate(zip(seqs, quals))),
        "txt": "\n".join(seqs) + "\n",
    }
    for ext, text in texts.items():
        got = list(port_fastx.parse_fastx(io.StringIO(text)))
        assert got == list(jax_fastx.parse_fastx(io.StringIO(text))) and len(got) == 8
        src = tmp_path / f"in.{ext}"
        src.write_text(text)
        blobs = []
        for mod in (port_fastx, jax_fastx):
            out, q = tmp_path / f"{mod.__name__}.bin", tmp_path / f"{mod.__name__}.q"
            mod.cmd_fastx(types.SimpleNamespace(input=str(src), out=str(out), min_len=100,
                                                quality_out=str(q)))
            blobs.append((out.read_bytes(), q.read_text()))
        assert blobs[0] == blobs[1] and blobs[0][0]


CHECKS = {
    "config": check_config,
    "codec": check_codec,
    "seedmap": check_seedmap,
    "exact_align_native": check_exact_align_native,
    "exact_align_numpy": check_exact_align_numpy,
    "bitparallel": check_bitparallel,
    "consensus": check_consensus,
    "simulate": check_simulate,
    "coverage": check_coverage,
    "fastx": check_fastx,
    "reads": check_reads,
    "driver": check_driver,
    "checkpoint": check_checkpoint,
    "metrics": check_metrics,
}


@pytest.mark.parametrize("layer", sorted(CHECKS))
def test_port_copy_equals_original(layer, tmp_path):
    fn = CHECKS[layer]
    fn(tmp_path) if fn in (check_checkpoint, check_fastx) else fn()
