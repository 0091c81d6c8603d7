"""Port: the device read matrix and batch gather (pacbioassembly_tpu_torch/
assemble/gather.py::DeviceBatchBuilder) against the JAX builder and its
fused gather (pacbioassembly_tpu/assemble/gather.py::_materialize_on_device)
and the host packing path. Forward and backward candidates, ladder pad
rows and the prefilter's truncation to the first LB bases. Byte-equal."""

import dataclasses
import os

import numpy as np
import torch

from pacbioassembly_tpu.align.screen import ladder_size, size_bucket
from pacbioassembly_tpu.assemble import ReadStore as JaxReads
from pacbioassembly_tpu.assemble.gather import DeviceBatchBuilder as JaxBuilder
from pacbioassembly_tpu.config import AssemblyConfig as JaxConfig
from pacbioassembly_tpu_torch.assemble import ReadStore
from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler, expand_candidates
from pacbioassembly_tpu_torch.codec.dna import load_patterns
from pacbioassembly_tpu_torch.config import AssemblyConfig
from pacbioassembly_tpu_torch.index import build_seedmap

from torch_jax_native import jax_native_loader  # noqa: F401  (builds the JAX library aside)

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


def test_gather_matches_jax_builder_and_host_packing():
    cfg = AssemblyConfig(
        initial_ref_path=os.path.join(DATA, "synth_init.txt"),
        pattern_schedule="roundrobin",
        quirk_init_newline=True,
        quirk_seed_at=True,
        engine="batch",
    )
    reads = ReadStore.from_file(os.path.join(DATA, "synth_reads.bin"), cfg)
    patterns = load_patterns(os.path.join(DATA, "oneseed_spaced.txt"))
    asm = BatchAssembler(cfg, reads, patterns, device="cpu")
    index, _ = build_seedmap(asm.ref.text(), patterns[0])
    cands, _, _ = expand_candidates(
        asm.reads, asm.surviving, index, patterns[0], cfg, asm._trial_cache
    )
    assert len(cands) and cands.forward.any() and (~cands.forward).any()
    seg_len, ref_len = asm._geometry(cands)

    port = asm._builder()
    jax_cfg = JaxConfig(**dataclasses.asdict(cfg))
    jaxb = JaxBuilder(JaxReads.from_file(os.path.join(DATA, "synth_reads.bin"), jax_cfg), jax_cfg)
    assert port.ok and jaxb.ok
    np.testing.assert_array_equal(port.reads_mat.numpy(), np.asarray(jaxb.reads_mat))
    np.testing.assert_array_equal(port.read_len.numpy(), np.asarray(jaxb.read_len))

    idxs = np.argsort(-seg_len, kind="stable")
    LB, LA, W = size_bucket(int(seg_len.max()), cfg.ratio)
    LBp = cfg.prefilter_len
    LAp = LBp + 1 + int(LBp * cfg.prefilter_ratio) + 1
    for la_w, lb_w in ((LA, LB), (LAp, LBp)):  # full screen, prefilter
        Bp = ladder_size(len(idxs))
        assert Bp > len(idxs), "fixture must include ladder pad rows"
        vecs = asm._device_vectors(cands, idxs, ref_len, la_w, Bp)
        got = port.materialize(asm.ref, *vecs, la_w, lb_w)
        want = jaxb.materialize(asm.ref, *vecs, la_w, lb_w)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        la_d, lb_d = got[1].numpy(), got[3].numpy()
        assert (la_d[len(idxs):] == 1).all() and (lb_d[len(idxs):] == 1).all()
        if lb_w == LBp:
            assert lb_d.max() == LBp  # truncated to the first LB bases

    # the device gather equals the host packing path
    a_h, la_h, b_h, lb_h = asm._materialize(cands, idxs, seg_len, ref_len, LB, LA)
    a_d, la_d, b_d, lb_d = port.materialize(
        asm.ref, *asm._device_vectors(cands, idxs, ref_len, LA, len(idxs)), LA, LB
    )
    np.testing.assert_array_equal(a_d.numpy(), a_h)
    np.testing.assert_array_equal(b_d.numpy(), b_h)
    np.testing.assert_array_equal(la_d.numpy(), la_h)
    np.testing.assert_array_equal(lb_d.numpy(), lb_h)


def test_shared_builder_serves_each_engines_own_window(monkeypatch):
    """Multi-contig restarts share one builder: a later engine's reference
    gets its own window even when it takes a freed reference's id() and
    equals it in version and window bounds (forced here: every id() is 1)."""
    from pacbioassembly_tpu_torch.assemble import gather
    from pacbioassembly_tpu_torch.consensus import ConsensusRef

    cfg = AssemblyConfig(engine="batch")
    reads = ReadStore.from_file(os.path.join(DATA, "synth_reads.bin"), cfg)
    builder = gather.DeviceBatchBuilder(reads, cfg, torch.device("cpu"))
    monkeypatch.setattr(gather, "id", lambda obj: 1, raising=False)
    rng = np.random.default_rng(1)
    first = ConsensusRef(rng.integers(0, 4, 900).astype(np.uint8), capacity=3000)
    win, wlen = builder.window(first)
    assert torch.equal(win[:wlen], torch.from_numpy(first.buf[first.pre : first.post]))
    del first
    second = ConsensusRef(rng.integers(0, 4, 900).astype(np.uint8), capacity=3000)
    win, wlen = builder.window(second)
    assert torch.equal(win[:wlen], torch.from_numpy(second.buf[second.pre : second.post]))
    assert builder.window(second)[0] is win  # same reference, same version: cached
