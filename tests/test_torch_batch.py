"""Port: the slice end to end. The port's BatchAssembler on the CPU (the
kernels' plain versions) against the JAX BatchAssembler pinned to one
device (its fused single-device path: prefilter, full screen, device
traceback, device elect), 6 rounds on the same reads and config: every
RoundStats (as dicts), the contig bytes, the votes and the surviving reads
equal. The port runs once per screening kernel (K1 `bitwave`, K3 `rowdp`);
the JAX run is the module fixture, so it runs once."""

import io

import pytest
import torch

from pacbioassembly_tpu.assemble import ReadStore
from pacbioassembly_tpu_torch import _build
from pacbioassembly_tpu_torch.align import bitwave, wavefront
from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler

from torch_jax_native import jax_native_loader  # noqa: F401  (builds the JAX library aside)
from torch_slice import (
    assert_same_state,
    history_dicts,
    patterns,
    port_config,
    port_reads,
    slice_config,
    write_fixture,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return write_fixture(tmp_path_factory.mktemp("torch_slice"))


@pytest.fixture(scope="module")
def jax_run(fx):
    import jax

    from pacbioassembly_tpu.assemble.batch import BatchAssembler as JaxAssembler

    cfg = slice_config(fx)
    dev0 = jax.devices()[0]
    with pytest.MonkeyPatch.context() as mp:
        # the suite runs on 8 virtual CPU devices: pin the fused
        # single-device path, as tests/test_tbwave.py does
        mp.setattr(jax, "devices", lambda *a, **k: [dev0])
        asm = JaxAssembler(cfg, ReadStore.from_file(fx["bin"], cfg), patterns())
        out = io.StringIO()
        asm.run(out=out)
    return asm, out.getvalue()


@pytest.mark.parametrize("screen_kernel", ["bitwave", "rowdp"])
def test_slice_matches_jax_engine(fx, jax_run, monkeypatch, screen_kernel):
    ref, ref_out = jax_run
    cfg = port_config(slice_config(fx))
    # which wrapper each screening launch went through (on the CPU both
    # run the plain row DP, so the kernel counters stay 0)
    routed = {"bitwave": 0, "rowdp": 0}
    for mod, name, fn in (
        (bitwave, "bitwave", "batch_score_bitwave"),
        (wavefront, "rowdp", "batch_score_rowdp"),
    ):
        real = getattr(mod, fn)

        def spy(*a, _real=real, _name=name, **k):
            routed[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, fn, spy)
    _build.reset_counts()
    asm = BatchAssembler(
        cfg, port_reads(fx["bin"], cfg), patterns(), device="cpu", screen_kernel=screen_kernel
    )
    out = io.StringIO()
    asm.run(out=out)
    assert len(asm.history) == 6
    assert history_dicts(asm) == history_dicts(ref)
    assert out.getvalue() == ref_out  # every round's consensus
    assert_same_state(asm, ref)
    assert asm.ref.length() > 3000 and len(asm.surviving) < len(asm.reads)
    # the plain versions carried it, both screening passes ran every round,
    # every one through the chosen kernel's wrapper
    counts = dict(_build.LAUNCHES)
    assert {k for k, v in counts.items() if v} == {"plain_batch_score", "plain_parents", "plain_walk"}
    assert counts["plain_batch_score"] >= 12
    other = "rowdp" if screen_kernel == "bitwave" else "bitwave"
    assert routed[screen_kernel] == counts["plain_batch_score"] and routed[other] == 0
    assert asm.phase_s["prefilter_kept"] >= 0
