"""Port: the slice end to end. The port's BatchAssembler on the CPU (the
kernels' plain versions) against the JAX BatchAssembler pinned to one
device (its fused single-device path: prefilter, full screen, device
traceback, device elect), 6 rounds on the same reads and config: every
RoundStats, the contig bytes, the votes and the surviving reads equal."""

import io

import pytest
import torch

from pacbioassembly_tpu.assemble import ReadStore
from pacbioassembly_tpu_torch import _build
from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler

from torch_slice import assert_same_state, patterns, slice_config, write_fixture

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


def test_slice_matches_jax_engine(fx, jax_run):
    ref, ref_out = jax_run
    cfg = slice_config(fx)
    _build.reset_counts()
    asm = BatchAssembler(cfg, ReadStore.from_file(fx["bin"], cfg), patterns(), device="cpu")
    out = io.StringIO()
    asm.run(out=out)
    assert len(asm.history) == 6
    assert asm.history == ref.history
    assert out.getvalue() == ref_out  # every round's consensus
    assert_same_state(asm, ref)
    assert asm.ref.length() > 3000 and len(asm.surviving) < len(asm.reads)
    # the plain versions carried it, both screening passes ran every round
    counts = dict(_build.LAUNCHES)
    assert all(counts[k] == 0 for k in _build.KERNELS)
    assert counts["plain_batch_score"] >= 12
    assert counts["plain_parents"] > 0 and counts["plain_walk"] > 0
    assert asm.phase_s["prefilter_kept"] >= 0
