"""Port: state carried across engines. The JAX BatchAssembler runs 3
rounds and checkpoints (assemble/checkpoint.py); the port resumes from
that checkpoint, with its own checkpoint code, for 3 more rounds. The
result equals 6 uninterrupted JAX rounds: RoundStats (as dicts: each
engine has its own class), contig bytes, votes, surviving reads."""

import dataclasses
import io

import torch

from pacbioassembly_tpu.assemble import ReadStore
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


def test_port_resumes_jax_checkpoint(tmp_path, monkeypatch):
    import jax

    from pacbioassembly_tpu.assemble.batch import BatchAssembler as JaxAssembler

    fx = write_fixture(tmp_path)
    ckpt = str(tmp_path / "round3.npz")
    dev0 = jax.devices()[0]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev0])

    cfg = slice_config(fx, max_round=3, checkpoint_path=ckpt, checkpoint_every=3)
    jax_asm = JaxAssembler(cfg, ReadStore.from_file(fx["bin"], cfg), patterns())
    jax_asm.run(out=io.StringIO())  # rounds 1-3, checkpoint at 3
    # the same JAX engine goes on to round 6 (an uninterrupted run)
    jax_asm.cfg = slice_config(fx, max_round=6)
    jax_asm.run(out=io.StringIO())
    assert jax_asm.nround == 6

    cfg = port_config(slice_config(fx, max_round=6, resume_path=ckpt))
    port = BatchAssembler(cfg, port_reads(fx["bin"], cfg), patterns(), device="cpu")
    port.run(out=io.StringIO())
    assert port.nround == 6
    assert history_dicts(port) == history_dicts(jax_asm)[3:]
    assert_same_state(port, jax_asm)
    assert dataclasses.asdict(port.history[-1])["nround"] == 6
