"""Port: the 15% CLR regime (1:12:4 substitutions, insertions, deletions,
the error the reference's headline run assembles) against the JAX package
on the CPU, on tests/torch_clr.py's store (that of tests/test_batch.py::
test_prefilter_no_lost_accepts_high_error: 25 kb at 14x, reads 800-1,200,
seed 17) with the JAX test's engine (rng_seed 3, round-robin over
tests/data/seeds.txt, 8 rounds):

- the port's engine equals the JAX engine round for round: every RoundStats
  field, the contig bytes, votes, surviving reads and the log;
- on the engine's round-8 state, for every pattern, both packages expand
  the same candidates, and the port's screen accepts the same set with and
  without its prefilter (the JAX test's assertion, on the port).

tests/test_torch_clr_restarts.py runs the multi-contig path on the same
store. The JAX engine is pinned to one CPU device (its single-device round)
and reaches its native library built aside (tests/torch_jax_native.py)."""

import io

import jax
import numpy as np
import pytest
import torch

from torch_clr import ENGINE, SEEDS, write_clr_store
from torch_jax_native import jax_native_loader  # noqa: F401  (builds the JAX library aside)
from torch_slice import assert_same_state, history_dicts, port_config, port_reads

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return write_clr_store(tmp_path_factory.mktemp("clr"))


@pytest.fixture(scope="module")
def one_jax_device():
    dev0 = jax.devices()[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a, **k: [dev0])
        yield


def patterns():
    from pacbioassembly_tpu_torch.codec import dna

    return dna.load_patterns(SEEDS)


@pytest.fixture(scope="module")
def engines(store, one_jax_device, jax_native_loader):  # noqa: F811
    """Both engines' 8-round runs: {name: (engine, log)}."""
    from pacbioassembly_tpu.assemble import ReadStore
    from pacbioassembly_tpu.assemble.batch import BatchAssembler as JaxAssembler
    from pacbioassembly_tpu.config import AssemblyConfig
    from pacbioassembly_tpu_torch.assemble.batch import BatchAssembler

    cfg = AssemblyConfig(**ENGINE)
    pcfg = port_config(cfg)
    out = {}
    for name, asm in (
        ("jax", JaxAssembler(cfg, ReadStore.from_file(store, cfg), patterns())),
        ("port", BatchAssembler(pcfg, port_reads(store, pcfg), patterns(), device="cpu")),
    ):
        log = io.StringIO()
        asm.run(out=io.StringIO(), log=log)
        out[name] = (asm, log.getvalue())
    return out


def test_clr_engine_equals_jax(engines):
    (jax_asm, jlog), (port, plog) = engines["jax"], engines["port"]
    assert port.nround == ENGINE["max_round"]
    assert history_dicts(port) == history_dicts(jax_asm)
    assert_same_state(port, jax_asm)
    assert plog == jlog
    assert port.ref.length() > 1500 and len(port.surviving) < len(port.reads)


def test_clr_prefilter_keeps_every_accept(engines):
    """tests/test_batch.py's accept-set equality with and without the
    prefilter, on the port, over every pattern, on the JAX engine's
    candidates."""
    from pacbioassembly_tpu.assemble.batch import expand_candidates as jax_expand
    from pacbioassembly_tpu.index import build_seedmap as jax_seedmap
    from pacbioassembly_tpu_torch.assemble.batch import expand_candidates
    from pacbioassembly_tpu_torch.index import build_seedmap

    jax_asm, port = engines["jax"][0], engines["port"][0]
    n_total = n_acc = n_pf = 0
    for pattern in patterns():
        index, _ = build_seedmap(port.ref.text(), pattern)
        cands, _, _ = expand_candidates(port.reads, port.surviving, index, pattern, port.cfg,
                                        port._trial_cache)
        jindex, _ = jax_seedmap(jax_asm.ref.text(), pattern)
        jcands, _ = jax_expand(jax_asm.reads, jax_asm.surviving, jindex, pattern, jax_asm.cfg,
                               jax_asm._trial_cache)
        for f in ("read", "j", "forward", "r_offset"):
            np.testing.assert_array_equal(getattr(cands, f), getattr(jcands, f))
        if len(cands) == 0:
            continue
        port.cfg.prefilter_len = 0
        acc_off = port.screen(cands).copy()
        port.cfg.prefilter_len = 128
        port.cfg.prefilter_min_batch = 1
        acc_on = port.screen(cands).copy()
        np.testing.assert_array_equal(acc_on, acc_off)
        n_total += len(cands)
        n_acc += int(acc_off.sum())
        n_pf += port.prefilter_kept
    assert n_total >= 200, f"fixture too small ({n_total} candidates)"
    assert n_acc >= 3, "fixture must contain real 15%-error overlaps"
    assert n_acc <= n_pf < n_total, "the prefilter must have run and dropped candidates"
