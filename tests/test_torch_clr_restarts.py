"""Port: the multi-contig path of the whole-genome runs in the 15% CLR
regime, scaled down, against the JAX package on the CPU: on tests/
torch_clr.py's store, `assemble_contigs` with stall recovery on (RESTARTS:
the runs' --edge-retreat, --retreat-bite, --retreat-min-len and
--retreat-fruitless scaled to 25 kb), 3 contigs sharing the trial cache,
then the containment dedupe and the surviving reads classified against the
kept contigs (`classify_reads` at the config's ratio, as benchmarks/
ecoli_scale.py calls it), each equal to the JAX package's. The JAX engine is
pinned to one CPU device and keeps each engine's reference alive (its
builder keys its window cache on id(ref), tests/torch_contigs.py)."""

import io

import jax
import numpy as np
import pytest
import torch

from torch_clr import MIN_CONTIG, RESTART_ROUNDS, RESTARTS, SEEDS, write_clr_store
from torch_jax_native import jax_native_loader  # noqa: F401  (builds the JAX library aside)
from torch_slice import port_config, port_reads

torch.set_num_threads(1)

N_CONTIGS = 3


def test_clr_restarts_dedupe_and_accounting_equal_jax(tmp_path, monkeypatch):
    from pacbioassembly_tpu.assemble import ReadStore as JaxReads
    from pacbioassembly_tpu.assemble.batch import BatchAssembler as JaxAssembler
    from pacbioassembly_tpu.assemble.batch import assemble_contigs as jax_assemble_contigs
    from pacbioassembly_tpu.config import AssemblyConfig
    from pacbioassembly_tpu.tools import postprocess as jax_post
    from pacbioassembly_tpu_torch.assemble.batch import assemble_contigs
    from pacbioassembly_tpu_torch.codec import dna
    from pacbioassembly_tpu_torch.tools import postprocess

    dev0 = jax.devices()[0]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev0])
    store = write_clr_store(tmp_path)
    patterns = dna.load_patterns(SEEDS)
    cfg = AssemblyConfig(**RESTARTS)
    pcfg = port_config(cfg)
    jreads, preads = JaxReads.from_file(store, cfg), port_reads(store, pcfg)
    kept_refs = []
    real_init = JaxAssembler.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        kept_refs.append(self.ref)

    jlog, plog = io.StringIO(), io.StringIO()
    with monkeypatch.context() as mp:
        mp.setattr(JaxAssembler, "__init__", init)
        want, want_surv = jax_assemble_contigs(cfg, jreads, patterns, N_CONTIGS, log=jlog,
                                               dedupe=False)
    got, got_surv = assemble_contigs(pcfg, preads, patterns, N_CONTIGS, log=plog,
                                     dedupe=False, device="cpu")
    assert [(c.codes.tolist(), c.nreads, c.nrounds) for c in got] == [
        (c.codes.tolist(), c.nreads, c.nrounds) for c in want]
    assert got_surv == want_surv and plog.getvalue() == jlog.getvalue()
    assert [c.nrounds for c in got] == [RESTART_ROUNDS] * N_CONTIGS and got_surv

    codes = [c.codes for c in got]
    kept, dropped = postprocess.dedupe_contigs(codes)
    assert (kept, dropped) == jax_post.dedupe_contigs(codes)
    kept_codes = [codes[i] for i in kept]
    acc = postprocess.classify_reads(kept_codes, [preads.codes(i) for i in got_surv],
                                     patterns[0], pcfg.ratio, MIN_CONTIG, device="cpu")
    jacc = jax_post.classify_reads(kept_codes, [jreads.codes(i) for i in want_surv],
                                   patterns[0], cfg.ratio, MIN_CONTIG)
    np.testing.assert_array_equal(acc.pop("categories"), jacc.pop("categories"))
    assert acc == jacc
    # every category the whole-genome run counts is reached but too_short
    assert acc["total"] == len(got_surv)
    assert min(acc["mapped"], acc["seeded_only"], acc["unseedable"]) > 0
