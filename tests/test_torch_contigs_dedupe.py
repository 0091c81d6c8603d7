"""Port: multi-contig assembly with contig dedupe against the JAX package.
On the small two-segment store (tests/torch_contigs.py: one contig a
segment, then two one-read scraps) both `assemble_contigs` drop the two
scraps as contained in the segments' contigs, with equal ContigResults,
surviving reads and logs. (tests/test_torch_contigs.py runs the same
without dedupe; each file pays the JAX engine's first XLA compiles.)"""

import jax
import torch

from torch_contigs import SMALL, assemble_contigs_both, write_two_segments
from torch_jax_native import jax_native_loader  # noqa: F401  (builds the JAX library aside)

torch.set_num_threads(1)


def test_assemble_contigs_with_dedupe_matches_jax(tmp_path, monkeypatch):
    dev0 = jax.devices()[0]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev0])
    got, _ = assemble_contigs_both(write_two_segments(tmp_path, **SMALL), dedupe=True)
    assert [len(c.codes) > 3500 for c in got] == [True, True]
