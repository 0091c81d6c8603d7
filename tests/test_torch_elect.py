"""Port: the packed vote delta (pacbioassembly_tpu_torch/consensus/
elect.py) against the JAX device elect (parallel/sharded.py::
jit_elect_packed) and the serial host elect (ConsensusRef.elect). Integer
sums, exact."""

import numpy as np
import pytest
import torch

from pacbioassembly_tpu.consensus import ConsensusRef
from pacbioassembly_tpu.parallel.sharded import jit_elect_packed
from pacbioassembly_tpu_torch.consensus.elect import elect_packed

from test_sharding import _random_edit_streams
from torch_parity import T

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [7, 8])
def test_elect_packed_matches_jax_and_serial(seed):
    rng = np.random.default_rng(seed)
    L, E, N = 200, 24, 32
    ops, vals, start, forward = _random_edit_streams(rng, N, L, E)
    enabled = rng.integers(0, 2, N).astype(bool)

    got = elect_packed(T(ops), T(vals), T(start), T(forward), T(enabled), L).numpy()
    want_jax = np.asarray(jit_elect_packed(L)(ops, vals, start, forward, enabled))
    np.testing.assert_array_equal(got, want_jax)

    ref = ConsensusRef(np.zeros(L, np.uint8), capacity=3 * L)
    sel0 = ref.sel[ref.pre : ref.post].copy()
    sup0 = ref.sup[ref.pre : ref.post].copy()
    tot0 = ref.total[ref.pre : ref.post].copy()
    for i in np.nonzero(enabled)[0]:
        ne = int((ops[i] != 0).sum())
        ref.elect(int(start[i]), ops[i, :ne], vals[i, :ne], bool(forward[i]))
    np.testing.assert_array_equal(got[:, 0:4], ref.sel[ref.pre : ref.post] - sel0)
    np.testing.assert_array_equal(got[:, 4:8], ref.sup[ref.pre : ref.post] - sup0)
    np.testing.assert_array_equal(got[:, 8], ref.total[ref.pre : ref.post] - tot0)
