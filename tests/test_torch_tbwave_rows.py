"""Port: the plain parent plane and walk over several 16-row blocks and
128-row windows, with the plane's rows cut short (rows_max) and a walk
buffer too small for the longest stream (the JAX walk's 32-edit block
stop rule), against the JAX Pallas kernel in interpret mode and the JAX
device walk. Bit-equal, no tolerance."""

import pytest
import torch

from test_torch_tbwave import _multi_block_cases, check_plane_and_walk

torch.set_num_threads(1)


@pytest.mark.parametrize("rows_max, E", [(None, None), (128, 70)])
def test_multi_block_plane_and_walk_match_jax(rows_max, E):
    _, goal, (ops, _, nedit) = check_plane_and_walk(
        _multi_block_cases(), 384, 384, 96, rows_max, E
    )
    assert goal[2].sum() >= 4
    if E is not None:
        assert (nedit.numpy() <= E).all() and (nedit.numpy() > E - 32).any()
