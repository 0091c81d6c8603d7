"""Vote merge: edit streams -> one packed (L, 9) int32 vote delta.

Port of pacbioassembly_tpu/parallel/sharded.py::device_elect with the
packing of jit_elect_packed: the vectorized elect of
ConsensusRef.elect (ref_seq.h:25-41, 352-362) for N streams at once, as
scatter-adds into [sel (4) | sup (4) | total (1)] columns. Integer atomics
are order-free, so the delta is exact on any device. Not a Pallas kernel in
the reference; plain torch (`index_put_(accumulate=True)`) is the port.
"""

from __future__ import annotations

import torch

from ..align.types import DELETE, INSERT, MATCH


def elect_packed(
    ops: torch.Tensor,      # (N, E) uint8 edit opcodes, 0-padded
    vals: torch.Tensor,     # (N, E) uint8 b-side codes
    start: torch.Tensor,    # (N,) int32 start box index (elect pos + beg - pre)
    forward: torch.Tensor,  # (N,) bool direction
    enabled: torch.Tensor,  # (N,) bool apply this stream at all
    L: int,
) -> torch.Tensor:
    """(L, 9) int32 [sel | sup | total] delta of N edit streams."""
    ops = ops.long()
    vals = vals.long()
    adv = ((ops != INSERT) & (ops != 0)).long()
    nonins_before = torch.cumsum(adv, dim=1) - adv  # exclusive prefix
    fwd = forward[:, None]
    st = start.long()[:, None]
    idx = torch.where(fwd, st + nonins_before, st - nonins_before)
    idx = torch.where(fwd & (ops == INSERT), idx - 1, idx)
    live = enabled[:, None] & (ops != 0)
    idx = idx.clamp(0, L - 1)

    is_m = live & (ops == MATCH)
    is_d = live & (ops == DELETE)
    is_i = live & (ops == INSERT)
    rows = torch.cat([idx.reshape(-1)] * 3)
    cols = torch.cat([vals.reshape(-1), 4 + vals.reshape(-1), torch.full_like(vals.reshape(-1), 8)])
    add = torch.cat([is_m.reshape(-1), is_i.reshape(-1), (is_m | is_d).reshape(-1)]).to(torch.int32)
    delta = torch.zeros((L, 9), dtype=torch.int32, device=ops.device)
    delta.index_put_((rows, cols), add, accumulate=True)
    return delta
