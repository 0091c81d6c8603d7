"""Device spaced-seed index: the boundary seed table built and searched on
a device.

Port of pacbioassembly_tpu/index/device.py. The seeds of every boundary
window are made by vector gathers and shifts, masked, sorted on the device
and queried with a vectorized binary search. Equal to the host CSR table
(index/seedmap.py): the same keys and positions, and inside a key the
host's insertion order (head ascending, then tail descending), kept by a
stable sort (tests/test_torch_device_twins.py).

torch has no usable uint32 arithmetic, so the 32-bit keys live in int64
lanes, masked to 32 bits. Dead windows (past the window, or a masked seed
of 0: the poly-A skip) take the key 0, which no live key can have: the
padding sorts first, and a query of 0 finds nothing. Runs on whichever
device its inputs are on.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..codec.dna import SEED_LEN, SEED_SHIFTS
from ..config import Constants
from .seedmap import SeedIndex

MASK32 = 0xFFFFFFFF


class DeviceSeedIndex(NamedTuple):
    keys: torch.Tensor       # (N,) int64 32-bit keys, sorted (stable within a key); pad = 0
    positions: torch.Tensor  # (N,) int32
    n_entries: torch.Tensor  # () int32: live entries (the pads sort first)


def device_seeds(codes: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """32-bit seeds (in int64) of the 16-mers at `positions`."""
    shifts = torch.from_numpy(SEED_SHIFTS.astype(np.int64)).to(codes.device)
    idx = positions.long()[:, None] + torch.arange(SEED_LEN, device=codes.device)[None, :]
    window = codes[idx.clamp(0, codes.shape[0] - 1)].long()
    return (window << shifts[None, :]).sum(dim=1) & MASK32


def device_build_seedmap(
    codes: torch.Tensor,
    length: int,
    mask: int,
    max_read_len: int = Constants.MAX_READ_LEN,
) -> DeviceSeedIndex:
    """Boundary seed index of a (padded) reference window.

    codes: (L_pad,) uint8 reference codes, valid prefix `length`. Window
    semantics match ref_seq::get_seedmap (head ascending + tail
    descending, poly-A skip)."""
    dev = codes.device
    L_pad = codes.shape[0]
    cap = min(L_pad, max_read_len)
    length = int(length)
    mask = int(mask) & MASK32

    t = torch.arange(cap, dtype=torch.int64, device=dev)
    nhead = min(length - SEED_LEN, max_read_len)
    ntail = min(length - max_read_len - SEED_LEN, max_read_len)
    tail_pos = length - SEED_LEN - t
    positions = torch.cat([t, tail_pos])
    valid = torch.cat([t < nhead, t < ntail]) & (positions >= 0)

    seeds = device_seeds(codes, positions) & mask
    live = valid & (seeds != 0)
    # live keys are never 0 (the poly-A skip), so 0 is a safe padding
    # sentinel that sorts first and cannot collide with a genuine key
    keys = torch.where(live, seeds, torch.zeros_like(seeds))

    # a stable sort by key keeps the insertion (head-then-tail) bucket order
    order = torch.sort(keys, stable=True).indices
    return DeviceSeedIndex(
        keys=keys[order],
        positions=positions[order].to(torch.int32),
        n_entries=live.sum().to(torch.int32),
    )


def device_index(index: SeedIndex, device: torch.device) -> DeviceSeedIndex:
    """A host SeedIndex's sorted keys and positions on `device`. The host
    table holds no key 0 (build_seedmap drops the poly-A seeds), so every
    entry is live and none is padding."""
    keys = torch.from_numpy(index.keys.astype(np.int64)).to(device)
    positions = torch.from_numpy(np.asarray(index.positions, np.int32)).to(device)
    n_entries = torch.tensor(index.n_entries, dtype=torch.int32, device=device)
    return DeviceSeedIndex(keys, positions, n_entries)


def device_lookup(index: DeviceSeedIndex, queries: torch.Tensor):
    """(starts, counts) int32 for a batch of masked 32-bit queries (a
    tensor, or a numpy array of uint32)."""
    if not isinstance(queries, torch.Tensor):
        queries = torch.from_numpy(np.asarray(queries, dtype=np.int64))
    q = queries.to(index.keys.device).long() & MASK32
    lo = torch.searchsorted(index.keys, q, side="left")
    hi = torch.searchsorted(index.keys, q, side="right")
    cnt = torch.where(q == 0, torch.zeros_like(lo), hi - lo)  # key 0 is padding
    return lo.to(torch.int32), cnt.to(torch.int32)
