"""Sharded screening and summed vote merge over a 1-D mesh.

Port of pacbioassembly_tpu/parallel/sharded.py, the multi-device form of
one assembly round:

  * candidate alignments split into the mesh's equal contiguous shards
    ("dp"), one per mesh device; each shard is scored by the engine's
    screening kernel (align/screen.py::score_batch: K1 or K3 on a card,
    their plain row DP on the CPU). Every shard's launch is queued before
    any result is fetched, so distinct cards run at once; the results are
    concatenated in shard order;
  * the elect runs shard-locally (consensus/elect.py::elect_packed, the
    port of `device_elect`) and the int32 deltas are summed: votes are
    commutative integer sums, so the merged delta equals the serial elect
    whatever the shard order (tests/test_torch_sharding.py).

Where JAX's shard_map places a shard on each device of a jitted program,
the port launches each shard's kernels on its device; JAX's psum is a sum
on the first shard's device in one process, and an `all_reduce` across the
processes of a distributed mesh (parallel/mesh.py::initialize_multihost).
A distributed screen scores this process's shards, then `all_gather` makes
the scores whole on every process (the JAX worker's `process_allgather`).
Every process passes the whole batch and slices out its own shards.

Left out: `jit_elect` and `jit_elect_packed`, the JAX package's compile
caches of the single-device elect (PyTorch compiles nothing per shape; the
single-device elect is consensus/elect.py::elect_packed).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..align.scan import BatchScores
from ..align.screen import score_batch
from ..config import Constants
from ..consensus.elect import elect_packed
from .mesh import Mesh


class VoteDelta(NamedTuple):
    sel: torch.Tensor    # (L, 4) int32
    sup: torch.Tensor    # (L, 4) int32
    total: torch.Tensor  # (L,) int32


def _tensor(x, dtype: torch.dtype) -> torch.Tensor:
    """A numpy array or a tensor as a tensor of `dtype` (on its device)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.from_numpy(np.array(x)).to(dtype)


def _shards(mesh: Mesh, n_rows: int, *arrays):
    """Per shard of this process, the slices of `arrays` on its device:
    equal contiguous row blocks of the global batch."""
    if n_rows % mesh.size:
        raise ValueError(f"batch of {n_rows} rows does not split into {mesh.size} equal shards")
    per = n_rows // mesh.size
    for s, dev in mesh.local_shards():
        yield [x[s * per : (s + 1) * per].to(dev) for x in arrays]


def device_elect(ops, vals, start, forward, enabled, L: int) -> VoteDelta:
    """The vectorized elect of N edit streams (consensus/elect.py) as
    (sel, sup, total)."""
    d = elect_packed(ops, vals, start, forward, enabled, L)
    return VoteDelta(d[:, 0:4], d[:, 4:8], d[:, 8])


def sharded_screen(
    mesh: Mesh,
    a,
    la,
    b,
    lb,
    *,
    la_max: int,
    w_max: int,
    ratio: float = Constants.MAXR,
    screen_kernel: str = "bitwave",
) -> BatchScores:
    """Screen a batch split over the mesh; the batch size must be a
    multiple of the mesh size. Returns the whole batch's BatchScores on
    the mesh's first (local) device."""
    args = (_tensor(a, torch.uint8), _tensor(la, torch.int32),
            _tensor(b, torch.uint8), _tensor(lb, torch.int32))
    # queue every shard's launch before any result is fetched
    parts = []
    for x in _shards(mesh, len(args[1]), *args):
        parts.append(score_batch(*x, screen_kernel=screen_kernel, kind="fullscreen",
                                 la_max=la_max, w_max=w_max, ratio=ratio))
    first = mesh.first
    packed = torch.cat([torch.stack([f.to(torch.int32) for f in p]).to(first) for p in parts], 1)
    if mesh.world_size > 1:
        import torch.distributed as dist

        mine = packed.cpu()
        every = [torch.empty_like(mine) for _ in range(mesh.world_size)]
        dist.all_gather(every, mine, group=mesh.group)
        packed = torch.cat(every, 1).to(first)
    return BatchScores(packed[0] != 0, *packed[1:])


def sharded_elect_packed(mesh: Mesh, ops, vals, start, forward, enabled, L: int) -> torch.Tensor:
    """Apply sharded edit streams and sum the (L, 9) int32 [sel | sup |
    total] deltas over the mesh; equal to the serial elect. The stream
    count must be a multiple of the mesh size. Returned on the mesh's first
    (local) device, the same on every process."""
    args = (_tensor(ops, torch.uint8), _tensor(vals, torch.uint8), _tensor(start, torch.int32),
            _tensor(forward, torch.bool), _tensor(enabled, torch.bool))
    first = mesh.first
    deltas = [elect_packed(*x, L) for x in _shards(mesh, len(args[2]), *args)]
    total = deltas[0].to(first)
    for d in deltas[1:]:
        total = total + d.to(first)
    if mesh.world_size > 1:
        import torch.distributed as dist

        summed = total.cpu()
        dist.all_reduce(summed, group=mesh.group)
        total = summed.to(first)
    return total


def sharded_elect(mesh: Mesh, ops, vals, start, forward, enabled, L: int) -> VoteDelta:
    """sharded_elect_packed as (sel, sup, total)."""
    d = sharded_elect_packed(mesh, ops, vals, start, forward, enabled, L)
    return VoteDelta(d[:, 0:4], d[:, 4:8], d[:, 8])


def assembly_step(
    mesh: Mesh,
    a,
    la,
    b,
    lb,
    ops,
    vals,
    start,
    forward,
    *,
    la_max: int,
    w_max: int,
    L: int,
    ratio: float = Constants.MAXR,
    overlap_min: int = Constants.OVERLAP_MIN,
    screen_kernel: str = "bitwave",
):
    """One multi-device assembly step: the sharded screen, then the
    sharded elect of the streams whose candidates it accepted (accept and
    matlen_a >= overlap_min). Returns (scores, summed VoteDelta, accepted
    count)."""
    scores = sharded_screen(mesh, a, la, b, lb, la_max=la_max, w_max=w_max, ratio=ratio,
                            screen_kernel=screen_kernel)
    ok = scores.accept & (scores.matlen_a >= overlap_min)
    delta = sharded_elect(mesh, ops, vals, start, forward, ok, L)
    return scores, delta, int(ok.sum())
