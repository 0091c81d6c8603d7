"""Device mesh helpers.

Port of pacbioassembly_tpu/parallel/mesh.py. The engine's parallelism is
1-D data parallelism over candidate alignments (the "dp" axis): candidates
and edit streams split into equal contiguous shards, one per mesh device,
the reference and the read matrix stay whole, and vote deltas are summed.

A `Mesh` is an explicit tuple of torch devices. It may name one device more
than once: each entry is one shard, so `make_mesh(devices=["cpu"] * 8)`
runs the 8-shard path on the CPU (the JAX suite's 8 virtual CPU devices),
and `["cuda:0", "cuda:0"]` runs the 2-shard path on one card.

A mesh that spans processes (`initialize_multihost`) also holds the process
group, this process's rank and the world size; its devices are every
rank's local devices, rank-major. The collectives run on the gloo backend
over CPU tensors: the screen's scores and the elect's delta go to the host
anyway, and one card cannot host two NCCL ranks.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import torch

from ..device import resolve_device

# how long a collective (the join included) waits for the other processes
JOIN_TIMEOUT_S = 120


class Mesh:
    """A 1-D mesh: `devices` is the global dp axis, one entry a shard."""

    def __init__(self, devices: Sequence, *, group=None, rank: int = 0, world_size: int = 1):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len(devs) % world_size:
            raise ValueError(f"{len(devs)} devices do not split evenly over {world_size} processes")
        # this process checks its own devices only: the others' are names
        per = len(devs) // world_size
        lo = rank * per
        devs[lo : lo + per] = [resolve_device(d) for d in devs[lo : lo + per]]
        self.devices = tuple(devs)
        self.group = group
        self.rank = rank
        self.world_size = world_size

    @property
    def size(self) -> int:
        """Shards on the axis, over every process."""
        return len(self.devices)

    def local_shards(self) -> list[tuple[int, torch.device]]:
        """(global shard index, device) of this process's shards."""
        per = len(self.devices) // self.world_size
        lo = self.rank * per
        return [(lo + s, self.devices[lo + s]) for s in range(per)]

    @property
    def first(self) -> torch.device:
        """This process's first device: where sharded results are returned."""
        return self.local_shards()[0][1]

    def __repr__(self) -> str:
        procs = f", rank {self.rank} of {self.world_size}" if self.world_size > 1 else ""
        return f"Mesh(dp: {[str(d) for d in self.devices]}{procs})"


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A single-process mesh over `devices` (repeats allowed), or over
    every local GPU, cuda:0 .. cuda:N-1, as jax.devices() lists them."""
    if devices is None:
        resolve_device("cuda")  # raises without a GPU
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(devices)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Join a multi-process run (a gloo process group) and return the
    global dp mesh, ordered rank-major.

    `coordinator_address` is rank 0's "host:port"; with no arguments the
    group reads torch's env:// variables (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK). This process's shards are `devices` (repeats
    allowed), or every local GPU; every process must bring the same number.
    Call once per process, before any sharded call;
    `torch.distributed.destroy_process_group()` leaves the group."""
    import torch.distributed as dist

    if coordinator_address is None:
        init = "env://"
    else:
        init = f"tcp://{coordinator_address}"
    dist.init_process_group(
        "gloo", init_method=init,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S),
    )
    mine = make_mesh(devices=devices).devices
    world = dist.get_world_size()
    every: list = [None] * world
    dist.all_gather_object(every, [str(d) for d in mine])
    if len({len(x) for x in every}) != 1:
        raise ValueError(f"processes bring unequal shard counts: {every}")
    return Mesh([n for names in every for n in names], group=dist.group.WORLD,
                rank=dist.get_rank(), world_size=world)
