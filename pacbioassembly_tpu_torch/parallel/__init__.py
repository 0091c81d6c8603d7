"""Multi-device round: the dp mesh (mesh.py) and the sharded screen and
summed elect (sharded.py); the port of pacbioassembly_tpu/parallel/."""

from .mesh import Mesh, initialize_multihost, make_mesh
from .sharded import (
    VoteDelta,
    assembly_step,
    device_elect,
    sharded_elect,
    sharded_elect_packed,
    sharded_screen,
)

__all__ = [
    "Mesh",
    "VoteDelta",
    "assembly_step",
    "device_elect",
    "initialize_multihost",
    "make_mesh",
    "sharded_elect",
    "sharded_elect_packed",
    "sharded_screen",
]
