"""Read store, exact round driver and checkpoints (copies of the JAX
package's modules), and the batch engine on PyTorch (batch.py, gather.py,
imported by name)."""

from .reads import ReadStore
from .driver import Assembler, init_reference

__all__ = ["ReadStore", "Assembler", "init_reference"]
