"""Consensus state (copy of the JAX package's consensus/state.py) and the
vote merge on PyTorch (elect.py, imported by name)."""

from .state import ConsensusRef

__all__ = ["ConsensusRef"]
