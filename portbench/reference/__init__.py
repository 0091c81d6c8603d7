"""The benchmark's plain reference and yardstick.

Plain numpy and PyTorch, independent of the program under test: it imports
neither the JAX package nor anything of the port, and works out again
from the generated inputs whatever the program derived from them.

  store       the read-store generator (the model of tools/simulate.py)
  rowdp       the banded screening DP        traceback  parent plane + walk
  aligner     the host aligner               consensus  votes, evolve, retreat
  engine      one round of the batch engine, replayed from a snapshot
  locate      the read locator               bound      least work and the card's peaks
"""
