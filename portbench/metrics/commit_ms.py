"""commit_ms: the commit: K2 + W, the host aligner, the elect (batch.py::commit), in ms a round over the window (phase_s["commit_s"])."""

from portbench.readings import ms_per_round


def read(readings: dict):
    return ms_per_round(readings, "commit_s")
