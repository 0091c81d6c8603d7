"""expand_ms: candidate expansion (assemble/batch.py::expand_candidates), in ms a round over the window (phase_s["expand_s"])."""

from portbench.readings import ms_per_round


def read(readings: dict):
    return ms_per_round(readings, "expand_s")
