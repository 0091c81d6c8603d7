"""evolve_ms: the evolve of the consensus (consensus/state.py), in ms a round over the window (phase_s["evolve_s"])."""

from portbench.readings import ms_per_round


def read(readings: dict):
    return ms_per_round(readings, "evolve_s")
