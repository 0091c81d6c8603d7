"""seedmap_ms: the seed index of the consensus's ends (index/seedmap.py::build_seedmap), in ms a round over the window (phase_s["seedmap_s"])."""

from portbench.readings import ms_per_round


def read(readings: dict):
    return ms_per_round(readings, "seedmap_s")
