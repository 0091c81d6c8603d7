"""screen_ms: screening, prefilter and full screen (batch.py::screen, gather, K1), in ms a round over the window (phase_s["screen_s"])."""

from portbench.readings import ms_per_round


def read(readings: dict):
    return ms_per_round(readings, "screen_s")
