"""lookup_ms: the host seed lookup of candidate expansion (SeedIndex.lookup_batch), in ms a round over the window (phase_s["lookup_s"])."""

from portbench.readings import ms_per_round


def read(readings: dict):
    return ms_per_round(readings, "lookup_s")
