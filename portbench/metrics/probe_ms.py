"""probe_ms: the index probe of candidate expansion (SeedIndex.lookup_batch), in ms a round over the window (span round.expand.probe)."""

from portbench.spans import span_ms


def read(readings: dict):
    return span_ms(readings, "round.expand.probe", per="round")
