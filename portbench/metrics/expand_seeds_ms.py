"""expand_seeds_ms: the cached trial seeds' gather and mask of candidate expansion, in ms a round over the window (span round.expand.seeds); lookup_ms less this and probe_ms is the rest of the lookup."""

from portbench.spans import span_ms


def read(readings: dict):
    return span_ms(readings, "round.expand.seeds", per="round")
