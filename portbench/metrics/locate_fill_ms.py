"""locate_fill_ms: the host a/b matrices of a map_reads call's chunks, in ms a call over the window (spans locate.fill)."""

from portbench.spans import span_ms


def read(readings: dict):
    return span_ms(readings, "locate.fill", per="locate.map_reads")
