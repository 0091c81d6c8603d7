"""locate_triples_ms: the probe triples of a map_reads call and their lengths, in ms a call over the window (span locate.triples)."""

from portbench.spans import span_ms


def read(readings: dict):
    return span_ms(readings, "locate.triples", per="locate.map_reads")
