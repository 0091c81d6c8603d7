"""locate_index_ms: the whole-contig seed index of a map_reads call (build_seedmap), in ms a call over the window (span locate.index)."""

from portbench.spans import span_ms


def read(readings: dict):
    return span_ms(readings, "locate.index", per="locate.map_reads")
