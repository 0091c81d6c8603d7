"""locate_score_ms: the copies, the screening kernel and the fetch of a map_reads call's chunks, in ms a call over the window (spans locate.score)."""

from portbench.spans import span_ms


def read(readings: dict):
    return span_ms(readings, "locate.score", per="locate.map_reads")
