"""locate_triples_per_read: the triples a map_reads call scores per read it processes (the counts
of the spans locate.triples over those of locate.map_reads): the work the batched locator scores
where the reference stops at a read's first success."""

from portbench.spans import span_n


def read(readings: dict):
    triples, reads = span_n(readings, "locate.triples"), span_n(readings, "locate.map_reads")
    return triples / reads if triples is not None and reads else None
