"""host_align_ms: the native aligner's calls of the host commit (native/pbcore), in ms a round over the window (span round.commit.host.align); host_commit_ms less this is its glue."""

from portbench.spans import span_ms


def read(readings: dict):
    return span_ms(readings, "round.commit.host.align", per="round")
