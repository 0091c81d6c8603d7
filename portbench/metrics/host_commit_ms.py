"""host_commit_ms: the host aligner's commits (native/pbcore), in ms a round over the window (phase_s["host_commit_s"])."""

from portbench.readings import ms_per_round


def read(readings: dict):
    return ms_per_round(readings, "host_commit_s")
