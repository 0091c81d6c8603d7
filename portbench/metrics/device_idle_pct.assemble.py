"""device_idle_pct.assemble: the share of the window in which the card ran nothing (profiler trace)."""

from portbench.readings import idle_pct


def read(readings: dict):
    return idle_pct(readings)
