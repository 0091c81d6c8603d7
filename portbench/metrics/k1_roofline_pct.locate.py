"""k1_roofline_pct.locate: K1's least time (reference/bound.py) over its device time in the window."""

from portbench.readings import roofline_pct


def read(readings: dict):
    return roofline_pct(readings, "K1")
