"""round_s_p90.rate: the 90th percentile of the window's round times, each round whole
with its checkpoint save, as the end-to-end round_s_p90 takes it; read per layer in the
cells whose rounds spread too widely from run to run to hold that tail to a bound."""

import numpy as np


def read(readings: dict):
    times = readings.get("round_s") or []
    return float(np.percentile(times, 90)) if times else None
