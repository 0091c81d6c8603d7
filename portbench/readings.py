"""What the per-layer readers (portbench/metrics/<name>.py) share.

The readings an entry returns: `phases` (each window round's phase
seconds, as the program reports them in phase_s), `checkpoint_s` (the
benchmark's own span around each save), `round_s` (each window round's
seconds, its save included), `trace` (harness.read_trace of
the window) and `least_s` (each kernel class's least time over the
window's launches, reference/bound.py). A reader returns None where it
finds nothing to read.
"""


def ms_per_round(readings: dict, key: str):
    """A phase's total over the window's rounds, in ms a round."""
    rounds = readings.get("phases") or []
    if not rounds:
        return None
    return 1000.0 * sum(p.get(key, 0.0) for p in rounds) / len(rounds)


def idle_pct(readings: dict):
    """The share of the window in which no kernel, copy or memset ran."""
    tr = readings.get("trace")
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline_pct(readings: dict, kernel: str):
    """The kernel's least time over its device time in the trace."""
    tr = readings.get("trace")
    least = (readings.get("least_s") or {}).get(kernel)
    spent = (tr or {}).get("kernel_s", {}).get(kernel, 0.0)
    if not least or spent <= 0:
        return None
    return 100.0 * least / spent
