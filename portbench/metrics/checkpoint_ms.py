"""checkpoint_ms: ms a checkpoint save (assemble/checkpoint.py::save_checkpoint), the
benchmark's own span around each save of the window."""


def read(readings: dict):
    saves = readings.get("checkpoint_s") or []
    return 1000.0 * sum(saves) / len(saves) if saves else None
