"""checkpoint_write_ms: the file of a checkpoint save (np.savez_compressed), in ms a save over the window (span checkpoint.write per checkpoint.save)."""

from portbench.spans import span_ms


def read(readings: dict):
    return span_ms(readings, "checkpoint.write", per="checkpoint.save")
