"""checkpoint_ms.rate: checkpoint_ms (ms a save, the benchmark's own span around each
save of the window) in the cells where round_s_p90 is not end to end, so that the saves
move assembled_reads_per_s there."""

from portbench import harness

read = harness.load_module("metrics", "checkpoint_ms").read
