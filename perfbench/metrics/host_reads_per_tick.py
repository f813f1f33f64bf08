"""host_reads_per_tick: device-to-host reads a serving tick makes (the
block ladder's flags, and the spill's or the full rebalance's own when it
fires), counted by the tick's ``host_read`` helper: the mean over the
ticks of a ``--trace 1`` run that no profiler recorded."""

from perfbench.metrics._spans import mean


def read(run: dict):
    return mean("host_reads")
