"""host_read_wait_ms: host ms a serving tick waits in its device-to-host
reads (the ``storm.host_read`` spans of the tick's ``host_read`` helper,
which wait for the device to reach each read): the mean over the ticks of
a ``--trace 1`` run that no profiler recorded, summed over a tick's
reads."""

from perfbench.metrics._spans import mean


def read(run: dict):
    return mean("host_read_ns", 1e-6)
