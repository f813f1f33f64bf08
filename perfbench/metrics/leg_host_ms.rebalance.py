"""leg_host_ms.rebalance: host ms of the tick's rebalance leg, from its span
``storm.rebalance`` (``time.perf_counter_ns`` where the leg begins and where
the tick calls its ``mark``): the mean over the ticks of a
``--trace 1`` run that no profiler recorded and that ran the leg."""

from perfbench.metrics._spans import mean


def read(run: dict):
    return mean("rebalance", 1e-6, ran_only=True)
