"""leg_host_ms.map: host ms of the tick's map leg, from its span
``storm.map`` (``time.perf_counter_ns`` where the leg begins and where
the tick calls its ``mark``): the mean over the ticks of a
``--trace 1`` run that no profiler recorded and that ran the leg."""

from perfbench.metrics._spans import mean


def read(run: dict):
    return mean("map", 1e-6, ran_only=True)
