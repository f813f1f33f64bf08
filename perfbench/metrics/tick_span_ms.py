"""tick_span_ms: host ms of the serving tick's root span ``storm.tick``
(``time.perf_counter_ns`` at the tick's entry and exit, inside the
benchmark's own clock around the call that ``host_tick_ms`` reads): the
mean over the ticks of a ``--trace 1`` run that no profiler recorded."""

from perfbench.metrics._spans import mean


def read(run: dict):
    return mean("span_ns", 1e-6)
