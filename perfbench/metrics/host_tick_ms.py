"""host_tick_ms: host ms a tick spends inside the serving tick call (the
launches it enqueues and the block ladder's read of its flags), the mean
over the window's ticks of the benchmark's own clock around each call."""


def read(run: dict):
    spans = run["host_tick_s"]
    return 1e3 * sum(spans) / len(spans) if spans else None
