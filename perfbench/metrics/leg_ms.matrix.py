"""leg_ms.matrix: device ms of the tick's matrix leg: the mean, over the
marked ticks of a ``--trace 1`` run, of the interval between the CUDA
events the tick's ``mark`` hook records before and after it."""


def read(run: dict):
    ms = run["legs"].get("matrix")
    return sum(ms) / len(ms) if ms else None
