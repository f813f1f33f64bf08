"""The serving tick's own spans and counters: the records the program
keeps of its traced ticks (``fluidframework_tpu_torch/utils/tick_spans.py``,
one a tick: each leg's host ns, the root span's, the host reads and their
wait), over the ticks of a ``--trace 1`` run that no profiler recorded.
A program that keeps no such records reads as none."""

from __future__ import annotations


def ticks() -> list:
    """The records of the ticks traced while no profiler was recording."""
    try:
        import fluidframework_tpu_torch.utils.tick_spans as tick_spans
    except ImportError:
        return []
    return [r for r in tick_spans.LEDGER.records() if not r["profiled"]]


def mean(field: str, scale: float = 1.0, ran_only: bool = False):
    """The mean of ``field`` over those ticks, times ``scale`` (with
    ``ran_only``, over the ticks in which it is above 0: the ticks that ran
    a leg), or None without any."""
    values = [r[field] for r in ticks()]
    if ran_only:
        values = [v for v in values if v > 0]
    return scale * sum(values) / len(values) if values else None
