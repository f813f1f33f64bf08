"""The served path's own stage records: the ``StageLedger`` records the
``StormController`` keeps of its rounds (``storm.ledger.records()``, one a
round: each stage's host ns), over the window's rounds that no profiler
recorded. A run that kept none reads as none."""

from __future__ import annotations

import statistics


def p50_ms(run: dict, *stages: str):
    """The median over those rounds of the sum of ``stages``, in ms, or
    None without any."""
    records = run.get("stages")
    if not records:
        return None
    return statistics.median(sum(r[s] for s in stages)
                             for r in records) / 1e6
