"""The readers of the serving tick's own spans and counters
(``perfbench/metrics/_spans.py`` and the metrics on it), on a ledger built
by hand in the program's place: each gives the mean over the ticks no
profiler recorded, and None where there are none or the program keeps no
such ledger."""

from __future__ import annotations

import sys

import pytest

from perfbench.harness.bench import read_metric

#: metric: (the record field it reads, its scale).
READERS = {**{f"leg_host_ms.{leg}": (leg, 1e-6)
              for leg in ("deli", "map", "text", "rebalance", "matrix",
                          "tree")},
           "tick_span_ms": ("span_ns", 1e-6),
           "host_reads_per_tick": ("host_reads", 1.0),
           "host_read_wait_ms": ("host_read_ns", 1e-6)}


@pytest.fixture
def ledger(monkeypatch):
    """An empty ledger of the program's shape, in the program's place."""
    from fluidframework_tpu_torch.utils import tick_spans
    from fluidframework_tpu_torch.utils.metrics import StageLedger
    led = StageLedger(tick_spans.LEGS, fields=tick_spans.LEDGER.fields)
    monkeypatch.setattr(tick_spans, "LEDGER", led)
    return led


def _record(led, tick, value, profiled, ran=True):
    legs = {leg: value for leg in ("deli", "map", "text", "rebalance",
                                   "matrix", "tree")} if ran else {}
    led.record(tick, 0, 0, 0, legs, fields=dict(
        start_ns=tick, span_ns=value, host_reads=value,
        host_read_ns=value, profiled=profiled))


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_means_the_unprofiled_ticks(name, ledger):
    field, scale = READERS[name]
    assert read_metric(name, {}) is None
    for tick, (value, profiled) in enumerate(
            [(2_000_000, 0), (4_000_000, 0), (90_000_000, 1),
             (6_000_000, 0)]):
        _record(ledger, tick, value, profiled)
    assert read_metric(name, {}) == pytest.approx(4_000_000 * scale)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_without_unprofiled_ticks_or_the_ledger(name, ledger,
                                                       monkeypatch):
    _record(ledger, 0, 5_000_000, 1)
    assert read_metric(name, {}) is None
    monkeypatch.setitem(sys.modules,
                        "fluidframework_tpu_torch.utils.tick_spans", None)
    _record(ledger, 1, 5_000_000, 0)
    assert read_metric(name, {}) is None


@pytest.mark.parametrize("leg", ["matrix", "tree"])
def test_leg_reader_leaves_out_ticks_without_the_leg(leg, ledger):
    _record(ledger, 0, 3_000_000, 0)
    _record(ledger, 1, 5_000_000, 0, ran=False)
    assert read_metric(f"leg_host_ms.{leg}", {}) == pytest.approx(3.0)
    assert read_metric("tick_span_ms", {}) == pytest.approx(4.0)
