"""Spans and counters inside the all-family serving tick
(``server/storm.py`` ``_mixed_tick``), on for a tick exactly when its
caller passes a ``mark`` hook.

A traced tick is a root span ``storm.tick`` carrying a process-wide tick
id, and one child span per leg in tick order — ``storm.deli``,
``storm.map``, ``storm.text``, ``storm.rebalance``, ``storm.matrix``,
``storm.tree`` — each opened where its leg begins and closed where the
tick calls ``mark(leg)``. Every device-to-host read the tick makes goes
through :func:`host_read`, which counts it and times the host's wait as a
``storm.host_read`` span inside the leg it sits in.

Each span takes ``time.perf_counter_ns()`` at both ends and, while a
``torch.profiler`` records, is also a profiler range (a
``record_function`` range whose argument is the tick id, which the
profiler keeps as the range's input when it records shapes), so in a
profile the legs lie on the host timeline that shares a clock with the
device's activity. (Without a profiler a range is seen by nothing, and
opening one costs about as much as the rest of a span.)

:class:`profiler_range` is such a range alone, for work outside the
tick and off its thread: the group-commit WAL writer's ``wal.write`` and
``wal.fsync`` (``server/durable_store.py``) and the serving thread's
``storm.durable_drain`` (``server/storm.py``). It keeps no record of its
own; the WAL writer counts its batches itself.

Each traced tick's record goes into :data:`LEDGER`, a
:class:`~.metrics.StageLedger` whose stages are the legs (host ns) and
whose further fields are the tick's start (``start_ns``, on
``perf_counter_ns``), its root span (``span_ns``), ``host_reads``,
``host_read_ns`` and ``profiled`` (1 when a ``torch.profiler`` was
recording). An untraced tick (:data:`OFF`) records nothing, opens no
range and reads no clock.
"""

from __future__ import annotations

import itertools
import threading
from time import perf_counter_ns

import torch

from .metrics import StageLedger

#: The tick's legs, in the order it runs them.
LEGS = ("deli", "map", "text", "rebalance", "matrix", "tree")
#: The traced ticks' records: one a tick, the legs' host ns as stages.
LEDGER = StageLedger(LEGS, prefix="storm.leg", capacity=4096,
                     fields=("start_ns", "span_ns", "host_reads",
                             "host_read_ns", "profiled"))

_ids = itertools.count()
_enter = torch.autograd._record_function_with_args_enter
_exit = torch.autograd._record_function_with_args_exit


class _Active(threading.local):
    tick = None


_active = _Active()


class TickSpans:
    """One traced tick: ``with spans:`` is its root span, ``with
    spans.leg(name):`` one leg, closed by the caller's ``mark(name)``."""

    def __init__(self, mark) -> None:
        self.mark = mark
        self.id = next(_ids)
        self.splits: dict = {}
        self.reads = 0
        self.read_ns = 0

    def __enter__(self) -> "TickSpans":
        self.profiled = torch._C._autograd._profiler_enabled()
        _active.tick = self
        self._range = _enter("storm.tick", self.id) if self.profiled \
            else None
        self.start = perf_counter_ns()
        return self

    def __exit__(self, exc_type, _exc, _tb) -> None:
        span_ns = perf_counter_ns() - self.start
        if self._range is not None:
            _exit(self._range)
        _active.tick = None
        if exc_type is None:
            LEDGER.record(self.id, 0, 0, 0, self.splits, fields=dict(
                start_ns=self.start, span_ns=span_ns,
                host_reads=self.reads, host_read_ns=self.read_ns,
                profiled=int(self.profiled)))

    def leg(self, name: str) -> "_Leg":
        return _Leg(self, name)

    def read(self, read):
        handle = _enter("storm.host_read", self.id) if self.profiled \
            else None
        t0 = perf_counter_ns()
        try:
            return read()
        finally:
            self.read_ns += perf_counter_ns() - t0
            self.reads += 1
            if handle is not None:
                _exit(handle)


class _Leg:
    """One leg's span; its end calls the tick's ``mark(name)``."""

    __slots__ = ("spans", "name", "handle", "t0")

    def __init__(self, spans: TickSpans, name: str) -> None:
        self.spans, self.name = spans, name

    def __enter__(self) -> None:
        spans = self.spans
        self.handle = _enter(f"storm.{self.name}", spans.id) \
            if spans.profiled else None
        self.t0 = perf_counter_ns()

    def __exit__(self, exc_type, _exc, _tb) -> None:
        if exc_type is not None:
            return
        spans = self.spans
        spans.mark(self.name)
        spans.splits[self.name] = perf_counter_ns() - self.t0
        if self.handle is not None:
            _exit(self.handle)


class _Off:
    """The untraced tick: its root and each leg is this empty context."""

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *_exc) -> None:
        return None

    def leg(self, _name: str) -> "_Off":
        return self


OFF = _Off()


class profiler_range:
    """``with profiler_range(name, arg):`` — a ``record_function`` range
    named ``name`` with argument ``arg``, opened only while a
    ``torch.profiler`` records anywhere in the process. Unlike the tick's
    spans it may run on any thread: a profile taken with
    ``profile_all_threads`` sees the ranges of threads it did not start
    in (the group-commit WAL's writer), where the thread's own profiler
    flag reads false."""

    __slots__ = ("name", "arg", "handle")

    def __init__(self, name: str, arg: int) -> None:
        self.name, self.arg = name, arg

    def __enter__(self) -> None:
        self.handle = _enter(self.name, self.arg) \
            if torch.autograd.profiler._is_profiler_enabled else None

    def __exit__(self, *_exc) -> None:
        if self.handle is not None:
            _exit(self.handle)


def tick_spans(mark) -> "TickSpans | _Off":
    """The tick's spans: traced exactly when the caller passes ``mark``."""
    return OFF if mark is None else TickSpans(mark)


def host_read(read):
    """``read()`` — a zero-argument call that makes the device hand the
    host a value and so waits for it (``t.cpu``, ``t.item``,
    ``t.nonzero``) — counted and timed inside a traced tick."""
    tick = _active.tick
    if tick is None:
        return read()
    return tick.read(read)
