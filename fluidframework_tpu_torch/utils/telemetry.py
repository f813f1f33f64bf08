"""Structured telemetry: logger hierarchy, perf spans, wall-clock traces.

Reference parity: packages/utils/telemetry-utils/src/logger.ts —
``TelemetryLogger`` (:103, namespace prefixing + property stamping),
``ChildLogger`` (:238), ``MultiSinkLogger`` (:314), ``PerformanceEvent``
(:356, start/end/cancel spans with duration); common-utils/src/trace.ts
(``Trace.trace()`` monotonic split timer); debugLogger.ts (console sink).

Events are plain dicts: {"category", "eventName", ...props}. Categories
follow the reference: "generic" | "performance" | "error".
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time
from typing import Any, Callable


class TelemetryLogger:
    """Base logger: namespace prefixing + fixed properties.

    Subclasses implement :meth:`send`. ``namespace`` prefixes every event
    name (``fluid:telemetry`` analog); ``properties`` are stamped onto every
    event (reference ``ITelemetryLoggerPropertyBags``).
    """

    EVENT_NAME_SEPARATOR = ":"

    def __init__(self, namespace: str | None = None,
                 properties: dict[str, Any] | None = None) -> None:
        self.namespace = namespace
        self.properties = dict(properties or {})

    def send(self, event: dict[str, Any]) -> None:
        raise NotImplementedError

    def _prepare(self, event: dict[str, Any]) -> dict[str, Any]:
        out = dict(self.properties)
        out.update(event)
        if self.namespace:
            out["eventName"] = (self.namespace + self.EVENT_NAME_SEPARATOR
                                + out.get("eventName", ""))
        out.setdefault("category", "generic")
        return out

    # -- convenience levels (logger.ts sendTelemetryEvent/ErrorEvent) ---------

    def send_event(self, event_name: str, **props: Any) -> None:
        self.send(self._prepare({"eventName": event_name, **props}))

    def send_error(self, event_name: str, error: BaseException | str | None
                   = None, **props: Any) -> None:
        if error is not None:
            props["error"] = repr(error) if isinstance(error, BaseException) \
                else error
        self.send(self._prepare({"eventName": event_name,
                                 "category": "error", **props}))

    def send_performance(self, event_name: str, duration_ms: float,
                         **props: Any) -> None:
        self.send(self._prepare({"eventName": event_name,
                                 "category": "performance",
                                 "duration": duration_ms, **props}))


class NullLogger(TelemetryLogger):
    """Drops everything — the default sink when the host injects none."""

    def send(self, event: dict[str, Any]) -> None:
        pass


class CollectingLogger(TelemetryLogger):
    """Buffers events in memory — the test sink."""

    def __init__(self, namespace: str | None = None,
                 properties: dict[str, Any] | None = None) -> None:
        super().__init__(namespace, properties)
        self.events: list[dict[str, Any]] = []

    def send(self, event: dict[str, Any]) -> None:
        self.events.append(event)

    def matching(self, event_name_suffix: str) -> list[dict[str, Any]]:
        return [e for e in self.events
                if e.get("eventName", "").endswith(event_name_suffix)]


class DebugLogger(TelemetryLogger):
    """Routes events to stdlib logging as single-line JSON
    (debugLogger.ts; server side mirrors winston's JSON lines)."""

    def __init__(self, namespace: str | None = None,
                 properties: dict[str, Any] | None = None,
                 logger: logging.Logger | None = None) -> None:
        super().__init__(namespace, properties)
        self._logger = logger or logging.getLogger("fluid.telemetry")

    def send(self, event: dict[str, Any]) -> None:
        level = logging.ERROR if event.get("category") == "error" \
            else logging.INFO
        self._logger.log(level, json.dumps(event, default=str))


class ChildLogger(TelemetryLogger):
    """Namespace/property extension over a parent sink (logger.ts:238)."""

    def __init__(self, parent: TelemetryLogger, namespace: str | None = None,
                 properties: dict[str, Any] | None = None) -> None:
        combined = (parent.namespace + TelemetryLogger.EVENT_NAME_SEPARATOR
                    + namespace) if parent.namespace and namespace \
            else (namespace or parent.namespace)
        props = dict(parent.properties)
        props.update(properties or {})
        super().__init__(combined, props)
        self._parent = parent

    @staticmethod
    def create(parent: TelemetryLogger | None, namespace: str | None = None,
               properties: dict[str, Any] | None = None) -> "ChildLogger":
        return ChildLogger(parent or NullLogger(), namespace, properties)

    def send(self, event: dict[str, Any]) -> None:
        # Namespace/props were already applied by _prepare on this logger;
        # forward raw to the root sink.
        self._parent.send(event)


class MultiSinkLogger(TelemetryLogger):
    """Broadcasts every event to several sinks (logger.ts:314)."""

    def __init__(self, sinks: list[TelemetryLogger] | None = None) -> None:
        super().__init__()
        self.sinks = list(sinks or [])

    def add_sink(self, sink: TelemetryLogger) -> None:
        self.sinks.append(sink)

    def send(self, event: dict[str, Any]) -> None:
        for sink in self.sinks:
            sink.send(event)


class PerfTrace:
    """Monotonic split timer (common-utils trace.ts ``Trace``): ``trace()``
    returns (total_ms, since_last_ms) and resets the split point."""

    def __init__(self) -> None:
        self._start = time.perf_counter()
        self._last = self._start

    def trace(self) -> tuple[float, float]:
        now = time.perf_counter()
        total = (now - self._start) * 1000.0
        split = (now - self._last) * 1000.0
        self._last = now
        return total, split


class PerformanceEvent:
    """Telemetry span: emits <name>_start / <name>_end / <name>_cancel with
    duration (logger.ts:356). Usable as a context manager — exceptions emit
    cancel and re-raise, mirroring ``PerformanceEvent.timedExec``."""

    def __init__(self, logger: TelemetryLogger, event_name: str,
                 emit_start: bool = False, **props: Any) -> None:
        self._logger = logger
        self._name = event_name
        self._props = props
        self._trace = PerfTrace()
        self._done = False
        if emit_start:
            logger.send_event(f"{event_name}_start", **props)

    def report_progress(self, event_name_suffix: str, **props: Any) -> None:
        total, split = self._trace.trace()
        self._logger.send_performance(
            f"{self._name}_{event_name_suffix}", split,
            **{**self._props, **props})

    def end(self, **props: Any) -> None:
        if self._done:
            return
        self._done = True
        total, _ = self._trace.trace()
        self._logger.send_performance(f"{self._name}_end", total,
                                      **{**self._props, **props})

    def cancel(self, error: BaseException | None = None, **props: Any) -> None:
        if self._done:
            return
        self._done = True
        total, _ = self._trace.trace()
        if error is not None:
            props["error"] = repr(error)
        self._logger.send_performance(f"{self._name}_cancel", total,
                                      **{**self._props, **props})

    def __enter__(self) -> "PerformanceEvent":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.cancel(exc)
        else:
            self.end()


class TraceSpans:
    """Per-op distributed-trace joiner (connectionTelemetry.ts op
    round-trip spans, generalized to the storm path): sampled frames
    carry a trace id; each hop that touches the frame calls
    :meth:`mark` with a shared monotonic-ns clock, and :meth:`finish`
    joins the marks into ONE span record — absolute ``hops`` (ns) plus
    consecutive ``deltas_ms`` — emitted through the telemetry logger
    (category "performance") and kept in a bounded ring for in-process
    consumers (bench columns, tests).

    Marks arrive from several threads (bridge pump, serving thread, WAL
    drain); a single lock serializes the tiny dict ops. Unfinished
    traces are evicted oldest-first past ``max_pending`` so a client
    that dies mid-flight can never leak marks without bound.
    """

    def __init__(self, logger: TelemetryLogger | None = None,
                 event_name: str = "OpTraceSpan",
                 capacity: int = 4096, max_pending: int = 4096) -> None:
        self._logger = logger or NullLogger()
        self._event_name = event_name
        self._marks: collections.OrderedDict = collections.OrderedDict()
        self._max_pending = max(1, max_pending)
        self.spans: collections.deque = collections.deque(
            maxlen=max(1, capacity))
        self._lock = threading.Lock()

    @staticmethod
    def now_ns() -> int:
        return time.monotonic_ns()

    def mark(self, trace_id: Any, hop: str, t_ns: int | None = None) -> None:
        t = self.now_ns() if t_ns is None else int(t_ns)
        with self._lock:
            marks = self._marks.get(trace_id)
            if marks is None:
                while len(self._marks) >= self._max_pending:
                    self._marks.popitem(last=False)
                marks = self._marks[trace_id] = []
            marks.append((hop, t))

    def hops(self, trace_id: Any) -> dict:
        """Current absolute marks of an UNFINISHED trace (hop → ns) —
        what the server stamps onto a traced ack so the client can join
        its own send/rx clocks in (same-host monotonic domain)."""
        with self._lock:
            return dict(self._marks.get(trace_id, ()))

    def finish(self, trace_id: Any, **props: Any) -> dict | None:
        """Join and emit one span; None (and no event) for an id that
        never marked — double-finish is likewise a no-op."""
        with self._lock:
            marks = self._marks.pop(trace_id, None)
        if not marks:
            return None
        t0 = marks[0][1]
        deltas = {f"{a}_to_{b}": round((tb - ta) / 1e6, 4)
                  for (a, ta), (b, tb) in zip(marks, marks[1:])}
        span = {"trace_id": trace_id, "hops": dict(marks),
                "deltas_ms": deltas,
                "total_ms": round((marks[-1][1] - t0) / 1e6, 4), **props}
        self.spans.append(span)
        self._logger.send_performance(self._event_name, span["total_ms"],
                                      trace_id=trace_id, **deltas)
        return span

    def hop_quantiles(self, qs=(0.5, 0.99)) -> dict:
        """Per-hop-delta quantiles over the finished-span ring — the
        sampled decomposition of end-to-end latency the round's bench
        rows record: {delta_name: {"p50_ms", "p99_ms", "count"}}."""
        by_hop: dict[str, list[float]] = {}
        for span in list(self.spans):
            for name, ms in span["deltas_ms"].items():
                by_hop.setdefault(name, []).append(ms)
        from .metrics import percentile
        out: dict = {}
        for name, vals in by_hop.items():
            vals.sort()
            row = {"count": len(vals)}
            for q in qs:
                row[f"p{int(q * 100)}_ms"] = round(percentile(vals, q), 4)
            out[name] = row
        return out


def timed(logger: TelemetryLogger, event_name: str,
          **props: Any) -> Callable:
    """Decorator form of PerformanceEvent.timedExec."""

    def wrap(fn: Callable) -> Callable:
        def inner(*args: Any, **kwargs: Any) -> Any:
            with PerformanceEvent(logger, event_name, **props):
                return fn(*args, **kwargs)
        inner.__name__ = fn.__name__
        return inner

    return wrap
