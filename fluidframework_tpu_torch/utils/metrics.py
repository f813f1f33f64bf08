"""Metrics registry: counters, gauges, latency histograms with p99.

Reference parity: services-core/src/metricClient.ts (server metric seam),
connectionTelemetry.ts (client op round-trip latency), merge-tree's
accumTime/localTime micro counters (client.ts:45-55). TPU addition: a
registry ``snapshot()`` is a flat dict of floats so per-chip snapshots can
be summed across a mesh with one ``psum``
(fluidframework_tpu.parallel.mesh.aggregate_metrics).

Thread safety: the storm serving stack touches one registry from several
threads (the bridge pump, the WAL writer's drain callbacks, fanout
harvest), so every mutator and ``snapshot()`` take a per-metric lock —
one uncontended ``threading.Lock`` per observe, not a global registry
lock a hot histogram would serialize the whole assembly on.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Any, Iterable


class Counter:
    """Monotonic event count (merged ops, ticks, nacks...)."""

    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Gauge:
    """Point-in-time level (queue depth, resident docs...)."""

    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def add(self, delta: float) -> None:
        with self._lock:
            self.value += delta


class Histogram:
    """Latency histogram over log-spaced buckets; O(1) observe, quantiles
    from linear interpolation within the winning bucket. Bounds default to
    1us..60s — wide enough for op-apply and device-tick latencies without
    per-sample storage (the "reservoir" the reference never needed because
    it never measured)."""

    __slots__ = ("_bounds", "_counts", "count", "total", "max", "min",
                 "_lock")

    def __init__(self, min_bound: float = 1e-6, max_bound: float = 60.0,
                 buckets_per_decade: int = 10) -> None:
        decades = math.log10(max_bound / min_bound)
        n = max(1, int(math.ceil(decades * buckets_per_decade)))
        self._bounds = [min_bound * (max_bound / min_bound) ** (i / n)
                        for i in range(1, n + 1)]
        self._counts = [0] * (n + 1)  # +1 overflow bucket
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self.min = math.inf
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        lo, hi = 0, len(self._bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if value <= self._bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self.count += 1
            self.total += value
            if value > self.max:
                self.max = value
            if value < self.min:
                self.min = value
            self._counts[lo] += 1

    def quantile(self, q: float) -> float:
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = q * self.count
            seen = 0
            for i, c in enumerate(self._counts):
                if c and seen + c >= rank:
                    if i >= len(self._bounds):
                        return self.max
                    # Linear interpolation within the winning bucket:
                    # its c samples are assumed uniform over (lo, hi].
                    bucket_lo = self._bounds[i - 1] if i > 0 else 0.0
                    bucket_hi = self._bounds[i]
                    frac = (rank - seen) / c
                    est = bucket_lo + frac * (bucket_hi - bucket_lo)
                    # Bucket edges can overshoot the true extremes
                    # (e.g. a single observation mid-bucket).
                    return min(max(est, self.min), self.max)
                seen += c
            return self.max

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


def percentile(sorted_values, q: float):
    """Nearest-rank percentile (index ``ceil(q*n) - 1``) of an
    ascending-sorted sequence — THE one definition every small-sample
    decomposition in this repo uses (StageLedger.attribution,
    TraceSpans.hop_quantiles, the bench hop columns), so p99 of
    identical samples agrees across surfaces."""
    n = len(sorted_values)
    if n == 0:
        return 0.0
    idx = max(0, math.ceil(q * n) - 1)
    return sorted_values[min(n - 1, idx)]


#: Stage order of one storm serving tick — the fixed shape of every
#: :class:`StageLedger` record (server/storm.py fills these; the sum is
#: the attributable slice of the tick's wall clock).
STORM_STAGES = ("ingress_decode", "admission", "scatter", "device_dispatch",
                "readback", "wal_append", "wal_commit_wait", "ack_pack",
                "fanout_publish")


class StageLedger:
    """Per-tick stage attribution: ONE fixed-shape record per serving
    tick — tick id, queue depth, batch size, and a monotonic-ns split per
    pipeline stage — kept in a bounded ring buffer and mirrored into
    per-stage :class:`Histogram` s of a shared registry (so alfred's
    ``get_metrics`` exports ``<prefix>.<stage>.p50/p99`` and
    tools/monitor.py can render a live stage-attribution bar).

    The record dict is intentionally flat and identical every tick
    (stages absent from a split map record 0 ns), so downstream consumers
    (bench columns, the monitor bar) never branch on shape.

    Pipelined ticks overlap stages across tick boundaries —
    tick N's ``wal_commit_wait`` runs on the WAL writer thread while
    tick N+1's ``device_dispatch`` runs on the serving thread — so the
    per-stage splits of one tick can SUM past the wall clock it
    occupied. ``record`` therefore also takes the tick's exclusive
    wall-clock slice (``wall_ns``, the harvest-to-harvest cadence) and
    the serving pipeline depth; :meth:`attribution` reports wall time
    and an explicit ``overlap_ms`` instead of pretending the concurrent
    spans were sequential.

    ``fields`` names further integers a record carries (0 where a
    :meth:`record` call leaves one out); the storm tick's spans
    (``utils/tick_spans.py``) keep their tick's start, root span and host
    reads there. A ledger made without them records the shape above.
    """

    def __init__(self, stages: Iterable[str] = STORM_STAGES,
                 registry: "MetricsRegistry | None" = None,
                 prefix: str = "storm.stage", capacity: int = 1024,
                 fields: Iterable[str] = ()) -> None:
        self.stages = tuple(stages)
        self.fields = tuple(fields)
        self.prefix = prefix
        self._ring: deque = deque(maxlen=max(1, capacity))
        self._lock = threading.Lock()
        self._hists = None
        self._wall_hist = None
        if registry is not None:
            self._hists = {s: registry.histogram(f"{prefix}.{s}")
                           for s in self.stages}
            self._wall_hist = registry.histogram(f"{prefix}.wall")

    def record(self, tick_id: int, queue_depth: int, batch_docs: int,
               batch_ops: int, splits_ns: dict, wall_ns: int = 0,
               depth: int = 0, fields: dict | None = None) -> dict:
        """Commit one tick's record; unknown split keys are rejected
        (a typo'd stage would silently vanish from the attribution —
        and must fail under ``python -O`` too, hence no assert).
        ``wall_ns`` is the tick's exclusive wall-clock slice (0 =
        unknown, the pre-pipelining shape); ``depth`` the serving
        pipeline depth that produced it; ``fields`` the ledger's further
        integers (unknown names are rejected the same way)."""
        fields = fields or {}
        unknown = (set(splits_ns) - set(self.stages)) \
            | (set(fields) - set(self.fields))
        if unknown:
            raise ValueError(f"unknown ledger stages: {sorted(unknown)}")
        rec = {"tick": int(tick_id), "queue_depth": int(queue_depth),
               "batch_docs": int(batch_docs), "batch_ops": int(batch_ops),
               "wall": int(wall_ns), "depth": int(depth)}
        for f in self.fields:
            rec[f] = int(fields.get(f, 0))
        for s in self.stages:
            rec[s] = int(splits_ns.get(s, 0))
        with self._lock:
            self._ring.append(rec)
        if self._wall_hist is not None and rec["wall"] > 0:
            self._wall_hist.observe(rec["wall"] / 1e9)
        if self._hists is not None:
            for s in self.stages:
                ns = rec[s]
                if ns > 0:
                    self._hists[s].observe(ns / 1e9)
        return rec

    def amend(self, rec: dict, stage: str, ns: int) -> None:
        """Backfill one stage of an already-committed record — the WAL
        commit-wait completes ticks after the record is cut (acks drain
        at the durability watermark, not at harvest)."""
        if stage not in self.stages:
            raise ValueError(f"unknown ledger stage: {stage!r}")
        rec[stage] = int(ns)
        if self._hists is not None and ns > 0:
            self._hists[stage].observe(ns / 1e9)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        """Drop the ring (benches clear warm-up/compile ticks so the
        attribution window covers only the measured run); the registry
        histograms keep their cumulative view."""
        with self._lock:
            self._ring.clear()

    def records(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._ring]

    def attribution(self) -> dict:
        """Per-stage share of attributed tick time over the ring window:
        {stage: {"share", "p50_ms", "p99_ms", "total_ms"}} plus a
        "_window" row (ticks covered, attributed vs total ns). The shares
        sum to 1.0 over stages with any time recorded. p50/p99 cover the
        ticks where the stage RAN (nonzero split) — the same population
        the registry histograms observe, so the two surfaces agree.

        When the records carry wall-clock slices (pipelined serving),
        each stage also reports ``of_wall`` — the fraction of real wall
        time it was active, which can sum PAST 1.0 across stages when
        they overlap — and "_window" reports the honest time budget:
        ``wall_ms`` (what the ticks actually occupied), ``overlap_ms``
        (attributed − wall, the concurrency the pipeline bought; 0 when
        stages ran sequentially) and ``pipeline_depth``. Summing the
        per-stage totals and calling it tick time double-counts under
        overlap — wall_ms is the denominator that does not lie."""
        recs = self.records()
        out: dict[str, Any] = {}
        if not recs:
            return {"_window": {"ticks": 0}}
        totals = {s: sum(r[s] for r in recs) for s in self.stages}
        grand = sum(totals.values()) or 1
        wall_total = sum(r.get("wall", 0) for r in recs)
        for s in self.stages:
            samples = sorted(r[s] for r in recs if r[s] > 0)
            out[s] = {
                "share": round(totals[s] / grand, 4),
                "p50_ms": round(percentile(samples, 0.50) / 1e6, 3),
                "p99_ms": round(percentile(samples, 0.99) / 1e6, 3),
                "total_ms": round(totals[s] / 1e6, 3),
            }
            if wall_total > 0:
                out[s]["of_wall"] = round(totals[s] / wall_total, 4)
        depths = [r.get("depth", 0) for r in recs if r.get("depth", 0) > 0]
        out["_window"] = {
            "ticks": len(recs),
            "attributed_ms": round(grand / 1e6, 3),
            "wall_ms": round(wall_total / 1e6, 3),
            "overlap_ms": round(max(0, grand - wall_total) / 1e6, 3)
            if wall_total > 0 else 0.0,
            "pipeline_depth": round(sum(depths) / len(depths), 2)
            if depths else 0,
            "mean_batch_docs": round(sum(r["batch_docs"] for r in recs)
                                     / len(recs), 1),
            "mean_queue_depth": round(sum(r["queue_depth"] for r in recs)
                                      / len(recs), 1),
        }
        return out


class CountedLRU:
    """Small bounded LRU map with hit/miss counters wired into a shared
    registry — the cache shape the serving hot path needs (storm cohort
    resolution, residency cold-handle lookups): O(1) get/put, strict
    entry bound, and an observable hit rate so a thrashing cache shows
    up in a metrics scrape instead of as unexplained tick time.

    NOT thread-safe by itself — callers on the serving thread use it
    bare; cross-thread users wrap it."""

    __slots__ = ("capacity", "_data", "_hits", "_misses")

    def __init__(self, capacity: int,
                 registry: "MetricsRegistry | None" = None,
                 prefix: str = "lru") -> None:
        from collections import OrderedDict
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._data: Any = OrderedDict()
        reg = registry if registry is not None else MetricsRegistry()
        self._hits = reg.counter(f"{prefix}.hits")
        self._misses = reg.counter(f"{prefix}.misses")

    def get(self, key, default=None):
        try:
            value = self._data[key]
        except KeyError:
            self._misses.inc()
            return default
        self._data.move_to_end(key)
        self._hits.inc()
        return value

    def put(self, key, value) -> None:
        data = self._data
        if key in data:
            data.move_to_end(key)
        data[key] = value
        if len(data) > self.capacity:
            data.popitem(last=False)  # evict least-recently-used

    def pop(self, key, default=None):
        return self._data.pop(key, default)

    def clear(self) -> None:
        self._data.clear()

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    @property
    def hits(self) -> int:
        return int(self._hits.value)

    @property
    def misses(self) -> int:
        return int(self._misses.value)


class MetricsRegistry:
    """Named metric bag. ``snapshot()`` flattens to {name: float}; counters
    and gauges sum across shards, histograms export count/mean/p50/p99/max.
    Creation is locked; per-metric mutation locks live on the metrics."""

    def __init__(self) -> None:
        self._metrics: dict[str, Any] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, **kwargs: Any) -> Histogram:
        with self._lock:
            if name not in self._metrics:
                self._metrics[name] = Histogram(**kwargs)
            metric = self._metrics[name]
        assert isinstance(metric, Histogram), name
        return metric

    def _get(self, name: str, cls: type) -> Any:
        with self._lock:
            if name not in self._metrics:
                self._metrics[name] = cls()
            metric = self._metrics[name]
        assert isinstance(metric, cls), name
        return metric

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            metrics = list(self._metrics.items())
        out: dict[str, float] = {}
        for name, metric in metrics:
            if isinstance(metric, (Counter, Gauge)):
                out[name] = metric.value
            else:
                out[f"{name}.count"] = float(metric.count)
                out[f"{name}.mean"] = metric.mean
                out[f"{name}.p50"] = metric.quantile(0.50)
                out[f"{name}.p99"] = metric.quantile(0.99)
                out[f"{name}.max"] = metric.max
        return out


default_registry = MetricsRegistry()
