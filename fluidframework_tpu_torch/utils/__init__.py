"""Base utilities: telemetry, tracing, events, heaps, metrics, config.

Reference parity: common/lib/common-utils, packages/utils/telemetry-utils,
services-core/src/metricClient.ts, services-utils (nconf config).
"""

from .config import Config, default_config
from .events import BatchManager, Deferred, Heap, TypedEventEmitter
from .metrics import (
    STORM_STAGES,
    CountedLRU,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    StageLedger,
    default_registry,
)
from .telemetry import (
    ChildLogger,
    CollectingLogger,
    DebugLogger,
    MultiSinkLogger,
    NullLogger,
    PerformanceEvent,
    PerfTrace,
    TelemetryLogger,
    TraceSpans,
    timed,
)

__all__ = [
    "BatchManager",
    "ChildLogger",
    "CollectingLogger",
    "Config",
    "CountedLRU",
    "Counter",
    "DebugLogger",
    "Deferred",
    "default_config",
    "default_registry",
    "Gauge",
    "Heap",
    "Histogram",
    "MetricsRegistry",
    "MultiSinkLogger",
    "NullLogger",
    "PerformanceEvent",
    "PerfTrace",
    "StageLedger",
    "STORM_STAGES",
    "TelemetryLogger",
    "timed",
    "TraceSpans",
    "TypedEventEmitter",
]
