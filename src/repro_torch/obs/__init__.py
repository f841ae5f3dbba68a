"""Serving observability: counterpart of `repro.obs` — metrics registry,
event log, lifecycle tracing, host spans and perf attribution, and the
bench-history regression gate (`obs.regress`, a copy of the
reference's).

See DESIGN.md §13 for the metric/event schema and naming conventions,
§14 for predicted-vs-measured launch accounting and step-signature
introspection.
"""

from .events import RUN_END, EventLog
from .metrics import (
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    ManualClock,
    MetricsRegistry,
    exponential_buckets,
    mutation_count,
)
from .perf import (
    MODEL_ERROR_BUCKETS,
    CompileWatcher,
    LaunchPrediction,
    PerfModel,
    plan_signature,
    plans_enabled,
    predict_launch,
    predict_streamed_pages,
)
from .tracing import (
    SPAN_CAPACITY,
    RequestTrace,
    ServeTelemetry,
    SpanRecord,
    SpanRing,
)

__all__ = [
    "CompileWatcher",
    "Counter",
    "DEFAULT_LATENCY_BUCKETS",
    "EventLog",
    "Gauge",
    "Histogram",
    "LaunchPrediction",
    "MODEL_ERROR_BUCKETS",
    "ManualClock",
    "MetricsRegistry",
    "PerfModel",
    "RUN_END",
    "RequestTrace",
    "SPAN_CAPACITY",
    "ServeTelemetry",
    "SpanRecord",
    "SpanRing",
    "exponential_buckets",
    "mutation_count",
    "plan_signature",
    "plans_enabled",
    "predict_launch",
    "predict_streamed_pages",
]
