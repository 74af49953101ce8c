"""Observability: tracing spans, metrics registry, report serialization.

A copy of the reference's ``repro/obs/`` (DESIGN.md §14): pure host-side
Python that imports no framework, below ``runtime/`` in the layer map.
Disabled observability is free by construction: engines default to the
:data:`NULL_TRACER` / :data:`NULL_METRICS` singletons, whose methods are
allocation-free no-ops.
"""

from .metrics import (BYTES_BUCKETS, LATENCY_BUCKETS_S, NULL_METRICS,
                      OCCUPANCY_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry, NullMetrics)
from .report import ReportBase, to_jsonable
from .trace import (NULL_TRACER, MonotonicClock, NullTracer, TickClock,
                    Tracer, validate_chrome_trace)

__all__ = [
    "BYTES_BUCKETS",
    "LATENCY_BUCKETS_S",
    "NULL_METRICS",
    "NULL_TRACER",
    "OCCUPANCY_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MonotonicClock",
    "NullMetrics",
    "NullTracer",
    "ReportBase",
    "TickClock",
    "Tracer",
    "to_jsonable",
    "validate_chrome_trace",
]
