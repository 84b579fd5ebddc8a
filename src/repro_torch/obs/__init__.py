"""Observability: host-side span tracing with dispatch/execute fencing,
its Chrome-trace and text exports, and the capacity replay's metrics
(`CapacityMetrics`); counterpart of `repro.obs`'s trace, export and
metrics pillars (the tail telemetry comes with the serving modules)."""
from .trace import (Span, Tracer, disable, enable, enabled, fenced,
                    get_tracer, profile, span)
from .export import (coverage, stage_breakdown, summary, to_chrome_trace,
                     write_chrome_trace)
from .metrics import CapacityMetrics, capacity_metrics, reduce_reps

__all__ = [
    "CapacityMetrics", "Span", "Tracer", "capacity_metrics", "coverage",
    "disable", "enable", "enabled", "fenced", "get_tracer", "profile",
    "reduce_reps", "span", "stage_breakdown", "summary", "to_chrome_trace",
    "write_chrome_trace",
]
