"""Observability: host-side span tracing with dispatch/execute fencing,
its Chrome-trace and text exports, and the capacity replay's metrics
(`CapacityMetrics`), and the Pareto-tail telemetry of online serving
(`tail`: `TailWindow`, `TailRegistry`, `TailGovernor`); counterpart of
`repro.obs`."""
from .trace import (Span, Tracer, disable, enable, enabled, fenced,
                    get_tracer, profile, span)
from .export import (coverage, stage_breakdown, summary, to_chrome_trace,
                     write_chrome_trace)
from .metrics import CapacityMetrics, capacity_metrics, reduce_reps
from .tail import TailFit, TailGovernor, TailRegistry, TailWindow

__all__ = [
    "CapacityMetrics", "Span", "Tracer", "capacity_metrics", "coverage",
    "disable", "enable", "enabled", "fenced", "get_tracer", "profile",
    "reduce_reps", "span", "stage_breakdown", "summary", "TailFit",
    "TailGovernor", "TailRegistry", "TailWindow", "to_chrome_trace",
    "write_chrome_trace",
]
