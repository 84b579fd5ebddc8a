"""Observability: host-side span tracing with dispatch/execute fencing,
and its Chrome-trace and text exports; counterpart of `repro.obs`'s
trace and export pillars (the capacity metrics and tail telemetry come
with the modules that use them)."""
from .trace import (Span, Tracer, disable, enable, enabled, fenced,
                    get_tracer, profile, span)
from .export import (coverage, stage_breakdown, summary, to_chrome_trace,
                     write_chrome_trace)

__all__ = [
    "Span", "Tracer", "coverage", "disable", "enable", "enabled", "fenced",
    "get_tracer", "profile", "span", "stage_breakdown", "summary",
    "to_chrome_trace", "write_chrome_trace",
]
