"""Serving of the port; counterpart of `repro.serve`.

* `requests`: `RequestTrace`, the columnar request-stream schema; any
  workload scenario or trace collapses into one.
* `scheduler`: `serve_window`, a window of requests as one JobSet drawn
  at each request's rid, and the request-level `HedgedScheduler` on it.
* `loop`: `serve_trace` / `run_serve`, known-tail and online serving
  (epochs, unhedged probes, `obs.tail.TailGovernor` refits), streamed
  through `sim.metrics.StreamCombiner`.
* `engine`: `Engine`, the gemma2-2b text engine (prefill, then greedy
  decode).
"""
from .engine import Engine
from .loop import ServeOutput, run_serve, serve_trace
from .requests import (RequestTrace, make_requests, requests_from_trace,
                       uniform_requests)
from .scheduler import (HedgedScheduler, HedgeOutcome, ReplicaPool, Request,
                        baseline_no_hedge, serve_window)

__all__ = [
    "Engine", "HedgedScheduler", "HedgeOutcome", "ReplicaPool", "Request",
    "RequestTrace", "ServeOutput", "baseline_no_hedge", "make_requests",
    "requests_from_trace", "run_serve", "serve_trace", "serve_window",
    "uniform_requests",
]
