"""Request traces: the serving workload schema; counterpart of
`repro.serve.requests`.

A request is a 1-task job: an SLA deadline, a heavy-tailed
Pareto(t_min, beta) service time, a price and an SLA weight, the per-job
columns of `repro_torch.workloads.WorkloadTrace` with the task axis
collapsed to one. `requests_from_trace` performs that collapse, so every
scenario of the workload registry doubles as a request stream.

`rid` is the request's identity for random numbers: every draw a request
receives is keyed by its rid (`sim.draws`, `uniform_rows` at cell rid,
row 0, under `SERVE_TAG`), so serving a slice of a trace, reordering it,
or cutting it into other windows never changes any request's outcome.

The columns are host numpy; the serving loop moves them to its device
once per stream (`RequestTrace.to`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import to_host

__all__ = ["RequestTrace", "requests_from_trace", "make_requests",
           "uniform_requests"]


class RequestTrace(NamedTuple):
    """Arrival-sorted per-request columns (R,), the online schema: numpy
    on the host, or tensors on a device (`to`)."""

    rid: object           # (R,) int32, the stable random-number identity
    arrival: object       # (R,) float32 seconds from stream start
    t_min: object         # (R,) float32 Pareto service-time scale
    beta: object          # (R,) float32 Pareto tail index
    D: object             # (R,) float32 relative SLA deadline (s)
    C: object             # (R,) float32 machine-second price
    theta_scale: object   # (R,) float32 SLA-weight multiplier
    job_class: object     # (R,) int32 index into class_names
    class_names: Tuple[str, ...] = ()

    @property
    def n_requests(self) -> int:
        return int(self.rid.shape[0])

    def slice(self, lo: int, hi: int) -> "RequestTrace":
        """Sub-stream [lo, hi) with identities preserved."""
        return self.take(slice(lo, hi))

    def take(self, idx) -> "RequestTrace":
        """The requests at `idx` (a slice, or an index array of the
        columns' kind), identities preserved."""
        return RequestTrace(*(c[idx] for c in self[:-1]),
                            class_names=self.class_names)

    def to(self, device) -> "RequestTrace":
        """The columns as tensors on `device`: rid int64 (the draws'
        cell), job_class int32, the rest float32."""
        dt = (torch.int64, torch.float32, torch.float32, torch.float32,
              torch.float32, torch.float32, torch.float32, torch.int32)
        return RequestTrace(*(torch.from_numpy(np.ascontiguousarray(
            to_host(c))).to(device=device, dtype=d)
            for c, d in zip(self[:-1], dt)), class_names=self.class_names)


def requests_from_trace(trace) -> RequestTrace:
    """Collapse a `workloads.WorkloadTrace` (numpy or tensor columns) to a
    request stream: each job becomes one request (its task count is
    ignored), rid = its arrival-order position."""
    n = int(trace.t_min.shape[0])
    f = lambda x: np.asarray(to_host(x), np.float32)
    return RequestTrace(
        rid=np.arange(n, dtype=np.int32),
        arrival=f(trace.arrival), t_min=f(trace.t_min),
        beta=f(trace.beta), D=f(trace.D), C=f(trace.C),
        theta_scale=f(trace.theta_scale),
        job_class=np.asarray(to_host(trace.job_class), np.int32),
        class_names=tuple(getattr(trace, "class_names", ())))


def make_requests(scenario: str, n_requests: Optional[int] = None,
                  seed: Optional[int] = None, *, device=None
                  ) -> RequestTrace:
    """A workload-registry scenario as a request stream, synthesized on
    `device` (default the card) and held on the host."""
    from ..workloads.registry import make_trace
    return requests_from_trace(
        make_trace(scenario, n_jobs=n_requests, seed=seed, device=device))


def uniform_requests(n: int, t_min: float, beta: float, D,
                     C: float = 1.0) -> RequestTrace:
    """Homogeneous stream (per-request D may vary), for tests and closed
    forms."""
    ones = np.ones(n, np.float32)
    return RequestTrace(
        rid=np.arange(n, dtype=np.int32), arrival=0.0 * ones,
        t_min=t_min * ones, beta=beta * ones,
        D=np.broadcast_to(np.asarray(D, np.float32), (n,)).copy(),
        C=C * ones, theta_scale=ones,
        job_class=np.zeros(n, np.int32), class_names=("uniform",))
