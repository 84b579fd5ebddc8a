"""Deadline-aware hedged request scheduling, Chronos for serving;
counterpart of `repro.serve.scheduler`.

Requests carry SLA deadlines; replicas have heavy-tailed service times.
The scheduler treats each request as a 1-task job and executes it
through the strategy IR: `spec.draw` is the one execution entry for every
registered strategy (clone, srestart, sresume, hedge, adaptive, ...).

Keying: every draw of a request is taken at cell = its rid, row 0 of the
stream's `uniform_rows` (`sim.draws`, tag `SERVE_TAG`), and the stream is
named by a registry slot (`stream=`, by default the strategy's own). The
reference runs each window lane as its own 1-request JobSet under `vmap`;
here a window is ONE W-request JobSet of one task per request. The two
agree because no spec's `draw` reduces across jobs (hadoop_s's first
completion and rank, mantri's mean, are per job, and every job here has
one task), and every draw is task-major at the request's own
coordinates. So outcomes do not depend on window size, slicing or the
order of a stream. A window is padded at its edge to its full width (the
last request repeated, its lanes dropped), so on the CPU no request falls
in an elementwise kernel's scalar remainder whatever window it lies in.

On a fleet mesh (`mesh=`) the window's lanes split over its "job" axis
(`fleet.mesh.job_split`, the reference's P("job")): point (0, j) serves
lane range j on its own device, and the lanes meet on the window's
device. Lanes are independent, so the split changes no bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..core import JobSpec, Solution, solve
from ..device import resolve_device
from ..sim.draws import SERVE_TAG, Philox
from ..sim.strategies import SimParams
from ..sim.trace import JobSet
from ..strategies import get

__all__ = ["Request", "ReplicaPool", "HedgeOutcome", "HedgedScheduler",
           "baseline_no_hedge", "serve_window"]


def _window_jobset(t_min, beta, D) -> JobSet:
    """W one-task jobs on the columns' device."""
    W = t_min.shape[0]
    dev = t_min.device
    ones = torch.ones(W, dtype=torch.float32, device=dev)
    zeros_i = torch.zeros(W, dtype=torch.int32, device=dev)
    return JobSet(
        n_jobs=W, n_tasks=torch.ones(W, dtype=torch.int32, device=dev),
        t_min=t_min, beta=beta, D=D, arrival=0.0 * ones, C=ones,
        job_class=zeros_i, theta_scale=ones,
        job_id=torch.arange(W, dtype=torch.int64, device=dev),
        task_t_min=t_min, task_beta=beta, task_D=D)


def _edge_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    return x if pad == 0 else torch.cat([x, x[-1:].expand(pad)])


def _serve_lanes(source, name_of: str, spec, cols, p: SimParams,
                 max_r: int, oracle: bool):
    """(completion, machine) of W full lanes, the (rid, t_min, beta, D, r,
    choice) columns `cols` on one device."""
    rid, tm, b, d, rr, cc = cols
    w = int(rid.shape[0])

    def draw(name, shape):
        if shape[0] != w:
            raise ValueError(f"serve draw {name!r}: {tuple(shape)} is not "
                             f"request-major over {w} requests")
        return source.uniform_rows(name_of, 0, name, rid, 0,
                                   tuple(shape[1:]), rid.device,
                                   tag=SERVE_TAG)

    return spec.draw(draw, _window_jobset(tm, b, d), rr, cc, p,
                     max_r=max_r, oracle=oracle)


def serve_window(source, rids, t_min, beta, D, r, choice, *, strategy: str,
                 p: SimParams, stream: Optional[str] = None, max_r: int = 8,
                 oracle: bool = True, width: Optional[int] = None,
                 mesh=None, device=None):
    """(completion, machine) f32 (n,) of one window of n requests, on the
    columns' device (numpy columns go to `device`, default the card).

    source: the uniform source (`sim.draws.Philox`); stream: the registry
        slot whose key the draws take (default `strategy`).
    width: the window's width (>= n); the window is padded to it at its
        edge. None = n.
    mesh: a `fleet.FleetMesh` whose "job" extent divides the width: each
        point (0, j) serves its lane range on its own device.
    """
    if isinstance(rids, torch.Tensor):
        dev = rids.device
    else:
        dev = resolve_device(device)
    col = lambda x, dt: torch.as_tensor(x).to(device=dev, dtype=dt)
    n = int(rids.shape[0])
    w = n if width is None else int(width)
    if w < n:
        raise ValueError(f"window width {w} < {n} requests")
    spec = get(strategy)
    if not spec.detectable:
        oracle = True
    pad = w - n
    rid, tm, b, d, rr, cc = (
        _edge_pad(col(x, dt), pad) for x, dt in (
            (rids, torch.int64), (t_min, torch.float32),
            (beta, torch.float32), (D, torch.float32), (r, torch.int32),
            (choice, torch.int32)))
    name_of = strategy if stream is None else stream
    cols = (rid, tm, b, d, rr, cc)
    if mesh is None:
        completion, machine = _serve_lanes(source, name_of, spec, cols, p,
                                           max_r, oracle)
    else:
        from ..fleet.mesh import job_split
        # every point is launched before the lanes meet
        parts = [_serve_lanes(source, name_of, spec,
                              tuple(x[lo:hi].to(mesh.point(0, j))
                                    for x in cols), p, max_r, oracle)
                 for j, (lo, hi) in enumerate(job_split(mesh, w))]
        completion, machine = (torch.cat([x[k].to(dev) for x in parts])
                               for k in range(2))
    return completion[:n], machine[:n]


# ---------------------------------------------------------------------------
# Request-level API
# ---------------------------------------------------------------------------


@dataclass(order=True)
class Request:
    deadline: float
    rid: int = field(compare=False)
    n_tokens: int = field(compare=False, default=32)
    submitted: float = field(compare=False, default=0.0)


@dataclass(frozen=True)
class ReplicaPool:
    """Replica latency model: Pareto(t_min, beta) service-time multiplier.
    Parameters only: draws are keyed per request, never taken from a
    shared mutable generator."""
    n_replicas: int
    base_tok_s: float = 200.0
    t_min_mult: float = 1.0
    beta: float = 1.6

    def t_min_of(self, n_tokens: int) -> float:
        """Service-time floor for a request of n_tokens."""
        return n_tokens / self.base_tok_s * self.t_min_mult


@dataclass
class HedgeOutcome:
    rid: int
    latency: float
    met: bool
    machine_time: float
    strategy: str
    r: int


class HedgedScheduler:
    """Chronos-optimized hedging over a replica pool.

    strategy: any registered strategy, or "adaptive" (the default), the
        per-request argmax over the Chronos trio; "auto" in `run_workload`
        follows the online governor (`serve_trace`).
    source: the uniform source (default Philox(0)). Every request draws
        under the scheduler's one stream (the strategy's registry slot,
        adaptive's for "auto"), whatever strategy its plan picks, as the
        reference draws every request under its one key.
    """

    def __init__(self, pool: ReplicaPool, theta: float = 1e-3,
                 tau_est_frac: float = 0.3, tau_kill_gap: float = 0.5,
                 phi_est: float = 0.25, strategy: str = "adaptive",
                 max_r: int = 8, source=None, *, device=None):
        self.pool = pool
        self.theta = theta
        self.p = SimParams(tau_est_frac=tau_est_frac,
                           tau_kill_gap_frac=tau_kill_gap,
                           phi_est=phi_est)
        self.strategy = strategy
        self.stream = "adaptive" if strategy == "auto" else strategy
        self.max_r = max_r
        self.source = Philox(0) if source is None else source
        self.device = resolve_device(device)

    def plan(self, req: Request) -> Solution:
        """Best (strategy, r*) for one request (Algorithm 1)."""
        t_min = self.pool.t_min_of(req.n_tokens)
        if req.deadline <= t_min * 1.05:
            return Solution("clone", 0, 0.0, 0.0, 0.0)
        spec = JobSpec.make(
            t_min=t_min, beta=self.pool.beta, D=req.deadline, N=1,
            tau_est=self.p.tau_est_frac * t_min,
            tau_kill=(self.p.tau_est_frac + self.p.tau_kill_gap_frac)
            * t_min,
            phi_est=self.p.phi_est, C=1.0, theta=self.theta, R_min=0.0,
            device=self.device)
        return solve(spec, device=self.device)

    def _trace_of(self, requests):
        from .requests import RequestTrace
        if isinstance(requests, RequestTrace):
            return requests
        n = len(requests)
        f32 = np.float32
        return RequestTrace(
            rid=np.asarray([q.rid for q in requests], np.int32),
            arrival=np.asarray([q.submitted for q in requests], f32),
            t_min=np.asarray([self.pool.t_min_of(q.n_tokens)
                              for q in requests], f32),
            beta=np.full(n, self.pool.beta, f32),
            D=np.asarray([q.deadline for q in requests], f32),
            C=np.ones(n, f32), theta_scale=np.ones(n, f32),
            job_class=np.zeros(n, np.int32), class_names=("pool",))

    def execute(self, req: Request) -> HedgeOutcome:
        """Serve one request under its planned (strategy, r*)."""
        sol = self.plan(req)
        trace = self._trace_of([req])
        completion, machine = serve_window(
            self.source, trace.rid, trace.t_min, trace.beta, trace.D,
            np.asarray([sol.r_opt]), np.zeros(1, np.int32),
            strategy=sol.strategy, p=self.p, stream=self.stream,
            max_r=self.max_r, device=self.device)
        out = torch.stack([completion, machine]).cpu().tolist()
        return HedgeOutcome(
            rid=req.rid, latency=out[0][0],
            met=bool(np.float32(out[0][0]) <= np.float32(req.deadline)),
            machine_time=out[1][0], strategy=sol.strategy,
            r=int(sol.r_opt))

    def run_workload(self, requests) -> dict:
        """Serve a list of Requests (or a RequestTrace) in one stream, at
        the pool's true tail (known-tail mode; online tail estimation is
        `serve_trace(refit_every=...)`)."""
        from .loop import serve_trace
        out = serve_trace(
            self.source, self._trace_of(requests), self.p,
            strategy=self.strategy, theta=self.theta, max_r=self.max_r,
            stream=self.stream, device=self.device)
        return {"pocd": float(out.result.pocd),
                "mean_machine_time": float(out.result.mean_cost),
                "mean_r": out.mean_r, "latency": out.latency,
                "output": out}


def baseline_no_hedge(pool: ReplicaPool, requests, source=None, *,
                      device=None) -> dict:
    """Serve the same stream with no speculation (strategy hadoop_ns)."""
    sched = HedgedScheduler(pool, strategy="hadoop_ns", source=source,
                            device=device)
    return sched.run_workload(requests)
