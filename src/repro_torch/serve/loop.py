"""The online serving path: continuous requests, online tail governor;
counterpart of `repro.serve.loop`.

`serve_trace` streams a `RequestTrace` through the strategy IR in
fixed-width windows (`scheduler.serve_window`), on `device` (default the
card):

* **Known-tail mode** (refit_every=None): Algorithm 1 solves every
  request's r* once, at the request's own (t_min, beta), in one launch of
  the grid-solve kernel (`kernels/csrc/grid_solve.cu`).
* **Online mode** (refit_every=E): the stream is cut into epochs of E
  requests. Every probe_every-th request (by rid) is served unhedged, and
  its completion, an unbiased Pareto sample, feeds an
  `obs.tail.TailGovernor`, which refits the Pareto tail on its rolling
  window and re-solves Algorithm 1 once per epoch. Epoch e hedges at the
  fit from epochs < e (one grid-solve launch of width E); cold epochs (no
  fit yet) serve unhedged. With strategy="auto" each epoch also adopts
  the governor's re-solved strategy.

Every draw is keyed by the stream's registry slot and the request's rid
(`uniform_rows`, tag `SERVE_TAG`), probes and hedged requests alike; a
stream is named by `stream=` (default the strategy, "auto" borrowing
adaptive's slot, as `run_serve` assigns them). Solves are per-lane and
fits depend only on the probe prefix, so results do not depend on window
size or chunk boundaries, and `sim.metrics.StreamCombiner` accumulates
epochs so that a streamed run reproduces a monolithic one.

Per epoch the request columns stay on the device; its met, completion,
cost and r* columns come back to the host in ONE transfer (the combiner's
columns and the governor's probe completions).

On a fleet mesh (`mesh=`) the window is padded to a multiple of the
mesh's "job" extent and each window's lanes split over the "job" points
(`scheduler.serve_window`); solves and outputs stay on the first point.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.utility import JobSpec
from ..device import resolve_device
from ..obs import trace as obs_trace
from ..sim.metrics import (SimResult, StreamCombiner, latency_summary,
                           net_utility, request_result)
from ..sim.strategies import SimParams
from ..strategies import get, names, solve_jobs
from .requests import RequestTrace, make_requests, requests_from_trace
from .scheduler import serve_window

__all__ = ["ServeOutput", "serve_trace", "run_serve"]

_UNHEDGED = "hadoop_ns"   # the probe / cold-epoch / no-hedge draw


class ServeOutput(NamedTuple):
    strategy: str              # requested strategy ("auto" stays "auto")
    result: SimResult          # per-request metrics (finalized columns)
    utility: float             # net_utility(pocd, mean_cost, r_min, theta)
    latency: dict              # p50/p95/p99/mean of request latency
    mean_r: float              # mean r* over hedged requests (0 if none)
    n_probes: int              # unhedged exploration requests served
    n_refits: int              # governor refit/re-solve events
    fits: tuple                # TailFit per refit, in order
    epoch_strategies: tuple    # strategy executed per epoch (online mode)


def _epoch_jobspecs(t_min_fit, beta_fit, reqs: RequestTrace, p: SimParams,
                    theta: float, r_min: float, width: int) -> JobSpec:
    """Batched 1-task JobSpec at the policy's tail belief, padded at the
    edge to `width` (lanes are independent: padding never moves a real
    lane's r*). The tail (t_min, beta) is the policy's estimate, a fit's
    floats or the requests' own columns; D, C and theta_scale are the
    SLA's. `reqs` holds device columns."""
    dev = reqs.D.device
    n = reqs.n_requests
    pad = width - n
    f32 = torch.float32
    col = lambda x: torch.cat([x, x[-1:].expand(pad)]) if pad else x
    belief = lambda v: (col(v) if isinstance(v, torch.Tensor)
                        else torch.full((width,), v, dtype=f32, device=dev))
    t = belief(t_min_fit)
    b = belief(beta_fit)
    tau_est = p.tau_est_frac * t
    full = lambda v: torch.full((width,), v, dtype=f32, device=dev)
    return JobSpec(
        t_min=t, beta=b, D=col(reqs.D), N=full(1.0),
        tau_est=tau_est, tau_kill=tau_est + p.tau_kill_gap_frac * t,
        phi_est=full(p.phi_est), C=col(reqs.C),
        theta=torch.tensor(theta, dtype=f32, device=dev) * col(
            reqs.theta_scale),
        R_min=full(r_min))


def _solve_epoch(strategy: str, t_min_fit, beta_fit, reqs: RequestTrace,
                 p: SimParams, theta, r_min, max_r: int, width: int):
    """(r, choice) int32 (n_requests,) on the device: one grid solve of
    `width` lanes (the grid-solve kernel on the card)."""
    specs = _epoch_jobspecs(t_min_fit, beta_fit, reqs, p, theta, r_min,
                            width)
    r, choice, _, _, _, _ = solve_jobs(strategy, specs, max_r + 1,
                                       device=reqs.D.device)
    n = reqs.n_requests
    return r[:n], choice[:n]


def _serve_chunk(source, stream: str, reqs: RequestTrace, r, choice, *,
                 strategy, p, max_r, oracle, window, mesh=None):
    """Serve device request columns through fixed-width windows; stream
    order. (completion, machine) f32 (n,) on the device."""
    n = reqs.n_requests
    parts = []
    for lo in range(0, n, window):
        hi = min(lo + window, n)
        parts.append(serve_window(
            source, reqs.rid[lo:hi], reqs.t_min[lo:hi], reqs.beta[lo:hi],
            reqs.D[lo:hi], r[lo:hi], choice[lo:hi], strategy=strategy,
            p=p, stream=stream, max_r=max_r, oracle=oracle, width=window,
            mesh=mesh))
    return (torch.cat([c for c, _ in parts]),
            torch.cat([m for _, m in parts]))


def _host_result(reqs: RequestTrace, completion, machine, r):
    """The epoch's request_result and r* columns on the host, read back in
    one transfer: (SimResult of numpy columns, r int32)."""
    res = request_result(reqs, completion, machine)
    met, comp, cost, rr = torch.stack([
        res.job_met.to(torch.float32), res.job_completion, res.job_cost,
        r.to(torch.float32)]).cpu().numpy()
    host = SimResult(pocd=None, job_met=met.astype(bool),
                     job_completion=comp, job_cost=cost, mean_cost=None)
    return host, rr.astype(np.int32)


def _as_requests(reqs, device) -> RequestTrace:
    if isinstance(reqs, str):
        return make_requests(reqs, device=device)
    if isinstance(reqs, RequestTrace):
        return reqs
    return requests_from_trace(reqs)


def serve_trace(source, reqs, p: Optional[SimParams] = None, *,
                strategy: str = "adaptive", theta: float = 1e-3,
                r_min: float = 0.0, max_r: int = 8, oracle: bool = True,
                window: int = 256, refit_every: Optional[int] = None,
                probe_every: int = 8, r_override: Optional[int] = None,
                mesh=None, tail_capacity: int = 2048,
                min_samples: int = 16,
                combiner: Optional[StreamCombiner] = None,
                stream: Optional[str] = None, device=None) -> ServeOutput:
    """Serve one request stream under one strategy; see the module doc.

    source: the uniform source (`sim.draws.Philox`, or a replay).
    reqs: a RequestTrace, a workloads WorkloadTrace, or a scenario name.
    stream: the registry slot that keys the stream's draws (default the
        strategy; "auto" takes adaptive's).
    mesh: a `fleet.FleetMesh` or None: windows split over its "job"
        axis, the window padded to a multiple of its extent; the bits
        equal the run without a mesh.
    r_override: fixed replication level (the fixed-r baseline): skips the
        per-request solve and the governor's fit.
    combiner: accumulate into an existing StreamCombiner (streamed
        serving); a fresh one is created when None.
    """
    from ..fleet.mesh import mesh_device, mesh_extents, pad_count
    dev = mesh_device(mesh, resolve_device(device))
    window = pad_count(window, mesh_extents(mesh)[1])
    reqs = _as_requests(reqs, dev)
    if p is None:
        p = SimParams()
    requested = strategy
    if strategy == "auto":
        if refit_every is None:
            strategy = "adaptive"   # known-tail auto = per-request argmax
        if r_override is not None:
            raise ValueError("r_override is incompatible with "
                             "strategy='auto' (nothing picks the strategy)")
    if stream is None:
        stream = "adaptive" if requested == "auto" else requested
    optimized = strategy == "auto" or get(strategy).optimized
    kw = dict(p=p, max_r=max_r, oracle=oracle, window=window, mesh=mesh)

    n = reqs.n_requests
    dreqs = reqs.to(dev)
    acc = StreamCombiner() if combiner is None else combiner
    zeros = lambda m: torch.zeros(m, dtype=torch.int32, device=dev)
    sum_r, n_hedged, n_probes = 0.0, 0, 0
    fits: list = []
    epoch_strategies: list = []

    with obs_trace.span("serve.trace", strategy=requested, n_requests=n,
                        online=refit_every is not None):
        if refit_every is None:
            # -- known-tail: one solve at the true per-request tail ------
            if not optimized:
                r, ch = zeros(n), zeros(n)
            elif r_override is not None:
                r = torch.full((n,), int(r_override), dtype=torch.int32,
                               device=dev)
                sp = get(strategy)
                ch = zeros(n) if sp.choose is None else sp.choose(
                    r.to(torch.float32),
                    _epoch_jobspecs(dreqs.t_min, dreqs.beta, dreqs, p,
                                    theta, r_min, n)).to(torch.int32)
            else:
                r, ch = _solve_epoch(strategy, dreqs.t_min, dreqs.beta,
                                     dreqs, p, theta, r_min, max_r, n)
            completion, machine = _serve_chunk(
                source, stream, dreqs, r, ch, strategy=strategy, **kw)
            host, r_host = _host_result(dreqs, completion, machine, r)
            acc.add(host, n_jobs=n)
            sum_r += float(r_host.sum())
            n_hedged += int((r_host > 0).sum())
        else:
            # -- online: epochs, probes, governor refits -----------------
            if refit_every % probe_every != 0:
                raise ValueError(
                    f"refit_every ({refit_every}) must be a multiple of "
                    f"probe_every ({probe_every}) so refits land exactly "
                    f"on epoch boundaries")
            from ..obs.tail import TailGovernor, TailRegistry
            gov = TailGovernor(
                deadline=float(np.median(reqs.D)), n_tasks=1, theta=theta,
                price=float(np.mean(reqs.C)), r_min=r_min,
                tau_est_frac=p.tau_est_frac,
                tau_kill_gap_frac=p.tau_kill_gap_frac, phi_est=p.phi_est,
                cadence=refit_every // probe_every,
                min_samples=min_samples, max_r=max_r,
                registry=TailRegistry(capacity=tail_capacity),
                window_name="serve",
                on_resolve=lambda sol, fit: fits.append(fit), device=dev)
            rid = np.asarray(reqs.rid)
            is_probe = rid % probe_every == 0
            # each epoch's hedged, then its probe positions in the epoch,
            # moved to the device once
            epoch_of = np.arange(n) // refit_every
            order = np.argsort(2 * epoch_of + is_probe, kind="stable")
            order_dev = torch.from_numpy(order % refit_every).to(dev)
            for lo in range(0, n, refit_every):
                hi = min(lo + refit_every, n)
                e = hi - lo
                epoch = dreqs.slice(lo, hi)
                probe = is_probe[lo:hi]
                n_probe = int(probe.sum())
                fit = gov.last_fit
                if strategy == "auto":
                    epoch_strategy = (gov.decision.strategy
                                      if gov.decision is not None
                                      else _UNHEDGED)
                else:
                    epoch_strategy = strategy
                if not optimized:
                    r, ch = zeros(e), zeros(e)
                elif r_override is not None:
                    r = torch.full((e,), int(r_override), dtype=torch.int32,
                                   device=dev)
                    ch = zeros(e)
                elif fit is None or epoch_strategy == _UNHEDGED:
                    epoch_strategy = _UNHEDGED   # cold: no tail belief yet
                    r, ch = zeros(e), zeros(e)
                else:
                    r, ch = _solve_epoch(
                        epoch_strategy, fit.t_min, fit.beta, epoch, p,
                        theta, r_min, max_r, refit_every)
                epoch_strategies.append(epoch_strategy)

                at = order_dev[lo:hi]
                completion = torch.empty(e, dtype=torch.float32, device=dev)
                machine = torch.empty(e, dtype=torch.float32, device=dev)
                for idx, strat, rr, cc in (
                        (at[:e - n_probe], epoch_strategy, r, ch),
                        (at[e - n_probe:], _UNHEDGED, zeros(e), zeros(e))):
                    if idx.numel() == 0:
                        continue
                    c, m = _serve_chunk(
                        source, stream, epoch.take(idx), rr[idx], cc[idx],
                        strategy=strat, **kw)
                    completion[idx], machine[idx] = c, m
                host, r_host = _host_result(epoch, completion, machine, r)
                if epoch_strategy != _UNHEDGED:
                    sum_r += float(r_host[~probe].sum())
                    n_hedged += int((r_host[~probe] > 0).sum())
                n_probes += n_probe
                acc.add(host, n_jobs=e)
                # the probes' completions drive observe -> refit ->
                # re-solve; the resolve fires on the epoch's last probe, so
                # the fresh fit and decision govern exactly the next epoch
                if r_override is None:
                    for x in host.job_completion[probe]:
                        gov.observe(float(x))

    result = acc.finalize(device=dev)
    return ServeOutput(
        strategy=requested, result=result,
        utility=float(net_utility(result.pocd, result.mean_cost,
                                  r_min, theta)),
        latency=latency_summary(result),
        mean_r=(sum_r / max(n_hedged, 1)), n_probes=n_probes,
        n_refits=len(fits), fits=tuple(fits),
        epoch_strategies=tuple(epoch_strategies))


def run_serve(source, reqs, p: Optional[SimParams] = None, *,
              theta: float = 1e-3, strategies=None,
              r_min_from_ns: bool = True, max_r: int = 8,
              oracle: bool = True, window: int = 256,
              refit_every: Optional[int] = None, probe_every: int = 8,
              r_override: Optional[int] = None, mesh=None, devices=None,
              tail_capacity: int = 2048, min_samples: int = 16,
              device=None):
    """Serve the stream under every strategy; the run_all of serving.

    Each strategy's stream is keyed by its own registry slot ("auto"
    borrows adaptive's), so subsetting the strategy list never perturbs
    another strategy's draws; r_min for utilities is the no-hedge PoCD
    less 1e-3 (the paper's R_min protocol). `devices=N` above 1 serves
    on `fleet.fleet_mesh(devices=N, device=device)`, a mesh of N points
    (more than the visible cards raises). Returns (outs, r_min), outs
    mapping strategy -> ServeOutput.
    """
    from ..fleet.mesh import fleet_mesh, mesh_device
    dev = resolve_device(device)
    if mesh is None and devices is not None and int(devices) > 1:
        mesh = fleet_mesh(devices=devices, device=device)
    dev = mesh_device(mesh, dev)
    reqs = _as_requests(reqs, dev)
    if p is None:
        p = SimParams()
    if strategies is None:
        strategies = names()
    kw = dict(theta=theta, max_r=max_r, oracle=oracle, window=window,
              refit_every=refit_every, probe_every=probe_every,
              mesh=mesh, tail_capacity=tail_capacity,
              min_samples=min_samples, device=dev)
    outs = {}
    r_min = 0.0
    if _UNHEDGED in strategies:
        outs[_UNHEDGED] = serve_trace(source, reqs, p, strategy=_UNHEDGED,
                                      r_min=0.0, **kw)
        if r_min_from_ns:
            r_min = float(outs[_UNHEDGED].result.pocd) - 1e-3
    for name in strategies:
        if name == _UNHEDGED:
            continue
        outs[name] = serve_trace(source, reqs, p, strategy=name,
                                 r_min=r_min, r_override=r_override, **kw)
    return outs, r_min
