"""Strategy execution under finite capacity; counterpart of
`repro.cluster.engine`.

Every registered strategy lowers to an AttemptTable through its spec's
`build_table`, which draws exactly what its Monte-Carlo sim draws, so at
`slots=None` (infinite capacity) the replay reproduces `run_all` draw for
draw; with finite slots the same draws queue on a bounded pool, exposing
queueing delay, utilization, and what speculation costs under load.

The replay is a small fixed-point relaxation (default 2 passes):

  pass 1  schedules primary attempts only (release = job arrival), on the
          T-row primary slice of the table;
  pass k  recomputes speculative releases as primary start + rel_offset
          and reschedules the combined unit set in dispatch order.

Each pass is one `events.masked_dispatch`: a stable key sort, one launch
of the dispatch kernel (`kernels/csrc/dispatch_scan.cu`) on the card, and
the unsort. No pass reads a value back to the host. Replications are a
loop, as in the port's runner; the reference vmaps them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..coupled.solver import solve_jobs_coupled, warn_infeasible
from ..device import resolve_device
from ..obs import trace as obs_trace
from ..obs.metrics import CapacityMetrics, capacity_metrics, reduce_reps
from ..sim.metrics import SimResult, aggregate, mean_over_reps, net_utility
from ..sim.runner import jobspecs_of
from ..sim.strategies import SimParams
from ..sim.trace import JobSet, jobset_to
from ..strategies import get, names, solve_jobs
from ..strategies.table import AttemptTable
from .admission import (AdmissionConfig, GovernorConfig, admit_jobs,
                        apply_governor)
from .events import masked_dispatch, predicted_holds, realize
from .slots import DISCIPLINES, utilization


class QueueMetrics(NamedTuple):
    mean_wait: torch.Tensor      # mean slot-acquisition delay over attempts
    max_wait: torch.Tensor
    utilization: torch.Tensor    # busy slot-time / (slots * makespan)
    preempted: torch.Tensor      # attempts killed before finishing
    admitted_frac: torch.Tensor  # fraction of jobs admitted
    slots: Optional[int]         # None = infinite capacity


class ClusterOutput(NamedTuple):
    result: SimResult
    r_opt: torch.Tensor
    utility: torch.Tensor
    theory_pocd: torch.Tensor
    theory_cost: torch.Tensor
    queue: QueueMetrics
    metrics: Optional[CapacityMetrics] = None   # collect_metrics=True runs
    n_saturated: int = 0        # jobs whose r* hit the grid edge
    coupled: Optional[object] = None            # budget= runs


def _check_args(passes: int, discipline: str) -> None:
    if passes < 2:
        raise ValueError(f"passes must be >= 2 (pass 1 schedules primaries "
                         f"only), got {passes}")
    if discipline not in DISCIPLINES:
        raise ValueError(f"unknown discipline {discipline!r}; "
                         f"expected one of {DISCIPLINES}")


def _solve(jobs: JobSet, strategy: str, p: SimParams, theta, r_min,
           max_r: int, slots, governor, budget):
    """(r_j, choice_j, theory pocd, theory cost * C, n_sat, coupled info)
    on the JobSet's device: the grid-solve kernel, or the joint budget
    solve with `budget=`; the governor scales theta first."""
    specs = jobspecs_of(jobs, p, theta, r_min)
    if governor is not None and slots is not None:
        specs = apply_governor(specs, jobs, slots, governor)
    dev = jobs.t_min.device
    info = None
    if budget is not None:
        (r_j, choice_j, _, th_p, th_c, sat_j), info = solve_jobs_coupled(
            strategy, specs, max_r + 1, budget, device=dev)
    else:
        r_j, choice_j, _, th_p, th_c, sat_j = solve_jobs(
            strategy, specs, max_r + 1, device=dev)
    return r_j, choice_j, th_p, th_c * specs.C, int(sat_j.sum()), info


def build_strategy_table(source, jobs: JobSet, strategy: str, p: SimParams,
                         theta=1e-4, r_min=0.0, max_r: int = 8, *,
                         device=None):
    """(AttemptTable, race) for a strategy at its solved r*, drawing from
    `source` as the first replication does; the table is max_r + 1 wide
    (not narrowed)."""
    dev = resolve_device(device)
    jobs = jobset_to(jobs, dev)
    spec = get(strategy)
    if spec.optimized:
        r_j, choice_j = _solve(jobs, strategy, p, theta, r_min, max_r, None,
                               None, None)[:2]
    else:
        r_j = choice_j = torch.zeros(jobs.n_jobs, dtype=torch.int32,
                                     device=dev)
    draw = lambda name, shape: source.uniform(strategy, 0, name, shape, dev)
    table = spec.build_table(draw, jobs, r_j[jobs.job_id],
                             choice_j[jobs.job_id], p, max_r=max_r,
                             oracle=True)
    return table, spec.race


def primary_slice(x: torch.Tensor, n_tasks: int) -> torch.Tensor:
    """The (T,) primary column of a (U,) unit column: by the layout
    contract, row t*A + a is attempt a of task t and attempt 0 the
    primary, so pass 1 (primaries only) runs on a T-row slice."""
    U = x.shape[0]
    if U % n_tasks:
        raise ValueError(f"the AttemptTable must be attempt-major with one "
                         f"width (U={U} is no multiple of T={n_tasks})")
    return x.view(n_tasks, U // n_tasks)[:, 0]


def combined_release(table: AttemptTable, arrival_u, act_prim, prim_starts):
    """Each unit's release for a combined pass: job arrival for
    primaries, the primary's start + rel_offset for the others."""
    ps = torch.where(act_prim, prim_starts, 0.0)
    return torch.where(table.is_primary, arrival_u,
                       ps[table.task_id] + table.rel_offset)


def _replay(table: AttemptTable, race: bool, jobs: JobSet,
            slots: Optional[int], discipline: str, passes: int):
    """(Realized, release, start): the release the final pass dispatched
    against, so wait = start - release is true queueing."""
    T = jobs.total_tasks
    sched_hold = predicted_holds(table, race, T)
    arrival_u = jobs.arrival[table.job_id]
    if slots is None:
        release = arrival_u + table.rel_offset
        return (realize(table, release, release, sched_hold, race, T),
                release, release)

    deadline_u = (jobs.arrival + jobs.D)[table.job_id]
    act_prim = primary_slice(table.active & table.is_primary, T)
    release = combined_release(table, arrival_u, act_prim, masked_dispatch(
        slots, discipline, primary_slice(arrival_u, T),
        primary_slice(sched_hold, T), act_prim,
        primary_slice(deadline_u, T)))
    for i in range(passes - 1):
        start = masked_dispatch(slots, discipline, release, sched_hold,
                                table.active, deadline_u)
        if i < passes - 2:      # refreshed only for a pass that reads it
            release = combined_release(table, arrival_u, act_prim,
                                       primary_slice(start, T))
    return (realize(table, release, start, sched_hold, race, T), release,
            start)


def replay(table: AttemptTable, race: bool, jobs: JobSet,
           slots: Optional[int], discipline: str = "fifo", passes: int = 2,
           *, device=None):
    """Replay an AttemptTable through the slot pool on `device` (default
    the card); returns (Realized, release, start). `passes` counts all
    passes: pass 1 is primaries only, so at least one combined pass
    (passes >= 2) is needed for copies to acquire a slot."""
    _check_args(passes, discipline)
    dev = resolve_device(device)
    return _replay(AttemptTable(*(x.to(dev) for x in table)), race,
                   jobset_to(jobs, dev), slots, discipline, passes)


def _narrow_table(table: AttemptTable, n_tasks: int,
                  width: Optional[int]) -> AttemptTable:
    """The table's first `width` attempt columns. Builders draw max_r-wide
    tables so the draws never depend on r*; the replay's per-unit work
    (the dispatch sort above all) is O(T * width), and the dropped columns
    are inactive for every task when width > max(r*) + 1."""
    A = table.task_id.shape[0] // n_tasks
    if width is None or width >= A:
        return table
    return AttemptTable(*(x.view(n_tasks, A)[:, :width].reshape(-1)
                          for x in table))


def _mean_queue(queues) -> QueueMetrics:
    fields = QueueMetrics._fields[:-1]
    return QueueMetrics(
        *(torch.stack([getattr(q, f).to(torch.float32) for q in queues])
          .sum(dim=0) / len(queues) for f in fields), slots=None)


def _cluster_core(source, jobs: JobSet, strategy: str, p: SimParams, theta,
                  r_min, r_j, choice_j, th_p, th_c, admitted, slots,
                  discipline: str, passes: int, max_r: int, oracle: bool,
                  reps: int, width, collect_metrics: bool) -> ClusterOutput:
    """Table build, capacity replay and metrics for `reps` replications."""
    dev = jobs.t_min.device
    spec = get(strategy)
    J, T = jobs.n_jobs, jobs.total_tasks
    if r_j is None:
        r_j = choice_j = torch.zeros(J, dtype=torch.int32, device=dev)
        th_p = th_c = torch.zeros(J, device=dev)
    admitted_frac = (torch.ones((), device=dev) if admitted is None else
                     admitted.to(torch.float32).sum() / J)
    r_task, choice_task = r_j[jobs.job_id], choice_j[jobs.job_id]
    results, queues, metrics = [], [], []
    for rep in range(reps):
        draw = lambda name, shape, rep=rep: source.uniform(
            strategy, rep, name, shape, dev)
        table = spec.build_table(draw, jobs, r_task, choice_task, p,
                                 max_r=max_r, oracle=oracle)
        if admitted is not None:
            table = table._replace(
                active=table.active & admitted[table.job_id])
        table = _narrow_table(table, T, width)
        realized, release, start = _replay(table, spec.race, jobs, slots,
                                           discipline, passes)
        completion = realized.task_completion - jobs.arrival[jobs.job_id]
        results.append(aggregate(jobs, completion, realized.task_machine))
        n_active = torch.clamp(table.active.to(torch.float32).sum(),
                               min=1.0)
        queues.append(QueueMetrics(
            mean_wait=realized.wait.sum() / n_active,
            max_wait=realized.wait.amax(),
            utilization=(utilization(realized.busy_time, slots,
                                     realized.span) if slots is not None
                         else torch.zeros((), device=dev)),
            preempted=realized.preempted, admitted_frac=admitted_frac,
            slots=None))
        if collect_metrics:
            metrics.append(capacity_metrics(table, release, start, realized))
    if reps == 1:
        res, queue = results[0], queues[0]
    else:
        res, queue = mean_over_reps(results), _mean_queue(queues)
    return ClusterOutput(
        result=res, r_opt=r_j,
        utility=net_utility(res.pocd, res.mean_cost, r_min, theta),
        theory_pocd=th_p, theory_cost=th_c, queue=queue,
        metrics=reduce_reps(metrics) if collect_metrics else None)


def run_cluster_strategy(source, jobs: JobSet, strategy: str, p: SimParams,
                         slots: Optional[int] = None, theta=1e-4, r_min=0.0,
                         max_r: int = 8, oracle: bool = True,
                         discipline: str = "fifo", passes: int = 2,
                         governor: Optional[GovernorConfig] = None,
                         admitted=None, reps: int = 1,
                         collect_metrics: bool = False, budget=None, *,
                         device=None) -> ClusterOutput:
    """Solve r* (on the card, the grid-solve kernel; with `budget=`, the
    joint budget solve), then build and replay `reps` replications on
    `device` (default the card); `source` hands out the uniforms
    (`sim.draws`).

    `governor` scales theta by the windowed load before the solve;
    `admitted` ((J,) bool) keeps rejected jobs' units out of the pool
    (they cost 0 and miss). An optimized strategy's table is narrowed to
    max(r*) + 2 columns (one host read of r*). With reps > 1 the
    SimResult and QueueMetrics are Monte-Carlo means (job_met becomes a
    met frequency). The solve is the span `cluster.solve`, the replay
    `cluster.replay[<strategy>]`.
    """
    _check_args(passes, discipline)
    dev = resolve_device(device)
    jobs = jobset_to(jobs, dev)
    spec = get(strategy)
    if not spec.detectable:
        oracle = True
    r_j = choice_j = th_p = th_c = width = None   # baselines: minimal width
    n_sat, info = 0, None
    if spec.optimized:
        with obs_trace.span("cluster.solve", strategy=strategy,
                            n_jobs=jobs.n_jobs):
            r_j, choice_j, th_p, th_c, n_sat, info = _solve(
                jobs, strategy, p, theta, r_min, max_r, slots, governor,
                budget)
            width = int(r_j.max()) + 2
        if info is not None:
            warn_infeasible(strategy, info)
    adm = (None if admitted is None else
           torch.as_tensor(admitted, dtype=torch.bool, device=dev))
    out = obs_trace.fenced(
        f"cluster.replay[{strategy}]", _cluster_core, source, jobs,
        strategy, p, theta, r_min, r_j, choice_j, th_p, th_c, adm, slots,
        discipline, passes, max_r, oracle, reps, width, collect_metrics)
    return out._replace(queue=out.queue._replace(slots=slots),
                        n_saturated=n_sat, coupled=info)


def run_cluster(source, jobs, p: SimParams, slots: Optional[int] = None,
                theta=1e-4, strategies=None, r_min_from_ns: bool = True,
                max_r: int = 8, oracle: bool = True,
                discipline: str = "fifo", passes: int = 2,
                governor: Optional[GovernorConfig] = None,
                admission: Optional[AdmissionConfig] = None,
                reps: int = 1, collect_metrics: bool = False, budget=None,
                *, device=None):
    """Finite-capacity mirror of `sim.runner.run_all` on `device`
    (default the card). Returns ({name: ClusterOutput}, r_min).

    `jobs` is a JobSet or a workload scenario's name (its default size and
    seed). `strategies=None` runs every registered strategy in registry
    order; R_min is Hadoop-NS's PoCD minus 1e-3. With slots=None this is
    `run_all` draw for draw; with finite slots the same draws queue on
    the pool. `admission` rejects jobs before any strategy runs.
    """
    dev = resolve_device(device)
    if isinstance(jobs, str):
        from ..workloads.registry import make_jobset
        jobs = make_jobset(jobs, device=dev)
    jobs = jobset_to(jobs, dev)
    if strategies is None:
        strategies = names()
    admitted = None
    if admission is not None and slots is not None:
        admitted = admit_jobs(jobs, slots, admission)
    kw = dict(slots=slots, theta=theta, max_r=max_r, oracle=oracle,
              discipline=discipline, passes=passes, governor=governor,
              admitted=admitted, reps=reps,
              collect_metrics=collect_metrics, budget=budget, device=dev)
    outs = {}
    r_min = 0.0
    if "hadoop_ns" in strategies:
        outs["hadoop_ns"] = run_cluster_strategy(source, jobs, "hadoop_ns",
                                                 p, r_min=0.0, **kw)
        if r_min_from_ns:
            r_min = float(outs["hadoop_ns"].result.pocd) - 1e-3
    for name in strategies:
        if name != "hadoop_ns":
            outs[name] = run_cluster_strategy(source, jobs, name, p,
                                              r_min=r_min, **kw)
    return outs, r_min
