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

Replications are built first, all at one width, and replayed together,
as the reference vmaps them: each pass is one `events.masked_dispatch`
over all replications, a stable key sort of each, one launch of the
dispatch kernel (`kernels/csrc/dispatch_scan.cu`) on the card with a
segment a replication, and the unsort. No pass reads a value back to the
host.
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


#: the most (window, replication) segments one dispatch launch takes:
#: the H100's 132 SMs, one segment a block
MAX_SEGMENTS = 132


def _stack(rows, fill):
    """(P, n) stack of (n_p,) rows, the short ones padded with `fill`."""
    n = max(r.shape[0] for r in rows)
    if all(r.shape[0] == n for r in rows):
        return torch.stack(rows)
    out = rows[0].new_full((len(rows), n), fill)
    for i, r in enumerate(rows):
        out[i, :r.shape[0]] = r
    return out


def _replay(segments, race: bool, slots: Optional[int], discipline: str,
            passes: int):
    """[(Realized, release, start)] for a list of at most MAX_SEGMENTS
    (table, jobs) segments: replications of one window, or of several
    windows (each with its own JobSet, T and width). Every segment is an
    independent replay on a pool of its own, idle at t = 0. Each dispatch
    pass is one `masked_dispatch` over all of them, so one launch on the
    card: (P, T) primaries, then (P, U) units, the shorter segments padded
    with inactive units (keyed +inf, never dispatched). `release` is what
    the final pass dispatched against, so wait = start - release is true
    queueing. Callers cut longer lists into groups, in order."""
    if len(segments) > MAX_SEGMENTS:
        raise ValueError(f"_replay: {len(segments)} segments, at most "
                         f"MAX_SEGMENTS = {MAX_SEGMENTS} a launch")
    tables = [t for t, _ in segments]
    Ts = [jobs.total_tasks for _, jobs in segments]
    holds = [predicted_holds(t, race, T) for t, T in zip(tables, Ts)]
    arrival = [jobs.arrival[t.job_id] for t, jobs in segments]
    if slots is None:
        release = [a + t.rel_offset for a, t in zip(arrival, tables)]
        return [(realize(t, r, r, h, race, T), r, r)
                for t, r, h, T in zip(tables, release, holds, Ts)]

    deadline = [(jobs.arrival + jobs.D)[t.job_id] for t, jobs in segments]
    act_prim = [primary_slice(t.active & t.is_primary, T)
                for t, T in zip(tables, Ts)]
    prim = lambda xs: [primary_slice(x, T) for x, T in zip(xs, Ts)]
    unstack = lambda x, xs: [x[i, :r.shape[0]] for i, r in enumerate(xs)]
    starts = masked_dispatch(slots, discipline, _stack(prim(arrival), 0.0),
                             _stack(prim(holds), 0.0),
                             _stack(act_prim, False),
                             _stack(prim(deadline), 0.0))
    release = [combined_release(t, a, ap, s) for t, a, ap, s in
               zip(tables, arrival, act_prim, unstack(starts, act_prim))]
    hold = _stack(holds, 0.0)
    active = _stack([t.active for t in tables], False)
    deadline = _stack(deadline, 0.0)
    for i in range(passes - 1):
        start = unstack(masked_dispatch(slots, discipline, _stack(release,
                                                                  0.0),
                                        hold, active, deadline), holds)
        if i < passes - 2:      # refreshed only for a pass that reads it
            release = [combined_release(t, a, ap, primary_slice(s, T))
                       for t, a, ap, s, T in
                       zip(tables, arrival, act_prim, start, Ts)]
    return [(realize(t, r, s, h, race, T), r, s)
            for t, r, s, h, T in zip(tables, release, start, holds, Ts)]


def replay(table: AttemptTable, race: bool, jobs: JobSet,
           slots: Optional[int], discipline: str = "fifo", passes: int = 2,
           *, device=None):
    """Replay an AttemptTable through the slot pool on `device` (default
    the card); returns (Realized, release, start). `passes` counts all
    passes: pass 1 is primaries only, so at least one combined pass
    (passes >= 2) is needed for copies to acquire a slot."""
    _check_args(passes, discipline)
    dev = resolve_device(device)
    return _replay([(AttemptTable(*(x.to(dev) for x in table)),
                     jobset_to(jobs, dev))], race, slots, discipline,
                   passes)[0]


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


def segment_outcome(jobs: JobSet, table: AttemptTable, replayed,
                    slots: Optional[int], collect_metrics: bool):
    """One replayed segment's (SimResult, (mean_wait, max_wait,
    utilization, preempted), CapacityMetrics or None), on its device and
    with no host read; `replayed` is `_replay`'s (Realized, release,
    start) for `table` over `jobs`."""
    realized, release, start = replayed
    completion = realized.task_completion - jobs.arrival[jobs.job_id]
    res = aggregate(jobs, completion, realized.task_machine)
    n_active = torch.clamp(table.active.to(torch.float32).sum(), min=1.0)
    q = (realized.wait.sum() / n_active, realized.wait.amax(),
         (utilization(realized.busy_time, slots, realized.span)
          if slots is not None
          else torch.zeros((), device=completion.device)),
         realized.preempted)
    m = (capacity_metrics(table, release, start, realized)
         if collect_metrics else None)
    return res, q, m


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

    def table_of(rep):
        draw = lambda name, shape: source.uniform(strategy, rep, name, shape,
                                                  dev)
        table = spec.build_table(draw, jobs, r_task, choice_task, p,
                                 max_r=max_r, oracle=oracle)
        if admitted is not None:
            table = table._replace(
                active=table.active & admitted[table.job_id])
        return _narrow_table(table, T, width)

    results, queues, metrics = [], [], []
    for g0 in range(0, reps, MAX_SEGMENTS):
        tables = [table_of(rep)
                  for rep in range(g0, min(reps, g0 + MAX_SEGMENTS))]
        for table, replayed in zip(
                tables, _replay([(t, jobs) for t in tables], spec.race,
                                slots, discipline, passes)):
            res, q, m = segment_outcome(jobs, table, replayed, slots,
                                        collect_metrics)
            results.append(res)
            queues.append(QueueMetrics(*q, admitted_frac=admitted_frac,
                                       slots=None))
            if collect_metrics:
                metrics.append(m)
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
                *, device=None, devices=None, mesh=None, chunk_jobs=None,
                chaos=None, checkpoint=None, resume: bool = False):
    """Finite-capacity mirror of `sim.runner.run_all` on `device`
    (default the card). Returns ({name: ClusterOutput}, r_min).

    `jobs` is a JobSet or a workload scenario's name (its default size and
    seed). `strategies=None` runs every registered strategy in registry
    order; R_min is Hadoop-NS's PoCD minus 1e-3. With slots=None this is
    `run_all` draw for draw; with finite slots the same draws queue on
    the pool. `admission` rejects jobs before any strategy runs.

    `devices=`, `mesh=` or `chunk_jobs=` route to the fleet layer
    (`repro_torch.fleet.run_cluster_fleet`): windows of `chunk_jobs`
    consecutive jobs, each on its own pool, admission and the governor
    per window, every (window, replication) a segment of one dispatch
    launch. `devices=N` above 1 splits the replications over
    `fleet.fleet_mesh(devices=N, reps=reps, device=device)`.
    `chaos=`, `checkpoint=` and `resume=` route there too: fault
    injection with window-boundary checkpoint and resume
    (`repro_torch.chaos`).
    """
    if (devices is not None or mesh is not None or chunk_jobs is not None
            or chaos is not None or checkpoint is not None or resume):
        from ..fleet import fleet_mesh, run_cluster_fleet
        if mesh is None and devices is not None and int(devices) > 1:
            mesh = fleet_mesh(devices=devices, reps=reps, device=device)
        return run_cluster_fleet(
            source, jobs, p, slots=slots, theta=theta,
            strategies=strategies, r_min_from_ns=r_min_from_ns,
            max_r=max_r, oracle=oracle, discipline=discipline,
            passes=passes, governor=governor, admission=admission,
            reps=reps, mesh=mesh, chunk_jobs=chunk_jobs,
            collect_metrics=collect_metrics, chaos=chaos,
            checkpoint=checkpoint, resume=resume, budget=budget,
            device=device)
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
