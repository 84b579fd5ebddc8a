"""Windowed finite-capacity execution (the cluster engine's fleet);
counterpart of `repro.fleet.cluster`.

Under a shared slot pool every job contends with every other, so the job
axis cannot be split without changing the queueing; the capacity fleet
streams the trace instead in windows of `chunk_jobs` consecutive jobs,
each replayed on a slot pool of its own (idle at t = 0), and combines
PoCD, cost and queue metrics with `sim.metrics.StreamCombiner`. Traces
are arrival-sorted, so windows are time-contiguous and cross-window
contention is ignored (exact when windows last much longer than the
queue takes to drain). Admission and the r* governor run per window.

Replication i of every window draws through
`sim.draws.uniform_cell(source, strategy, i, None, ...)` (the cell
`NO_BLOCK` of `source.uniform_rows`, rows 0..T-1), as the reference keys
it by fold_in(strategy_key, i) alone: windows share their replications'
streams (ROADMAP C notes the correlation).

Every (window, replication) pair is an independent replay, so the pairs
are the segments of the batched dispatch launch
(`cluster.engine._replay`): at most `engine.MAX_SEGMENTS` of them a
launch, windows taken in order, shorter windows padded with inactive
units. Per-replication means and the window combination run on the host
in numpy in one fixed order (`_rep_mean`, `obs.metrics`), never as a
reduction over the stacked segments.

On a fleet mesh the replications are padded to the mesh's size and split
over every point, "rep" and "job" flattened (`rep_shares`, the
reference's P(("rep", "job"))): each point builds and replays its own
segments in its own launches, one group on every point a round, and the
outcomes meet on the first point, which solves the windows.

`chaos=` and `checkpoint=` act at window boundaries, as in the flat
fleet (`runner.py`). A launch takes one pool size, so under a chaos
context each window's replications are launched on their own (in groups
of at most MAX_SEGMENTS): the retry, the integrity check and a
`slot_change` then cover exactly one window, as in the reference. That
costs the batching across windows; without `chaos=` the grouping is the
chaos-free one, with a checkpoint or without.
"""
from __future__ import annotations

from itertools import zip_longest
from typing import Optional

import numpy as np
import torch

from ..cluster import engine
from ..cluster.admission import (AdmissionConfig, GovernorConfig,
                                 admit_jobs, apply_governor)
from ..cluster.engine import ClusterOutput, QueueMetrics, _narrow_table
from ..cluster.slots import DISCIPLINES
from ..ckpt.checkpoint import tree_leaves, tree_rebuild
from ..coupled.solver import solve_jobs_coupled, warn_infeasible
from ..device import resolve_device, to_host
from ..obs import trace as obs_trace
from ..obs.metrics import reduce_reps_host
from ..sim.draws import uniform_cell
from ..sim.metrics import net_utility
from ..sim.runner import jobspecs_of
from ..sim.trace import jobset_to
from ..strategies import get, names, solve_jobs
from .mesh import mesh_device, pad_count, split_range
from .runner import (_warn_saturated, chunk_hooks, chunk_jobset,
                     end_of_chunk, job_columns, resume_point, scale_cost,
                     scenario_plan, strategy_hooks)


def _rep_mean(tree, reps: int):
    """Host epilogue over a tuple of per-replication leaves: drop padded
    replications, then mean the rest in numpy f32 in replication order
    (bool leaves become frequencies)."""
    host = tuple(np.stack([to_host(x) for x in leaf])[:reps] for leaf in tree)
    if reps == 1:
        return tuple(x[0] for x in host)
    return tuple(np.mean(x.astype(np.float32), axis=0) for x in host)


def rep_shares(mesh, dev, reps_pad: int) -> list:
    """[(device, (r0, r1))]: each point's contiguous replications of
    `reps_pad`, over the mesh's "rep" and "job" axes flattened (the
    reference's P(("rep", "job"))); without a mesh, all of them on
    `dev`."""
    if mesh is None:
        return [(dev, (0, reps_pad))]
    return [(d, split_range(reps_pad, mesh.size, k))
            for k, d in enumerate(mesh.devices)]


def _to(tree, dev):
    """A segment outcome's tensors moved to `dev` (a no-op there)."""
    return tree_rebuild(tree, iter([
        x.to(dev) if isinstance(x, torch.Tensor) else x
        for x in tree_leaves(tree)]))


def _window_specs(cjobs, p, theta, r_min, slots, governor,
                  cost_scale: float = 1.0):
    """One window's solve inputs, as the flat `run_cluster_strategy`
    forms them: C re-priced by the elastic governor's `cost_scale` first,
    then the governor scales theta by the window's load."""
    specs = scale_cost(jobspecs_of(cjobs, p, theta, r_min), cost_scale)
    if governor is not None and slots is not None:
        specs = apply_governor(specs, cjobs, slots, governor)
    return specs


def _solve_window(cjobs, strategy, p, theta, r_min, max_r, slots, governor,
                  cost_scale: float = 1.0):
    """(r_j, choice_j, th_p, th_c, sat) of one window on its device."""
    J = cjobs.n_jobs
    dev = cjobs.t_min.device
    if not get(strategy).optimized:
        zeros = torch.zeros(J, dtype=torch.int32, device=dev)
        return zeros, zeros, torch.zeros(J, device=dev), \
            torch.zeros(J, device=dev), zeros
    specs = _window_specs(cjobs, p, theta, r_min, slots, governor,
                          cost_scale)
    r_j, choice_j, _, th_p, th_c, sat = solve_jobs(strategy, specs,
                                                   max_r + 1, device=dev)
    return r_j, choice_j, th_p, th_c * specs.C, sat


def run_cluster_fleet_strategy(source, jobs, strategy: str, p, *,
                               mesh=None, slots: Optional[int] = None,
                               theta=1e-4, r_min=0.0, max_r: int = 8,
                               oracle: bool = True,
                               discipline: str = "fifo", passes: int = 2,
                               governor: Optional[GovernorConfig] = None,
                               admission: Optional[AdmissionConfig] = None,
                               reps: int = 1, chunk_jobs=None,
                               pad_to: Optional[int] = None,
                               collect_metrics: bool = False,
                               chaos=None, checkpoint=None,
                               resume: bool = False, fused: bool = True,
                               budget=None, device=None) -> ClusterOutput:
    """Fleet mirror of `cluster.engine.run_cluster_strategy` on `device`
    (default the card): `chunk_jobs` consecutive jobs a window, each on
    its own pool. `pad_to` (int) pads the replication count to a multiple
    for the pad+mask tests (mesh=None only).

    mesh: a `FleetMesh` or None. Replications are padded to the mesh's
    size and split over every point ("rep" and "job" flattened); each
    point builds and replays its (window, replication) segments in its
    own dispatch launches, and the outcomes meet on the first point,
    which solves each window and holds the outputs. The bits equal the
    run without a mesh.

    fused=True (default) solves each window when it is first replayed and
    gives an optimized strategy the static width max_r + 2; fused=False
    solves every window first and narrows to the largest solved r* + 2.
    Both give the same bits (`_narrow_table` drops inactive columns only).
    Baselines take the minimal width. `budget=` is one joint solve over
    every window's (governed) specs before any replay.

    chaos / checkpoint / resume: as in `runner.run_fleet_strategy`, at
    window granularity. A `slot_change` moves the pool of every window
    from its own on (the replay, admission, the governor and
    `QueueMetrics.slots` all take the window's pool), the elastic
    governor re-prices each window's solve, and a resumed run gives the
    uninterrupted run's bits, queue metrics and per-window slots
    included.
    """
    if passes < 2:
        raise ValueError(f"passes must be >= 2 (pass 1 schedules primaries "
                         f"only), got {passes}")
    if discipline not in DISCIPLINES:
        raise ValueError(f"unknown discipline {discipline!r}; "
                         f"expected one of {DISCIPLINES}")
    if pad_to is not None and mesh is not None:
        raise ValueError("pad_to is a test-only override; incompatible "
                         "with an explicit mesh")
    if resume and checkpoint is None:
        raise ValueError("resume=True requires a checkpoint config")
    dev = mesh_device(mesh, resolve_device(device))
    spec = get(strategy)
    if not spec.detectable:
        oracle = True
    if budget is not None and not spec.optimized:
        budget = None     # baselines run at r = 0: nothing to budget
    if budget is not None and chaos is not None:
        raise ValueError(
            "budget= requires a chaos-free run: the shared multiplier is "
            "solved once over the whole trace, and chaos re-pricing or "
            "slot/mesh loss mid-run would invalidate that global solve")
    # the replication padding for mesh m; derived again when chaos
    # shrinks it
    reps_of = lambda m: pad_count(reps, pad_to if pad_to is not None
                                  else (m.size if m is not None else 1))

    cols = job_columns(jobs)
    J = cols.n_jobs
    chunk = J if chunk_jobs is None else max(1, int(chunk_jobs))
    n_chunks = -(-J // chunk)
    bounds = [(ci * chunk, min((ci + 1) * chunk, J))
              for ci in range(n_chunks)]
    window_jobs = lambda ci: chunk_jobset(cols, *bounds[ci], device=dev)
    ctx, saver, fp = chunk_hooks(
        chaos, checkpoint, source, n_chunks, mesh, pool=slots,
        path="cluster", strategy=strategy, n_jobs=J, chunk=chunk, reps=reps,
        max_r=max_r, oracle=oracle, theta=float(theta), r_min=float(r_min),
        slots=slots, discipline=discipline, passes=passes,
        budget=None if budget is None else float(budget))
    # the window's pool and cost scale (the caller's without chaos)
    slots_of = lambda ci: (slots if ctx is None
                           else ctx.slots_at(ci, slots))
    scale_of = lambda ci: 1.0 if ctx is None else ctx.cost_scale(ci)

    use_fused = fused and spec.optimized and budget is None
    solves = info = None
    if budget is not None:
        # one joint solve over every window's governed specs, so chunked
        # equals monolithic: each window replays its slice
        with obs_trace.span("fleet.cluster.coupled_solve",
                            strategy=strategy, n_jobs=J, n_chunks=n_chunks):
            parts = [_window_specs(window_jobs(ci), p, theta, r_min, slots,
                                   governor) for ci in range(n_chunks)]
            gspecs = type(parts[0])(*(torch.cat(xs) for xs in zip(*parts)))
            (g_r, g_ch, _, g_p, g_c, g_sat), info = solve_jobs_coupled(
                strategy, gspecs, max_r + 1, budget, device=dev)
            g = (g_r, g_ch, g_p, g_c * gspecs.C, g_sat)
            solves = [tuple(a[lo:hi] for a in g) for lo, hi in bounds]
        warn_infeasible(strategy, info)
    elif not use_fused:
        # every window first, so width="auto" is one value for all
        with obs_trace.span("fleet.cluster.solve", strategy=strategy,
                            n_jobs=J, n_chunks=n_chunks):
            solves = [_solve_window(window_jobs(ci), strategy, p, theta,
                                    r_min, max_r, slots_of(ci), governor,
                                    scale_of(ci))
                      for ci in range(n_chunks)]
    if not spec.optimized:
        width = None
    elif use_fused:
        # r* <= max_r, and narrowing drops inactive columns only
        width = max_r + 2
    else:
        width = max(int(s[0].max()) for s in solves) + 2

    windows = {}

    def open_window(ci):
        cjobs = window_jobs(ci)
        slots_w = slots_of(ci)
        admitted = None
        if admission is not None and slots_w is not None:
            admitted = torch.from_numpy(
                admit_jobs(cjobs, slots_w, admission)).to(dev)
        if use_fused:
            solved = _solve_window(cjobs, strategy, p, theta, r_min, max_r,
                                   slots_w, governor, scale_of(ci))
        else:
            solved = solves[ci]
        r_j, choice_j = solved[0], solved[1]
        home = dict(jobs=cjobs, admitted=admitted, r_task=r_j[cjobs.job_id],
                    c_task=choice_j[cjobs.job_id])
        return dict(jobs=cjobs, slots=slots_w, admitted=admitted,
                    solved=solved, at={dev: home}, out={})

    def window_at(ci, pdev):
        """Window ci's replay inputs on point device `pdev`: copies of
        the first point's."""
        at = windows[ci]["at"]
        if pdev not in at:
            home = at[dev]
            at[pdev] = dict(
                jobs=jobset_to(home["jobs"], pdev),
                admitted=(None if home["admitted"] is None
                          else home["admitted"].to(pdev)),
                r_task=home["r_task"].to(pdev),
                c_task=home["c_task"].to(pdev))
        return at[pdev]

    def table_of(ci, rep, pdev):
        w = window_at(ci, pdev)
        cjobs = w["jobs"]
        draw = lambda name, shape: uniform_cell(
            source, strategy, rep, None, name, shape, pdev)
        table = spec.build_table(draw, cjobs, w["r_task"], w["c_task"], p,
                                 max_r=max_r, oracle=oracle)
        if w["admitted"] is not None:
            table = table._replace(
                active=table.active & w["admitted"][table.job_id])
        return _narrow_table(table, cjobs.total_tasks, width)

    start, acc, (r_parts, thp_parts, thc_parts), mesh = resume_point(
        saver if resume else None, fp, ctx, mesh, reps)
    reps_pad = reps_of(mesh)
    n_sat = 0

    def close_window(ci):
        w = windows.pop(ci)
        cjobs = w["jobs"]
        out = [w["out"][rep] for rep in sorted(w["out"])]
        with obs_trace.span("fleet.cluster.reduce", window=ci):
            res = _rep_mean(zip(*[o[0] for o in out]), reps)
            q = _rep_mean(zip(*[o[1] for o in out]), reps)
            window_metrics = None
            if collect_metrics:
                stacked = type(out[0][2])(*(torch.stack(xs) for xs in
                                            zip(*[o[2] for o in out])))
                window_metrics = reduce_reps_host(stacked, reps)
            admitted_frac = (1.0 if w["admitted"] is None else
                             float(np.mean(to_host(w["admitted"]))))
            f32 = lambda v: torch.tensor(np.float32(v), device=dev)
            queue = QueueMetrics(
                mean_wait=f32(q[0]), max_wait=f32(q[1]),
                utilization=f32(q[2]), preempted=f32(q[3]),
                admitted_frac=f32(admitted_frac), slots=w["slots"])
            acc.add(type(out[0][0])(*res), n_jobs=cjobs.n_jobs, queue=queue,
                    capacity=window_metrics)
        r_j, _, th_p, th_c, sat_j = w["solved"]
        r_parts.append(to_host(r_j))
        thp_parts.append(to_host(th_p))
        thc_parts.append(to_host(th_c))
        n = int(to_host(sat_j).sum()) if spec.optimized else 0
        end_of_chunk(ci, n_chunks, ctx, saver, fp, acc,
                     (r_parts, thp_parts, thc_parts))
        return n

    def replay_group(group, pdev):
        """The outcomes of (window, replication) segments that share one
        pool size, in one dispatch launch a pass on point device `pdev`,
        moved to the first point."""
        with obs_trace.span("fleet.cluster.build", strategy=strategy,
                            segments=len(group)):
            for ci, _ in group:
                if ci not in windows:
                    windows[ci] = open_window(ci)
            tables = [table_of(ci, rep, pdev) for ci, rep in group]
        slots_g = windows[group[0][0]]["slots"]
        jobs_of = lambda ci: window_at(ci, pdev)["jobs"]
        replayed = obs_trace.fenced(
            f"fleet.cluster.replay[{strategy}]", engine._replay,
            [(t, jobs_of(ci)) for t, (ci, _) in zip(tables, group)],
            spec.race, slots_g, discipline, passes)
        return [_to(engine.segment_outcome(jobs_of(ci), table, rp, slots_g,
                                           collect_metrics), dev)
                for (ci, _), table, rp in zip(group, tables, replayed)]

    def point_groups(windows_of, reps_pad):
        """Each point's segments of windows `windows_of`, in order, cut
        into launch groups of at most MAX_SEGMENTS: [[(pdev, group)]]."""
        cap = engine.MAX_SEGMENTS
        out = []
        for pdev, (r0, r1) in rep_shares(mesh, dev, reps_pad):
            segs = [(ci, rep) for ci in windows_of for rep in range(r0, r1)]
            out.append([(pdev, segs[g0:g0 + cap])
                        for g0 in range(0, len(segs), cap)])
        return out

    try:
        if ctx is None:
            # every point's (window, replication) segments in order,
            # MAX_SEGMENTS a launch; each round launches one group on
            # every point, then the windows it completed close in order
            next_ci = start
            for rnd in zip_longest(*point_groups(range(start, n_chunks),
                                                 reps_pad)):
                for pdev, group in filter(None, rnd):
                    for (ci, rep), o in zip(group,
                                            replay_group(group, pdev)):
                        windows[ci]["out"][rep] = o
                while (next_ci in windows
                       and len(windows[next_ci]["out"]) == reps_pad):
                    n_sat += close_window(next_ci)
                    next_ci += 1
        else:
            for ci in range(start, n_chunks):
                new_mesh = ctx.begin_chunk(ci, mesh, reps)
                if new_mesh is not mesh:
                    mesh = new_mesh
                    reps_pad = reps_of(mesh)
                windows[ci] = open_window(ci)
                groups = [g for per in point_groups([ci], reps_pad)
                          for g in per]
                outs = ctx.execute(ci, lambda: [
                    o for pdev, group in groups
                    for o in replay_group(group, pdev)])
                windows[ci]["out"] = dict(enumerate(outs))
                n_sat += close_window(ci)
    finally:
        if saver is not None:
            saver.wait()

    if n_sat:
        _warn_saturated(strategy, n_sat, max_r)
    result = acc.finalize(device=dev)
    t = lambda parts: torch.from_numpy(np.concatenate(parts)).to(dev)
    return ClusterOutput(
        result=result, r_opt=t(r_parts),
        utility=net_utility(result.pocd, result.mean_cost, r_min, theta),
        theory_pocd=t(thp_parts), theory_cost=t(thc_parts),
        queue=acc.finalize_queue(device=dev),
        metrics=acc.finalize_capacity(device=dev), n_saturated=n_sat,
        coupled=info)


def run_cluster_fleet(source, jobs, p, slots: Optional[int] = None,
                      theta=1e-4, strategies=None,
                      r_min_from_ns: bool = True, max_r: int = 8,
                      oracle: bool = True, discipline: str = "fifo",
                      passes: int = 2,
                      governor: Optional[GovernorConfig] = None,
                      admission: Optional[AdmissionConfig] = None,
                      reps: int = 1, mesh=None, chunk_jobs=None,
                      collect_metrics: bool = False, chaos=None,
                      checkpoint=None, resume: bool = False,
                      fused: bool = True, budget=None, *, device=None):
    """Fleet mirror of `cluster.engine.run_cluster` (the same R_min
    protocol) on `device` (default the card). `jobs` is a JobSet, a
    WorkloadTrace or a scenario name (a scenario's declared fault
    schedule is the default `chaos` plan). chaos / checkpoint / resume as
    in `runner.run_all_fleet`: one FaultPlan for every strategy, each
    with a fresh ChaosContext and its own checkpoint subdirectory.
    Returns ({name: ClusterOutput}, r_min)."""
    dev = resolve_device(device)
    jobs, chaos = scenario_plan(jobs, chaos, dev)
    if strategies is None:
        strategies = names()
    kw = dict(mesh=mesh, slots=slots, theta=theta, max_r=max_r,
              oracle=oracle, discipline=discipline, passes=passes,
              governor=governor, admission=admission, reps=reps,
              chunk_jobs=chunk_jobs, collect_metrics=collect_metrics,
              fused=fused, budget=budget, device=dev)
    kw_of = strategy_hooks(chaos, checkpoint, resume, "run_cluster_fleet")
    outs = {}
    r_min = 0.0
    if "hadoop_ns" in strategies:
        outs["hadoop_ns"] = run_cluster_fleet_strategy(
            source, jobs, "hadoop_ns", p, r_min=0.0, **kw,
            **kw_of("hadoop_ns"))
        if r_min_from_ns:
            r_min = float(outs["hadoop_ns"].result.pocd) - 1e-3
    for name in strategies:
        if name != "hadoop_ns":
            outs[name] = run_cluster_fleet_strategy(
                source, jobs, name, p, r_min=r_min, **kw, **kw_of(name))
    return outs, r_min
