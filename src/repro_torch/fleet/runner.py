"""Chunked fleet execution of the flat trace simulator; counterpart of
`repro.fleet.runner`.

The trace is streamed in job-contiguous chunks (`chunk_jobs=`), each cut
into job blocks (`blocks.py`), and every task row draws at its GLOBAL
coordinates, (block index, task index in the block), under its
(strategy, replication, draw name) key:

    source.uniform_rows(strategy, rep, name, cells, rows, rest, device,
                        tag=FLEET_TAG)

one call per (replication, chunk, draw name), one kernel launch on the
card (`kernels/csrc/philox_rows.cu`). A row's draws depend on nothing
but its coordinates, and a chunked run gives the bits of a monolithic
one. The reference vmaps one simulation per block over (Tb,)-row blocks;
here each (replication, chunk) runs the strategy's sim ONCE on a flat
JobSet of all the chunk's blocks holding their real tasks only
(`blocks.block_view`): task i of a block takes the block's row i (every
sim draws task-major), as it does in the reference's padded block, and
the padding the reference computes and discards is neither drawn into
the view nor simulated. Then each job row's segment max of completion
and masked segment sum of machine time; every per-job reduction stays
inside its block.

The view's blocks start at multiples of `blocks.ALIGN` tasks (the gap
goes to the dummy job, whose rows draw a constant), so on the CPU no
task falls in an elementwise kernel's scalar remainder, whatever chunk it
lies in.

Every cross-job and cross-replication reduction runs on the host in numpy
(`_chunk_result`), and the trace's scalars are reduced once over the
concatenated per-job columns (`sim.metrics.StreamCombiner`). On the card
the Algorithm-1 solve of each chunk is the grid-solve kernel
(`kernels/csrc/grid_solve.cu`).

On a fleet mesh (`mesh=`, `mesh.FleetMesh`) the chunk's layout pads the
replications to the "rep" extent and the blocks to the "job" extent, and
point (r, j) draws, simulates and segment-reduces its replications x
blocks on its own device (`point_shares`, `_exec_mesh`), the reference's
`shard_map` cell. The solve runs once, on the first point; every point
is launched before the first copy to the host, and the raw (replication,
block) cells are then put at their global places and reduced as without
a mesh, so the metrics do not depend on the mesh's shape.

The fleet's streams are statistically equivalent to the flat path's, not
equal to them: `run_all` without `devices=`, `mesh=`, `chunk_jobs=`,
`chaos=`, `checkpoint=` or `resume=` stays the flat path, bit for bit.

`chaos=` and `checkpoint=` hook the chunk loop at chunk boundaries
(`repro_torch.chaos`): a chunk's draws and sims run under the context's
retry loop, its solve before it (the solve is deterministic and keeps r*
on the device), and the host state after each chunk may be checkpointed
and resumed from. Because every draw is keyed by its global coordinates,
a retried chunk draws what its first attempt drew, and a resumed run
gives the uninterrupted run's bits.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..coupled.solver import solve_jobs_coupled, warn_infeasible
from ..device import resolve_device, to_host
from ..obs import trace as obs_trace
from ..sim.draws import FLEET_TAG
from ..sim.metrics import SimResult, StreamCombiner, net_utility, segment_sum
from ..sim.runner import RunOutput, jobspecs_of
from ..sim.trace import build_jobset
from ..strategies import get, names, solve_jobs
from .blocks import (block_layout, block_task_counts, block_view,
                     gather_index)
from .mesh import mesh_device, mesh_extents, pad_count, split_range

#: the uniform that the view's alignment rows (the dummy job's) draw
_ALIGN_FILL = 0.5


class JobColumns(NamedTuple):
    """Per-job columns of a JobSet or WorkloadTrace (same schema): numpy
    on the host, or tensors on a device."""
    n_tasks: object
    t_min: object
    beta: object
    D: object
    arrival: object
    C: object
    job_class: object
    theta_scale: object

    @property
    def n_jobs(self) -> int:
        return int(self.n_tasks.shape[0])

    def slice(self, lo: int, hi: int) -> "JobColumns":
        return JobColumns(*(c[lo:hi] for c in self))

    def to(self, device) -> "JobColumns":
        """The columns as tensors on `device`, in the JobSet's dtypes."""
        dt = (torch.int32, torch.float32, torch.float32, torch.float32,
              torch.float32, torch.float32, torch.int32, torch.float32)
        return JobColumns(*(torch.from_numpy(np.ascontiguousarray(c)).to(
            device=device, dtype=d) for c, d in zip(self, dt)))


def job_columns(source) -> JobColumns:
    """Per-job numpy columns of a JobSet or WorkloadTrace. The chunked
    streamer slices these, never the per-task arrays, so a trace of a
    million jobs is chunked without building its task axis."""
    return JobColumns(*(to_host(getattr(source, f))
                        for f in JobColumns._fields))


def chunk_jobset(cols: JobColumns, lo: int, hi: int, *, device=None):
    """The JobSet of jobs [lo, hi) of per-job columns, on `device`
    (default the card)."""
    sl = cols.slice(lo, hi)
    return build_jobset(*sl[:6], job_class=sl.job_class,
                        theta_scale=sl.theta_scale, device=device)


def _warn_saturated(strategy: str, n_sat: int, max_r: int):
    warnings.warn(
        f"fleet solve[{strategy}]: r* saturated at the grid edge "
        f"(max_r={max_r}) for {n_sat} job(s): raise max_r past "
        f"core.optimizer.r_upper_bound", RuntimeWarning, stacklevel=3)


def _exec_blocks(source, strategy: str, rep_ids, bv, r_task, choice_task,
                 p, max_r: int, oracle: bool):
    """(len(rep_ids), G, Jb) per-job completion and machine time of every
    (replication, block) cell of a `blocks.BlockView`, on its device.

    Each draw is ONE `uniform_rows` over the view: a task row's cell is
    its block's global index and its row the task's index in the block;
    the alignment rows (the dummy job's) are set to `_ALIGN_FILL`. A view
    of padding blocks only (a mesh point past the chunk's last real
    block) has no task: its rows are empty segments, max -inf and sum 0,
    and are dropped with the padding."""
    spec = get(strategy)
    view = bv.jobs
    dev = view.t_min.device
    G = len(bv.block_ids)
    Jb = view.n_jobs // G
    T = view.total_tasks
    if T == 0:
        shape = (len(rep_ids), G, Jb)
        return (torch.full(shape, -torch.inf, device=dev),
                torch.zeros(shape, device=dev))
    g_row = view.job_id // Jb
    cells = g_row + bv.block_ids[0]
    rows = torch.arange(T, device=dev) - torch.from_numpy(
        np.asarray(bv.starts, np.int64)).to(dev)[g_row]
    pad = ~bv.task_valid[:, None]
    jcs, jms = [], []
    for rep in rep_ids:
        def draw(name, shape, rep=rep):
            if shape[0] != T:
                raise ValueError(f"fleet draw {name!r}: {tuple(shape)} is "
                                 f"not task-major over {T} tasks")
            rest = tuple(shape[1:])
            u = source.uniform_rows(strategy, rep, name, cells, rows, rest,
                                    dev, tag=FLEET_TAG)
            return u.reshape(T, -1).masked_fill_(pad, _ALIGN_FILL).reshape(
                (T,) + rest)

        completion, machine = spec.draw(draw, view, r_task, choice_task, p,
                                        max_r=max_r, oracle=oracle)
        jc = torch.full((view.n_jobs,), -torch.inf, dtype=completion.dtype,
                        device=dev).scatter_reduce_(0, view.job_id,
                                                    completion, "amax")
        jm = segment_sum(torch.where(bv.task_valid, machine, 0.0), view)
        jcs.append(jc.view(G, Jb))
        jms.append(jm.view(G, Jb))
    return torch.stack(jcs), torch.stack(jms)


class PointShare(NamedTuple):
    """One mesh point's share of a chunk: its device, its replications
    [r0, r1) and its blocks [g0, g1) of the chunk's padded layout."""
    device: torch.device
    reps: tuple
    blocks: tuple


def point_shares(mesh, dev, reps_pad: int, n_blocks: int) -> list:
    """The PointShares of a chunk of `reps_pad` replications and
    `n_blocks` blocks: point (r, j) takes the r-th of the mesh's equal
    replication ranges and the j-th of its block ranges, as the
    reference's shard_map places P("rep") and P("job"); without a mesh,
    one share of everything on `dev`."""
    if mesh is None:
        return [PointShare(dev, (0, reps_pad), (0, n_blocks))]
    return [PointShare(mesh.point(r, j),
                       split_range(reps_pad, mesh.rep_extent, r),
                       split_range(n_blocks, mesh.job_extent, j))
            for r in range(mesh.rep_extent) for j in range(mesh.job_extent)]


def _exec_mesh(source, strategy: str, parts, p, max_r: int, oracle: bool):
    """(reps_pad, G_pad, Jb) per-job completion and machine time of a
    chunk from its points' `parts`, (PointShare, rep_ids, BlockView,
    r_task, choice_task) each. One part (no mesh): `_exec_blocks`'s
    tensors on its device. Several: every point is launched on its own
    device first, then the raw cells are copied to the host and put at
    their global (replication, block) places, numpy f32."""
    runs = [_exec_blocks(source, strategy, rep_ids, bv, r_task, c_task, p,
                         max_r, oracle)
            for _, rep_ids, bv, r_task, c_task in parts]
    if len(parts) == 1:
        return runs[0]
    shape = (max(sh.reps[1] for sh, *_ in parts),
             max(sh.blocks[1] for sh, *_ in parts), runs[0][0].shape[2])
    out = tuple(np.empty(shape, np.float32) for _ in range(2))
    for (sh, *_), run in zip(parts, runs):
        for whole, cells in zip(out, run):
            whole[slice(*sh.reps), slice(*sh.blocks)] = to_host(cells)
    return out


def _chunk_result(jc, jm, D, C, reps: int, n_jobs: int,
                  block_jobs: int) -> SimResult:
    """The chunk's epilogue on the host, numpy f32 in the reference's
    order: drop padded replications, gather real jobs back into trace
    order, reduce replications."""
    jc = to_host(jc)
    jm = to_host(jm)
    gather = gather_index(n_jobs, block_jobs)
    jc = jc[:reps].reshape(reps, -1)[:, gather]
    jm = jm[:reps].reshape(reps, -1)[:, gather]
    met = jc <= to_host(D)[None, :]
    cost = jm * to_host(C)[None, :]
    if reps == 1:
        met_j, comp_j, cost_j = met[0], jc[0], cost[0]
    else:
        met_j = met.mean(axis=0, dtype=np.float32)
        comp_j = jc.mean(axis=0, dtype=np.float32)
        cost_j = cost.mean(axis=0, dtype=np.float32)
    return SimResult(
        pocd=np.float32(met_j.mean(dtype=np.float32)), job_met=met_j,
        job_completion=comp_j, job_cost=cost_j,
        mean_cost=np.float32(cost_j.mean(dtype=np.float32)))


def _pad0(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros(1)])


def chunk_hooks(chaos, checkpoint, source, n_chunks: int, mesh, pool=None,
                **fingerprint):
    """(ChaosContext or None, ChunkCheckpointer or None, the run's
    fingerprint or None) of a chunk loop: the context bound to the run's
    chunks, replications (`fingerprint["reps"]`) and slot pool `pool`;
    the fingerprint of the run's configuration, its uniform source and
    its plan. Nothing is imported or built when both are None."""
    ctx = saver = fp = None
    if chaos is not None:
        from ..chaos.inject import as_context
        ctx = as_context(chaos)
        ctx.bind(n_chunks, mesh, fingerprint["reps"], slots=pool)
    if checkpoint is not None:
        from ..chaos import recovery
        saver = recovery.ChunkCheckpointer(
            recovery.as_checkpoint(checkpoint))
        fp = recovery.run_fingerprint(
            **fingerprint, key=recovery.source_id(source),
            plan=ctx.plan.fingerprint() if ctx is not None else "")
    return ctx, saver, fp


def resume_point(saver, fp, ctx, mesh, reps: int):
    """(first chunk to run, StreamCombiner, (r, theory PoCD, theory cost)
    parts, mesh) from `saver`'s latest committed step, its fingerprint
    checked against `fp`, the mesh shrunk by the device losses of the
    chunks before it (`ChaosContext.mesh_through`) and `ctx`
    fast-forwarded past it; a fresh start on `mesh` when `saver` is None
    or holds no committed step."""
    fresh = (0, StreamCombiner(), ([], [], []), mesh)
    if saver is None:
        return fresh
    step = saver.latest()
    if step is None:
        return fresh
    from ..chaos import recovery
    header, acc, solves = recovery.unpack_run_state(saver.load(step))
    recovery.check_fingerprint(header["fingerprint"], fp)
    start = int(header["next_chunk"])
    if ctx is not None:
        mesh = ctx.mesh_through(start, mesh, reps)
        ctx.catch_up(start)
    return start, acc, solves, mesh


def end_of_chunk(ci: int, n_chunks: int, ctx, saver, fp, acc,
                 solves) -> None:
    """After chunk ci: checkpoint when it is due (every `every` chunks,
    the last chunk, and before a crash, whose commit it waits for), then
    let a crash event fire."""
    if saver is not None:
        from ..chaos import recovery
        crash_here = ctx is not None and bool(ctx.plan.at(ci, "crash"))
        if ((ci + 1) % saver.cfg.every == 0 or ci == n_chunks - 1
                or crash_here):
            saver.save(ci + 1, recovery.pack_run_state(
                acc, solves, next_chunk=ci + 1, fingerprint=fp))
            if crash_here:
                # the resume contract needs the chunk it died after on
                # disk: a simulated crash must not outrun its own commit
                saver.wait()
    if ctx is not None:
        ctx.maybe_crash(ci)


def scale_cost(specs, scale: float):
    """JobSpecs with C re-priced by the elastic governor's `scale`,
    multiplied as an f32 as the reference multiplies it (r* on a near-tie
    depends on the product's last bit)."""
    if scale == 1.0:
        return specs
    return specs._replace(C=specs.C * torch.tensor(
        np.float32(scale), device=specs.C.device))


def run_fleet_strategy(source, jobs, strategy: str, p, *, mesh=None,
                       theta=1e-4, r_min=0.0, max_r: int = 8,
                       oracle: bool = True, reps: int = 1,
                       block_jobs: int = 64, chunk_jobs=None, pad_to=None,
                       chaos=None, checkpoint=None, resume: bool = False,
                       fused: bool = True, budget=None,
                       device=None) -> RunOutput:
    """Fleet mirror of `sim.runner.run_strategy`, on `device` (default the
    card); `source` hands out the uniforms (`sim.draws`, `uniform_rows`).

    jobs: a JobSet or a WorkloadTrace (chunked column-wise).
    mesh: a ("rep", "job") `FleetMesh` from `fleet_mesh`, or None. Point
        (r, j) draws, simulates and segment-reduces its replications x
        blocks on its own device; the solve runs once, on the first
        point, which also holds the outputs. Metrics equal the run
        without a mesh bit for bit.
    chunk_jobs: stream the trace in job-contiguous chunks of at most this
        many jobs, rounded down to a block multiple; a chunk_jobs below
        block_jobs shrinks the blocks (and so changes the draws). None =
        one chunk.
    pad_to: (rep_mult, job_mult) padding override for the pad+mask tests;
        only without a mesh.
    block_jobs: jobs per block, the draws' granularity (changing it
        changes the draws).
    chaos: a `chaos.FaultPlan` or `chaos.ChaosContext` consulted at chunk
        boundaries: a device loss shrinks the mesh (and the layout is
        padded again for it), injected chunk failures and corruption
        retry, a crash raises SimulatedCrash after the chunk's
        checkpoint commits, and an `ElasticGovernor` re-prices each
        chunk's solve. None keeps the chaos-free path.
    checkpoint: a `chaos.CheckpointConfig` or a directory: save the
        resumable chunk state after chunks; with `resume=True`, first
        restore the latest committed step (its fingerprint must match this
        call's configuration) and continue from it, bit for bit the
        uninterrupted run. No committed step: start from chunk 0.
    fused: keep r*/choice on the device and gather them per task through
        the layout's task -> job column; False takes them through host
        numpy (the staged path). Both give the same bits; baselines and
        budgeted runs are always staged.
    budget: a priced machine-time cap for the whole trace: one joint solve
        (`coupled.solve_jobs_coupled`) over every job before the chunk
        loop, each chunk replaying its slice of that one selection.
        Incompatible with `chaos=` (re-pricing mid-run would invalidate
        that one solve).
    """
    dev = mesh_device(mesh, resolve_device(device))
    spec = get(strategy)
    if not spec.detectable:
        oracle = True
    if pad_to is not None and mesh is not None:
        raise ValueError("pad_to is a test-only override; incompatible "
                         "with an explicit mesh")
    if resume and checkpoint is None:
        raise ValueError("resume=True requires a checkpoint config")
    if budget is not None and not spec.optimized:
        budget = None     # baselines run at r = 0: nothing to budget
    if budget is not None and chaos is not None:
        raise ValueError(
            "budget= requires a chaos-free run: the shared multiplier is "
            "solved once over the whole trace, and chaos re-pricing or "
            "mesh loss mid-run would invalidate that global solve")
    cols = job_columns(jobs)
    J = cols.n_jobs
    B = max(1, min(int(block_jobs), J))
    if chunk_jobs is not None:
        # chunk boundaries must land on block boundaries, or the global
        # block indices (and so the draws) would move with the split
        B = min(B, max(1, int(chunk_jobs)))
    chunk = J if chunk_jobs is None else max(B, (int(chunk_jobs) // B) * B)
    n_chunks = -(-J // chunk)
    blocks_per_chunk = -(-chunk // B)
    # one global task width: every block of every chunk draws (Tb, ...)
    Tb = int(block_task_counts(cols.n_tasks, B).max())

    def layout_of(m):
        # the padding for mesh m; derived again when chaos shrinks it
        r_ext, j_ext = pad_to if pad_to is not None else mesh_extents(m)
        return (j_ext, range(pad_count(reps, r_ext)),
                pad_count(blocks_per_chunk, j_ext))

    j_ext, rep_ids, min_blocks = layout_of(mesh)
    ctx, saver, fp = chunk_hooks(
        chaos, checkpoint, source, n_chunks, mesh, path="flat",
        strategy=strategy, n_jobs=J, block_jobs=B, chunk=chunk, reps=reps,
        max_r=max_r, oracle=oracle, theta=float(theta), r_min=float(r_min),
        budget=None if budget is None else float(budget))

    coupled_sel = info = None
    if budget is not None:
        # one joint solve over every job (jobspecs_of is elementwise in
        # the job, so this is the concatenation of the chunks' specs)
        with obs_trace.span("fleet.coupled_solve", strategy=strategy,
                            n_jobs=J, n_chunks=n_chunks):
            gspecs = jobspecs_of(cols.to(dev), p, theta, r_min)
            (g_r, g_ch, _, g_p, g_c, g_sat), info = solve_jobs_coupled(
                strategy, gspecs, max_r + 1, budget, device=dev)
            coupled_sel = tuple(to_host(a) for a in
                                (g_r, g_ch, g_p, g_c * gspecs.C, g_sat))
        warn_infeasible(strategy, info)

    start, acc, (r_parts, thp_parts, thc_parts), mesh = resume_point(
        saver if resume else None, fp, ctx, mesh, reps)
    j_ext, rep_ids, min_blocks = layout_of(mesh)
    n_sat = 0
    try:
        for ci in range(start, n_chunks):
            if ctx is not None:
                new_mesh = ctx.begin_chunk(ci, mesh, reps)
                if new_mesh is not mesh:
                    mesh = new_mesh
                    j_ext, rep_ids, min_blocks = layout_of(mesh)
            lo, hi = ci * chunk, min((ci + 1) * chunk, J)
            ccols = cols.slice(lo, hi)
            Jc = ccols.n_jobs
            use_fused = fused and spec.optimized and coupled_sel is None
            with obs_trace.span("fleet.solve", strategy=strategy, chunk=ci,
                                n_jobs=Jc):
                if coupled_sel is not None:
                    r_j, choice_j, th_p, th_c, sat_j = (
                        a[lo:hi] for a in coupled_sel)
                elif not spec.optimized:
                    r_j = choice_j = sat_j = np.zeros(Jc, np.int32)
                    th_p = th_c = np.zeros(Jc, np.float32)
                else:
                    specs = scale_cost(
                        jobspecs_of(ccols.to(dev), p, theta, r_min),
                        ctx.cost_scale(ci) if ctx is not None else 1.0)
                    r_j, choice_j, _, th_p, th_c, sat_j = solve_jobs(
                        strategy, specs, max_r + 1, device=dev)
                    th_c = th_c * specs.C
                    if not use_fused:
                        r_j, choice_j = to_host(r_j), to_host(choice_j)
            with obs_trace.span("fleet.blocks", chunk=ci, block_jobs=B):
                layout = block_layout(ccols, B, pad_blocks_to=j_ext,
                                      tasks_pad=Tb, min_blocks=min_blocks)
                parts = []
                for sh in point_shares(mesh, dev, len(rep_ids),
                                       layout.n_blocks_padded):
                    (g0, g1), pdev = sh.blocks, sh.device
                    bv = block_view(ccols, layout,
                                    block_offset=ci * blocks_per_chunk,
                                    blocks=(g0, g1), device=pdev)
                    rows = lambda x, fill, dt: torch.from_numpy(
                        layout.stack_jobs(x, fill, dt)[g0:g1]).to(
                            pdev).reshape(-1)[bv.jobs.job_id]
                    if use_fused:
                        # the task -> chunk-job column (pure geometry);
                        # padding tasks point at Jc, the appended zero row
                        tj = rows(np.arange(Jc), Jc, np.int64)
                        r_task = _pad0(r_j).to(pdev)[tj]
                        c_task = _pad0(choice_j).to(pdev)[tj]
                    else:
                        r_task = rows(r_j, 0, np.int32)
                        c_task = rows(choice_j, 0, np.int32)
                    parts.append((sh, rep_ids[slice(*sh.reps)], bv, r_task,
                                  c_task))
            exec_chunk = lambda: obs_trace.fenced(
                f"fleet.exec[{strategy}]", _exec_mesh, source, strategy,
                parts, p, max_r, oracle)
            jc, jm = (exec_chunk() if ctx is None
                      else ctx.execute(ci, exec_chunk))
            with obs_trace.span("fleet.reduce", chunk=ci, n_jobs=Jc):
                acc.add(_chunk_result(jc, jm, ccols.D, ccols.C, reps, Jc, B),
                        n_jobs=Jc)
            r_parts.append(to_host(r_j))
            thp_parts.append(to_host(th_p))
            thc_parts.append(to_host(th_c))
            if spec.optimized:
                n_sat += int(to_host(sat_j).sum())
            end_of_chunk(ci, n_chunks, ctx, saver, fp, acc,
                         (r_parts, thp_parts, thc_parts))
    finally:
        if saver is not None:
            saver.wait()

    if n_sat:
        _warn_saturated(strategy, n_sat, max_r)
    result = acc.finalize(device=dev)
    t = lambda parts: torch.from_numpy(np.concatenate(parts)).to(dev)
    return RunOutput(
        result=result, r_opt=t(r_parts),
        utility=net_utility(result.pocd, result.mean_cost, r_min, theta),
        theory_pocd=t(thp_parts), theory_cost=t(thc_parts),
        n_saturated=torch.tensor(n_sat, device=dev), coupled=info)


def scenario_plan(jobs, chaos, dev):
    """(trace, plan): a scenario name resolves to its trace, column-wise,
    and its declared fault schedule becomes the plan when `chaos` is
    None; anything else passes through."""
    if isinstance(jobs, str):
        from ..workloads.registry import get_scenario, make_trace
        faults = get_scenario(jobs).faults
        if chaos is None and faults:
            from ..chaos.plan import from_faults
            chaos = from_faults(faults)
        jobs = make_trace(jobs, device=dev)
    return jobs, chaos


def strategy_hooks(chaos, checkpoint, resume: bool, caller: str):
    """kw_of(strategy): the chaos keywords of one strategy's run in a
    run over every strategy: a fresh ChaosContext over the shared
    FaultPlan (injection budgets are stateful, and every strategy sees
    the same failures), and the strategy's own checkpoint subdirectory."""
    def kw_of(name: str) -> dict:
        per = dict(resume=resume)
        if chaos is not None:
            from ..chaos.inject import ChaosContext
            from ..chaos.plan import FaultPlan
            if not isinstance(chaos, FaultPlan):
                raise TypeError(f"{caller} takes a FaultPlan (each strategy "
                                f"needs its own ChaosContext)")
            per["chaos"] = ChaosContext(chaos)
        if checkpoint is not None:
            from ..chaos.recovery import as_checkpoint
            per["checkpoint"] = as_checkpoint(checkpoint).sub(name)
        return per
    return kw_of


def run_all_fleet(source, jobs, p, theta=1e-4, strategies=None,
                  r_min_from_ns: bool = True, max_r: int = 8,
                  reps: int = 1, mesh=None, block_jobs: int = 64,
                  chunk_jobs=None, pad_to=None, chaos=None, checkpoint=None,
                  resume: bool = False, fused: bool = True, budget=None, *,
                  device=None):
    """Fleet mirror of `sim.runner.run_all` (the same R_min-from-Hadoop-NS
    protocol) on `device` (default the card). `jobs` is a JobSet, a
    WorkloadTrace or a scenario name (its trace, kept column-wise; a
    scenario's declared fault schedule is the default `chaos` plan).
    chaos: a `chaos.FaultPlan`, applied to every strategy's run through a
        fresh ChaosContext each. checkpoint: a CheckpointConfig or a
        directory; each strategy checkpoints in its own subdirectory.
    Returns ({name: RunOutput}, r_min)."""
    dev = resolve_device(device)
    jobs, chaos = scenario_plan(jobs, chaos, dev)
    if strategies is None:
        strategies = names()
    kw = dict(mesh=mesh, theta=theta, max_r=max_r, reps=reps,
              block_jobs=block_jobs, chunk_jobs=chunk_jobs, pad_to=pad_to,
              fused=fused, budget=budget, device=dev)
    kw_of = strategy_hooks(chaos, checkpoint, resume, "run_all_fleet")
    outs = {}
    r_min = 0.0
    if "hadoop_ns" in strategies:
        outs["hadoop_ns"] = run_fleet_strategy(source, jobs, "hadoop_ns", p,
                                               r_min=0.0, **kw,
                                               **kw_of("hadoop_ns"))
        if r_min_from_ns:
            r_min = float(outs["hadoop_ns"].result.pocd) - 1e-3
    for name in strategies:
        if name != "hadoop_ns":
            outs[name] = run_fleet_strategy(source, jobs, name, p,
                                            r_min=r_min, **kw, **kw_of(name))
    return outs, r_min
