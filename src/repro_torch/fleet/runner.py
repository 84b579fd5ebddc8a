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

The fleet's streams are statistically equivalent to the flat path's, not
equal to them: `run_all` without `devices=`, `mesh=` or `chunk_jobs=`
stays the flat path, bit for bit.
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
from .mesh import check_mesh, mesh_extents, pad_count

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
    """(reps_pad, G_pad, Jb) per-job completion and machine time of every
    (replication, block) cell of a `blocks.BlockView`, on its device.

    Each draw is ONE `uniform_rows` over the view: a task row's cell is
    its block's global index and its row the task's index in the block;
    the alignment rows (the dummy job's) are set to `_ALIGN_FILL`."""
    spec = get(strategy)
    view = bv.jobs
    dev = view.t_min.device
    G = len(bv.block_ids)
    Jb = view.n_jobs // G
    T = view.total_tasks
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


def run_fleet_strategy(source, jobs, strategy: str, p, *, mesh=None,
                       theta=1e-4, r_min=0.0, max_r: int = 8,
                       oracle: bool = True, reps: int = 1,
                       block_jobs: int = 64, chunk_jobs=None, pad_to=None,
                       fused: bool = True, budget=None,
                       device=None) -> RunOutput:
    """Fleet mirror of `sim.runner.run_strategy`, on `device` (default the
    card); `source` hands out the uniforms (`sim.draws`, `uniform_rows`).

    jobs: a JobSet or a WorkloadTrace (chunked column-wise).
    mesh: None or the 1 x 1 mesh of `fleet_mesh`.
    chunk_jobs: stream the trace in job-contiguous chunks of at most this
        many jobs, rounded down to a block multiple; a chunk_jobs below
        block_jobs shrinks the blocks (and so changes the draws). None =
        one chunk.
    pad_to: (rep_mult, job_mult) padding override for the pad+mask tests;
        only without a mesh.
    block_jobs: jobs per block, the draws' granularity (changing it
        changes the draws).
    fused: keep r*/choice on the device and gather them per task through
        the layout's task -> job column; False takes them through host
        numpy (the staged path). Both give the same bits; baselines and
        budgeted runs are always staged.
    budget: a priced machine-time cap for the whole trace: one joint solve
        (`coupled.solve_jobs_coupled`) over every job before the chunk
        loop, each chunk replaying its slice of that one selection.
    """
    dev = resolve_device(device)
    check_mesh(mesh)
    spec = get(strategy)
    if not spec.detectable:
        oracle = True
    if pad_to is not None and mesh is not None:
        raise ValueError("pad_to is a test-only override; incompatible "
                         "with an explicit mesh")
    if budget is not None and not spec.optimized:
        budget = None     # baselines run at r = 0: nothing to budget
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
    r_ext, j_ext = pad_to if pad_to is not None else mesh_extents(mesh)
    rep_ids = range(pad_count(reps, r_ext))
    min_blocks = pad_count(blocks_per_chunk, j_ext)

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

    acc = StreamCombiner()
    n_sat = 0
    r_parts, thp_parts, thc_parts = [], [], []
    for ci in range(n_chunks):
        lo, hi = ci * chunk, min((ci + 1) * chunk, J)
        ccols = cols.slice(lo, hi)
        Jc = ccols.n_jobs
        use_fused = fused and spec.optimized and coupled_sel is None
        with obs_trace.span("fleet.solve", strategy=strategy, chunk=ci,
                            n_jobs=Jc):
            if coupled_sel is not None:
                r_j, choice_j, th_p, th_c, sat_j = (a[lo:hi]
                                                    for a in coupled_sel)
            elif not spec.optimized:
                r_j = choice_j = sat_j = np.zeros(Jc, np.int32)
                th_p = th_c = np.zeros(Jc, np.float32)
            else:
                specs = jobspecs_of(ccols.to(dev), p, theta, r_min)
                r_j, choice_j, _, th_p, th_c, sat_j = solve_jobs(
                    strategy, specs, max_r + 1, device=dev)
                th_c = th_c * specs.C
                if not use_fused:
                    r_j, choice_j = to_host(r_j), to_host(choice_j)
        with obs_trace.span("fleet.blocks", chunk=ci, block_jobs=B):
            layout = block_layout(ccols, B, pad_blocks_to=j_ext,
                                  tasks_pad=Tb, min_blocks=min_blocks)
            bv = block_view(ccols, layout, block_offset=ci * blocks_per_chunk,
                            device=dev)
            view = bv.jobs
            rows = lambda x, fill, dt: torch.from_numpy(
                layout.stack_jobs(x, fill, dt)).to(dev).reshape(-1)[
                    view.job_id]
            if use_fused:
                # the task -> chunk-job column (pure geometry); padding
                # tasks point at Jc, the appended zero row
                tj = rows(np.arange(Jc), Jc, np.int64)
                r_task, c_task = _pad0(r_j)[tj], _pad0(choice_j)[tj]
            else:
                r_task = rows(r_j, 0, np.int32)
                c_task = rows(choice_j, 0, np.int32)
        jc, jm = obs_trace.fenced(
            f"fleet.exec[{strategy}]", _exec_blocks, source, strategy,
            rep_ids, bv, r_task, c_task, p, max_r, oracle)
        with obs_trace.span("fleet.reduce", chunk=ci, n_jobs=Jc):
            acc.add(_chunk_result(jc, jm, ccols.D, ccols.C, reps, Jc, B),
                    n_jobs=Jc)
        r_parts.append(to_host(r_j))
        thp_parts.append(to_host(th_p))
        thc_parts.append(to_host(th_c))
        if spec.optimized:
            n_sat += int(to_host(sat_j).sum())

    if n_sat:
        _warn_saturated(strategy, n_sat, max_r)
    result = acc.finalize(device=dev)
    t = lambda parts: torch.from_numpy(np.concatenate(parts)).to(dev)
    return RunOutput(
        result=result, r_opt=t(r_parts),
        utility=net_utility(result.pocd, result.mean_cost, r_min, theta),
        theory_pocd=t(thp_parts), theory_cost=t(thc_parts),
        n_saturated=torch.tensor(n_sat, device=dev), coupled=info)


def run_all_fleet(source, jobs, p, theta=1e-4, strategies=None,
                  r_min_from_ns: bool = True, max_r: int = 8,
                  reps: int = 1, mesh=None, block_jobs: int = 64,
                  chunk_jobs=None, pad_to=None, fused: bool = True,
                  budget=None, *, device=None):
    """Fleet mirror of `sim.runner.run_all` (the same R_min-from-Hadoop-NS
    protocol) on `device` (default the card). `jobs` is a JobSet, a
    WorkloadTrace or a scenario name (its trace, kept column-wise).
    Returns ({name: RunOutput}, r_min)."""
    dev = resolve_device(device)
    if isinstance(jobs, str):
        from ..workloads.registry import make_trace
        jobs = make_trace(jobs, device=dev)
    if strategies is None:
        strategies = names()
    kw = dict(mesh=mesh, theta=theta, max_r=max_r, reps=reps,
              block_jobs=block_jobs, chunk_jobs=chunk_jobs, pad_to=pad_to,
              fused=fused, budget=budget, device=dev)
    outs = {}
    r_min = 0.0
    if "hadoop_ns" in strategies:
        outs["hadoop_ns"] = run_fleet_strategy(source, jobs, "hadoop_ns", p,
                                               r_min=0.0, **kw)
        if r_min_from_ns:
            r_min = float(outs["hadoop_ns"].result.pocd) - 1e-3
    for name in strategies:
        if name != "hadoop_ns":
            outs[name] = run_fleet_strategy(source, jobs, name, p,
                                            r_min=r_min, **kw)
    return outs, r_min
