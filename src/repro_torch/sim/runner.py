"""End-to-end trace simulation: Algorithm-1 solve, then Monte-Carlo
execution; counterpart of `repro.sim.runner`.

For every job the strategy's grid solve picks r* (on the card, the CUDA
kernel `kernels/csrc/grid_solve.cu`), the spec's `draw` runs one
replication of the whole trace per `rep`, and segment reductions give
empirical PoCD, cost and net utility: the pipeline behind the paper's
Figures 2-5 and Tables I-II. PyTorch runs eagerly, so replications are a
loop; the reference vmaps them inside one compiled program.

`budget=` routes the solve through the joint budget solve
(`repro_torch.coupled`), and `run_all` takes a workload scenario's name
in place of a JobSet. Each strategy's run is one `obs.fenced` span pair.
`run_all(devices=, mesh=, chunk_jobs=)` runs the fleet layer instead
(`repro_torch.fleet`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.utility import JobSpec, cost_of, pocd_of
from ..coupled.solver import (CoupledInfo, solve_jobs_coupled,
                              warn_infeasible)
from ..device import resolve_device
from ..obs import trace as obs_trace
from ..strategies import get, names, solve_jobs
from .metrics import SimResult, aggregate, mean_over_reps, net_utility
from .strategies import SimParams
from .trace import JobSet, jobset_to


class RunOutput(NamedTuple):
    result: SimResult
    r_opt: torch.Tensor          # (J,) chosen r per job (0 for baselines)
    utility: torch.Tensor        # scalar net utility (empirical)
    theory_pocd: torch.Tensor    # (J,) closed-form PoCD at r_opt
    theory_cost: torch.Tensor    # (J,) closed-form E[T] * C at r_opt
    n_saturated: torch.Tensor    # jobs whose r* hit the grid edge
    coupled: Optional[CoupledInfo] = None   # the joint solve's, budget= runs


def jobspecs_of(jobs: JobSet, p: SimParams, theta, r_min=0.0) -> JobSpec:
    """Per-job Algorithm-1 inputs, on the JobSet's device. `theta` is
    scaled per job by the workload class's theta_scale."""
    f32 = dict(dtype=torch.float32, device=jobs.t_min.device)
    t_min = jobs.t_min
    tau_est = p.tau_est_frac * t_min
    tau_kill = tau_est + p.tau_kill_gap_frac * t_min
    J = jobs.n_jobs
    return JobSpec(
        t_min=t_min, beta=jobs.beta, D=jobs.D,
        N=jobs.n_tasks.to(torch.float32),
        tau_est=tau_est, tau_kill=tau_kill,
        phi_est=torch.full((J,), p.phi_est, **f32),
        C=jobs.C, theta=torch.full((J,), theta, **f32) * jobs.theta_scale,
        R_min=torch.full((J,), r_min, **f32))


def _run_core(source, jobs: JobSet, strategy: str, p: SimParams, theta,
              r_min, max_r: int, oracle: bool, r_override, reps: int,
              budget) -> RunOutput:
    """Solve, then `reps` Monte-Carlo replications, then the metrics."""
    dev = jobs.t_min.device
    spec = get(strategy)
    J = jobs.n_jobs
    n_sat = torch.zeros((), dtype=torch.int64, device=dev)
    info = None
    if not spec.optimized:
        r_j = torch.zeros(J, dtype=torch.int32, device=dev)
        choice_j = torch.zeros(J, dtype=torch.int32, device=dev)
        th_p = torch.zeros(J, device=dev)
        th_c = torch.zeros(J, device=dev)
    else:
        specs = jobspecs_of(jobs, p, theta, r_min)
        if r_override is not None:
            r_j = torch.full((J,), int(r_override), dtype=torch.int32,
                             device=dev)
            rf = r_j.to(torch.float32)
            choice_j = (torch.zeros(J, dtype=torch.int32, device=dev)
                        if spec.choose is None else spec.choose(rf, specs))
            th_p = pocd_of(strategy, rf, specs)
            th_c = cost_of(strategy, rf, specs) * specs.C
        else:
            if budget is not None:
                (r_j, choice_j, _, th_p, th_c, sat_j), info = \
                    solve_jobs_coupled(strategy, specs, max_r + 1, budget,
                                       device=dev)
            else:
                r_j, choice_j, _, th_p, th_c, sat_j = solve_jobs(
                    strategy, specs, max_r + 1, device=dev)
            th_c = th_c * specs.C
            n_sat = sat_j.sum()

    r_task = r_j[jobs.job_id]
    choice_task = choice_j[jobs.job_id]
    results = []
    for rep in range(reps):
        draw = lambda name, shape, rep=rep: source.uniform(
            strategy, rep, name, shape, dev)
        completion, machine = spec.draw(draw, jobs, r_task, choice_task, p,
                                        max_r=max_r, oracle=oracle)
        results.append(aggregate(jobs, completion, machine))
    res = results[0] if reps == 1 else mean_over_reps(results)
    return RunOutput(result=res, r_opt=r_j,
                     utility=net_utility(res.pocd, res.mean_cost, r_min,
                                         theta),
                     theory_pocd=th_p, theory_cost=th_c, n_saturated=n_sat,
                     coupled=info)


def run_strategy(source, jobs: JobSet, strategy: str, p: SimParams,
                 theta=1e-4, r_min=0.0, max_r: int = 8, oracle: bool = True,
                 r_override=None, reps: int = 1, budget=None, *,
                 device=None) -> RunOutput:
    """Solve and simulate one strategy on `device` (default the card).

    `source` hands out the uniforms (`sim.draws`). `r_override` pins every
    job's r in place of the solve. With reps > 1 the SimResult is the mean
    over replications (job_met becomes a per-job met frequency).

    `budget=` caps priced machine time, sum(C E[T]) <= budget, through the
    joint solve (`coupled.solve_jobs_coupled`; RunOutput.coupled holds its
    CoupledInfo). Baselines run at r = 0 and ignore it, and `r_override`
    takes precedence. The run is fenced as `sim.run[<strategy>]`.
    """
    dev = resolve_device(device)
    jobs = jobset_to(jobs, dev)
    spec = get(strategy)
    if not spec.detectable:
        oracle = True
    if not spec.optimized or r_override is not None:
        budget = None
    out = obs_trace.fenced(f"sim.run[{strategy}]", _run_core, source, jobs,
                           strategy, p, theta, r_min, max_r, oracle,
                           r_override, reps, budget)
    if budget is not None:
        warn_infeasible(strategy, out.coupled)
    return out


def run_all(source, jobs, p: SimParams, theta=1e-4, strategies=None,
            r_min_from_ns: bool = True, max_r: int = 8, reps: int = 1,
            budget=None, *, device=None, devices=None, mesh=None,
            block_jobs: int = 64, chunk_jobs=None, chaos=None,
            checkpoint=None, resume: bool = False):
    """Run every strategy (default: all registered, in registry order) on
    `device`; R_min for the utilities is Hadoop-NS's PoCD minus 1e-3, as
    in the paper. Returns ({name: RunOutput}, r_min).

    `jobs` is a JobSet or a workload scenario's name
    (`workloads.make_jobset(name, device=device)`: its default size and
    seed). `budget=` goes to every optimized strategy (`run_strategy`).

    `devices=`, `mesh=` or `chunk_jobs=` route to the fleet layer
    (`repro_torch.fleet.run_all_fleet`): draws keyed by (replication,
    global block of `block_jobs` jobs) through `source.uniform_rows`, the
    trace streamed in chunks, a scenario name kept column-wise.
    `devices=N` above 1 runs on `fleet.fleet_mesh(devices=N, reps=reps,
    device=device)` (more points than visible cards raises); the metrics
    equal `devices=1`'s bit for bit. Without them this path is
    unchanged.

    `chaos=` (a `repro_torch.chaos.FaultPlan`), `checkpoint=` and
    `resume=` also route to the fleet: fault injection with
    chunk-boundary checkpoint and resume (`repro_torch.chaos`).
    """
    if (devices is not None or mesh is not None or chunk_jobs is not None
            or chaos is not None or checkpoint is not None or resume):
        from ..fleet import fleet_mesh, run_all_fleet
        if mesh is None and devices is not None and int(devices) > 1:
            mesh = fleet_mesh(devices=devices, reps=reps, device=device)
        return run_all_fleet(source, jobs, p, theta=theta,
                             strategies=strategies,
                             r_min_from_ns=r_min_from_ns, max_r=max_r,
                             reps=reps, mesh=mesh, block_jobs=block_jobs,
                             chunk_jobs=chunk_jobs, chaos=chaos,
                             checkpoint=checkpoint, resume=resume,
                             budget=budget, device=device)
    dev = resolve_device(device)
    if isinstance(jobs, str):
        from ..workloads.registry import make_jobset
        jobs = make_jobset(jobs, device=dev)
    jobs = jobset_to(jobs, dev)
    if strategies is None:
        strategies = names()
    outs = {}
    r_min = 0.0
    if "hadoop_ns" in strategies:
        outs["hadoop_ns"] = run_strategy(source, jobs, "hadoop_ns", p,
                                         theta=theta, r_min=0.0, reps=reps,
                                         device=dev)
        if r_min_from_ns:
            r_min = float(outs["hadoop_ns"].result.pocd) - 1e-3
    for name in strategies:
        if name == "hadoop_ns":
            continue
        outs[name] = run_strategy(source, jobs, name, p, theta=theta,
                                  r_min=r_min, max_r=max_r, reps=reps,
                                  budget=budget, device=dev)
    return outs, r_min
