"""Monte-Carlo strategy simulators over flat task tensors; counterpart of
`repro.sim.strategies`.

Each simulator returns per-task (completion_time, machine_time); job-level
PoCD and cost come from segment reductions (`metrics.py`). A simulator
takes `draw(name, shape) -> uniforms`, bound by the runner to its uniform
source (`draws.py`) for one (strategy, replication), and asks for the
draws the reference takes from its keys: "key", or "k1"/"k2" where the
reference splits its key.

The model and the baselines' approximations are the reference's; see its
module docstring.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .metrics import segment_sum
from .trace import JobSet


def _pareto(u, t_min, beta):
    """Inverse-transform Pareto(t_min, beta) attempt times from uniforms."""
    return t_min * torch.pow(u, -1.0 / beta)


class SimParams(NamedTuple):
    tau_est_frac: float = 0.3     # tau_est = frac * t_min
    tau_kill_gap_frac: float = 0.5  # tau_kill = tau_est + gap * t_min
    phi_est: float = 0.25         # S-Resume progress model (theory-matched)
    launch_overhead_frac: float = 0.2  # startup / JVM analogue, of t_min
    check_period_frac: float = 0.5    # baseline check period, of t_min
    mantri_gate_frac: float = 1.0     # remaining > mean + gate*t_min
    mantri_max_extra: int = 3
    hedge_quantile: float = 0.95      # hedge duplicate launch quantile


def _slots(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)[None, :]


def _masked_min(active, x):
    return torch.where(active, x, torch.inf).amin(dim=1)


# ---------------------------------------------------------------------------
# Chronos strategies (r is per task, gathered from the per-job optimum)
# ---------------------------------------------------------------------------


def sim_clone(draw, jobs: JobSet, r_task, p: SimParams, max_r: int = 8):
    """r_task: (T,) int32 extra attempts per task."""
    T = jobs.total_tasks
    t_min, beta = jobs.task_t_min, jobs.task_beta
    tau_kill = (p.tau_est_frac + p.tau_kill_gap_frac) * t_min
    att = _pareto(draw("key", (T, max_r + 1)), t_min[:, None], beta[:, None])
    best = _masked_min(_slots(max_r + 1, att) <= r_task[:, None], att)
    return best, r_task * tau_kill + best


def sim_srestart(draw, jobs: JobSet, r_task, p: SimParams, max_r: int = 8,
                 oracle: bool = True):
    T = jobs.total_tasks
    t_min, beta, D = jobs.task_t_min, jobs.task_beta, jobs.task_D
    tau_est = p.tau_est_frac * t_min
    tau_kill = tau_est + p.tau_kill_gap_frac * t_min
    T1 = _pareto(draw("k1", (T,)), t_min, beta)
    extras = _pareto(draw("k2", (T, max_r)), t_min[:, None], beta[:, None])
    straggler = _detect(T1, t_min, D, tau_est, p, oracle)
    active = (_slots(max_r, T1) < r_task[:, None]) & straggler[:, None]
    best_extra = _masked_min(active, extras)
    w_all = torch.minimum(T1 - tau_est, best_extra)      # from tau_est
    use = straggler & (r_task > 0)
    completion = torch.where(use, tau_est + w_all, T1)
    machine = torch.where(
        use, tau_est + r_task * (tau_kill - tau_est) + w_all, T1)
    return completion, machine


def sim_sresume(draw, jobs: JobSet, r_task, p: SimParams, max_r: int = 8,
                oracle: bool = True):
    """Original killed at tau_est; r+1 fresh attempts resume the remaining
    (1-phi) work with the t_min startup floor (theory-matched model)."""
    T = jobs.total_tasks
    t_min, beta, D = jobs.task_t_min, jobs.task_beta, jobs.task_D
    tau_est = p.tau_est_frac * t_min
    tau_kill = tau_est + p.tau_kill_gap_frac * t_min
    T1 = _pareto(draw("k1", (T,)), t_min, beta)
    fresh = _pareto(draw("k2", (T, max_r + 1)), t_min[:, None],
                    beta[:, None])
    resumed = torch.maximum(t_min[:, None], (1.0 - p.phi_est) * fresh)
    straggler = _detect(T1, t_min, D, tau_est, p, oracle)
    active = (_slots(max_r + 1, T1) <= r_task[:, None]) & straggler[:, None]
    w_new = _masked_min(active, resumed)
    completion = torch.where(straggler, tau_est + w_new, T1)
    machine = torch.where(straggler,
                          tau_est + r_task * (tau_kill - tau_est) + w_new, T1)
    return completion, machine


def _detect(T1, t_min, D, tau_est, p: SimParams, oracle: bool):
    """Straggler detection at tau_est: the oracle T1 > D, or the Eq. 30
    estimator with launch overhead, which flags nothing before any
    progress exists (tau_est <= startup)."""
    if oracle:
        return T1 > D
    startup = p.launch_overhead_frac * t_min
    work = torch.clamp(T1 - startup, min=1e-6)
    t_ect = startup + work
    return (tau_est > startup) & (t_ect > D)


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------


def sim_hadoop_ns(draw, jobs: JobSet, p: SimParams):
    T1 = _pareto(draw("key", (jobs.total_tasks,)), jobs.task_t_min,
                 jobs.task_beta)
    return T1, T1


def _segment_min(x, job_id, n_jobs):
    return torch.full((n_jobs,), torch.inf, dtype=x.dtype,
                      device=x.device).scatter_reduce_(0, job_id, x, "amin")


def _rank_among_job(values, job_id, n_jobs):
    """Dense descending rank of each task's value within its job (0 = the
    largest).

    One stable sort by (job_id, -value) groups each job's tasks together in
    descending order, written as two stable sorts (secondary key first);
    ties break by the lower original index. A task's rank is its sorted
    position minus its job's segment offset.
    """
    T = values.shape[0]
    by_value = torch.sort(-values, stable=True).indices
    order = by_value[torch.sort(job_id[by_value], stable=True).indices]
    counts = torch.bincount(job_id, minlength=n_jobs)
    starts = torch.cumsum(counts, 0) - counts
    ranks_sorted = torch.arange(T, device=values.device) - \
        starts[job_id[order]]
    ranks = torch.empty_like(ranks_sorted)
    ranks[order] = ranks_sorted
    return ranks.to(torch.int32)


def sim_hadoop_s(draw, jobs: JobSet, p: SimParams):
    """Default Hadoop speculation (rank approximation)."""
    T = jobs.total_tasks
    t_min, beta = jobs.task_t_min, jobs.task_beta
    T1 = _pareto(draw("k1", (T,)), t_min, beta)
    T2 = _pareto(draw("k2", (T,)), t_min, beta)
    # the first completion within the job gates speculation
    t_first = _segment_min(T1, jobs.job_id, jobs.n_jobs)[jobs.job_id]
    delta = p.check_period_frac * t_min
    rank = _rank_among_job(T1, jobs.job_id, jobs.n_jobs).to(torch.float32)
    s_launch = t_first + (rank + 1.0) * delta
    speculate = T1 > s_launch                     # still running at launch
    completion = torch.where(speculate, torch.minimum(T1, s_launch + T2), T1)
    # both attempts run until the task completes (loser killed then)
    machine = torch.where(
        speculate, completion + torch.clamp(completion - s_launch, min=0.0),
        T1)
    return completion, machine


def sim_mantri(draw, jobs: JobSet, p: SimParams):
    """Mantri-style duplication (the reference's approximation)."""
    T = jobs.total_tasks
    t_min, beta = jobs.task_t_min, jobs.task_beta
    T1 = _pareto(draw("k1", (T,)), t_min, beta)
    mean_t = segment_sum(T1, jobs) / \
        torch.clamp(jobs.n_tasks.to(torch.float32), min=1.0)
    gate = mean_t[jobs.job_id] + p.mantri_gate_frac * t_min
    extras = _pareto(draw("k2", (T, p.mantri_max_extra)), t_min[:, None],
                     beta[:, None])
    delta = p.check_period_frac * t_min
    # extra attempt i launches at gate + i * delta while the task still runs
    launch = gate[:, None] + delta[:, None] * \
        _slots(p.mantri_max_extra, T1)
    launched = T1[:, None] > launch
    att_completion = torch.where(launched, launch + extras, torch.inf)
    completion = torch.minimum(T1, att_completion.amin(dim=1))
    extra_machine = torch.where(
        launched, torch.clamp(completion[:, None] - launch, min=0.0),
        0.0).sum(dim=1)
    return completion, completion + extra_machine
