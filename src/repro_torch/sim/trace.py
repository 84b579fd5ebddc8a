"""Trace-driven job generation (paper Section VII.B); counterpart of
`repro.sim.trace`.

Jobs mimic the Google-trace mix the paper simulates: 2700 jobs / ~1M tasks,
heavy-tailed task counts, per-job Pareto parameters with beta in [1.1, 2].
Columns are drawn with numpy's seeded `default_rng` in the reference's
order, so a seed gives the reference's trace column for column. Jobs are
laid out flat (one row per task with a job_id) for segment reductions.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device


class JobSet(NamedTuple):
    """Per-job tensors (n_jobs,) and flat per-task tensors (total_tasks,).

    `job_class` / `theta_scale` carry workload heterogeneity: the class id
    of each job and a per-job multiplier on the SLA weight theta.
    """
    n_jobs: int
    n_tasks: torch.Tensor         # (J,) int32
    t_min: torch.Tensor           # (J,) f32
    beta: torch.Tensor            # (J,) f32
    D: torch.Tensor               # (J,) f32
    arrival: torch.Tensor         # (J,) f32 seconds from trace start
    C: torch.Tensor               # (J,) f32 VM price per machine-second
    job_class: torch.Tensor       # (J,) int32
    theta_scale: torch.Tensor     # (J,) f32
    job_id: torch.Tensor          # (T,) int64 flat task -> job
    task_t_min: torch.Tensor      # (T,) f32
    task_beta: torch.Tensor       # (T,) f32
    task_D: torch.Tensor          # (T,) f32

    @property
    def total_tasks(self) -> int:
        return int(self.job_id.shape[0])


def jobset_to(jobs: JobSet, device) -> JobSet:
    return JobSet(jobs.n_jobs, *(x.to(device) for x in jobs[1:]))


def build_jobset(n_tasks, t_min, beta, D, arrival, C, job_class=None,
                 theta_scale=None, *, device=None) -> JobSet:
    """Assemble a JobSet on `device` from per-job numpy columns.

    The flat per-task columns are gathered once here, on the host, from
    the f32 per-job columns. `job_id` is int64, the index type of torch's
    gathers and scatters.
    """
    dev = resolve_device(device)
    n_tasks = np.asarray(n_tasks, np.int32)
    n_jobs = int(n_tasks.shape[0])
    t_min = np.asarray(t_min, np.float32)
    beta = np.asarray(beta, np.float32)
    D = np.asarray(D, np.float32)
    if job_class is None:
        job_class = np.zeros(n_jobs, np.int32)
    if theta_scale is None:
        theta_scale = np.ones(n_jobs, np.float32)
    job_id = np.repeat(np.arange(n_jobs, dtype=np.int64), n_tasks)
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
    return JobSet(
        n_jobs=n_jobs,
        n_tasks=t(n_tasks, np.int32),
        t_min=t(t_min, np.float32),
        beta=t(beta, np.float32),
        D=t(D, np.float32),
        arrival=t(arrival, np.float32),
        C=t(C, np.float32),
        job_class=t(job_class, np.int32),
        theta_scale=t(theta_scale, np.float32),
        job_id=t(job_id, np.int64),
        task_t_min=t(t_min[job_id], np.float32),
        task_beta=t(beta[job_id], np.float32),
        task_D=t(D[job_id], np.float32),
    )


def generate(n_jobs=2700, mean_tasks=370, seed=0, deadline_ratio=2.0,
             beta_range=(1.1, 2.0), t_min_range=(8.0, 15.0), hours=30.0,
             spot_price=1.0, max_tasks=5000, *, device=None) -> JobSet:
    """Synthesize the Google-trace-like JobSet of the reference's
    `generate` (same numpy draws in the same order) on `device`.

    deadline_ratio: D = ratio * E[task time] (paper Fig. 4 uses 2x).
    """
    rng = np.random.default_rng(seed)
    raw = rng.lognormal(mean=np.log(mean_tasks) - 0.75, sigma=1.2,
                        size=n_jobs)
    n_tasks = np.clip(raw, 10, max_tasks).astype(np.int32)
    beta = rng.uniform(*beta_range, size=n_jobs).astype(np.float32)
    t_min = rng.uniform(*t_min_range, size=n_jobs).astype(np.float32)
    mean_task_time = t_min * beta / (beta - 1.0)
    D = (deadline_ratio * mean_task_time).astype(np.float32)
    arrival = np.sort(rng.uniform(0, hours * 3600, size=n_jobs)).astype(
        np.float32)
    C = np.full(n_jobs, spot_price, np.float32)
    return build_jobset(n_tasks, t_min, beta, D, arrival, C, device=device)
