"""Job-level metrics from per-task simulator outputs; counterpart of
`repro.sim.metrics`."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .trace import JobSet


class SimResult(NamedTuple):
    pocd: torch.Tensor           # scalar: fraction of jobs meeting D
    job_met: torch.Tensor        # (J,) bool (met frequency when reps > 1)
    job_completion: torch.Tensor  # (J,)
    job_cost: torch.Tensor       # (J,) machine-time * C
    mean_cost: torch.Tensor      # scalar


def _mean(x, dim=None):
    """sum / n, as jnp.mean computes it (torch's mean may round otherwise:
    R_min is read from Hadoop-NS's PoCD, so its last bit matters)."""
    n = x.numel() if dim is None else x.shape[dim]
    return (x.sum() if dim is None else x.sum(dim=dim)) / n


def segment_sum(x, jobs: JobSet):
    """Per-job sum of a flat per-task column, the same bits on every run.

    `job_id` is sorted, so a job's segment is its `n_tasks` contiguous
    rows; `segment_reduce` adds each segment in a fixed order and uses no
    atomics (`index_add_` would, and its last bits would vary on the
    card). unsafe: build_jobset guarantees sum(n_tasks) == len(x); the
    check would read the lengths back to the host."""
    return torch.segment_reduce(x, "sum", lengths=jobs.n_tasks, unsafe=True)


def scan_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D tensor, the same bits on the CPU and
    the card, run after run (`torch.cumsum` of floats on CUDA is not
    deterministic): doubling steps (Hillis-Steele), each one elementwise
    add."""
    out = x.clone()
    k = 1
    while k < out.shape[0]:
        out = torch.cat([out[:k], out[k:] + out[:-k]])
        k *= 2
    return out


def aggregate(jobs: JobSet, completion, machine) -> SimResult:
    """Segment max of completion and segment sum of machine time per job;
    both give the same bits on every run, on the card as on the CPU (the
    max is order-free, the sum is `segment_sum`)."""
    J = jobs.n_jobs
    job_completion = torch.full(
        (J,), -torch.inf, dtype=completion.dtype,
        device=completion.device).scatter_reduce_(
            0, jobs.job_id, completion, "amax")
    job_machine = segment_sum(machine, jobs)
    met = job_completion <= jobs.D
    cost = job_machine * jobs.C
    return SimResult(pocd=_mean(met.to(torch.float32)), job_met=met,
                     job_completion=job_completion, job_cost=cost,
                     mean_cost=_mean(cost))


def mean_over_reps(results) -> SimResult:
    """Monte-Carlo mean of per-replication results; bool job_met becomes a
    per-job met frequency in [0, 1]."""
    return SimResult(*(_mean(torch.stack([x.to(torch.float32)
                                          for x in field]), dim=0)
                       for field in zip(*results)))


def class_summary(jobs: JobSet, result: SimResult) -> dict:
    """Per-workload-class breakdown of a SimResult, on the host in
    float64: {class_id: {"n_jobs", "pocd", "mean_cost",
    "mean_completion"}}. With reps > 1 `job_met` is a met frequency, so
    `pocd` stays the class's deadline-met probability."""
    import numpy as np
    cls = jobs.job_class.cpu().numpy()
    met = result.job_met.cpu().numpy().astype(np.float64)
    cost = result.job_cost.cpu().numpy().astype(np.float64)
    comp = result.job_completion.cpu().numpy().astype(np.float64)
    out = {}
    for c in np.unique(cls):
        m = cls == c
        out[int(c)] = {
            "n_jobs": int(m.sum()),
            "pocd": float(met[m].mean()),
            "mean_cost": float(cost[m].mean()),
            "mean_completion": float(comp[m].mean()),
        }
    return out


def net_utility(pocd, mean_cost, r_min, theta):
    """The paper's evaluation utility on empirical quantities (Fig 2c/3c);
    `r_min` and `theta` enter as f32, as in the reference."""
    r_min = torch.tensor(r_min, dtype=torch.float32, device=pocd.device)
    theta = torch.tensor(theta, dtype=torch.float32, device=pocd.device)
    gap = torch.clamp(pocd - r_min, min=1e-9)
    return torch.where(pocd > r_min, torch.log10(gap) - theta * mean_cost,
                       -torch.inf)
