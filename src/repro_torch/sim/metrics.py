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


def aggregate(jobs: JobSet, completion, machine) -> SimResult:
    """Segment max of completion and segment sum of machine time per job.

    On the card the sum is `index_add_` with atomics, so its order, and
    the last bits of job_cost, vary from run to run.
    """
    J = jobs.n_jobs
    job_completion = torch.full(
        (J,), -torch.inf, dtype=completion.dtype,
        device=completion.device).scatter_reduce_(
            0, jobs.job_id, completion, "amax")
    job_machine = torch.zeros(J, dtype=machine.dtype,
                              device=machine.device).index_add_(
                                  0, jobs.job_id, machine)
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


def net_utility(pocd, mean_cost, r_min, theta):
    """The paper's evaluation utility on empirical quantities (Fig 2c/3c);
    `r_min` and `theta` enter as f32, as in the reference."""
    r_min = torch.tensor(r_min, dtype=torch.float32, device=pocd.device)
    theta = torch.tensor(theta, dtype=torch.float32, device=pocd.device)
    gap = torch.clamp(pocd - r_min, min=1e-9)
    return torch.where(pocd > r_min, torch.log10(gap) - theta * mean_cost,
                       -torch.inf)
