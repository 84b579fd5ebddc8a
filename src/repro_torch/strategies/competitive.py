"""Competitive task-cloning baselines (arXiv 1501.02330) as StrategySpecs;
counterpart of `repro.strategies.competitive`.

Both reuse `clone`'s closed forms and draw; without a budget they are
`clone` under their own registry slots. Their `allocate` policies split a
shared budget and are read only by the joint budget solve
(`repro_torch.coupled`).
"""
from __future__ import annotations

import torch

from .chronos import (closed_cost_clone, draw_clone, gamma_clone,
                      log_fail_clone, slope_clone)
from ..sim.metrics import scan_sum
from .spec import StrategySpec, register


def allocate_proportional(jobs, U, cost, budget):
    """Budget shares by priced ideal work N t_min C; the largest r whose
    priced cost fits the share, else the cheapest grid level."""
    w = jobs.N * jobs.t_min * jobs.C
    share = budget * w / torch.sum(w)
    r_max = cost.shape[1]
    slot = torch.arange(r_max, dtype=torch.int32, device=cost.device)[None]
    fits = cost <= share[:, None]
    r_cheap = torch.argmin(cost, dim=1).to(torch.int32)
    r_fit = torch.where(fits, slot, -1).amax(dim=1).to(torch.int32)
    return torch.where(r_fit >= 0, r_fit, r_cheap)


def allocate_sjf(jobs, U, cost, budget):
    """Smallest-job-first (ascending N t_min) grants of each job's
    unconstrained optimum while the cumulative spend fits the budget;
    everyone else runs at their cheapest grid level."""
    w = jobs.N * jobs.t_min
    order = torch.sort(w, stable=True).indices
    base = cost.amin(dim=1)
    r_cheap = torch.argmin(cost, dim=1).to(torch.int32)
    want = torch.argmax(U, dim=-1).to(torch.int32)
    extra = torch.gather(cost, 1, want[:, None].long())[:, 0] - base
    grant_sorted = (torch.sum(base) + scan_sum(extra[order])) <= budget
    grant = torch.empty_like(grant_sorted)
    grant[order] = grant_sorted
    return torch.where(grant, want, r_cheap)


def _clone_spec(name: str, allocate) -> StrategySpec:
    return StrategySpec(
        name=name, kind="chronos", detectable=False, draw=draw_clone,
        log_task_fail=log_fail_clone, cost=closed_cost_clone,
        gamma=gamma_clone, r_slope=slope_clone, allocate=allocate,
        form="clone")


CLONE_PROP = register(_clone_spec("clone_prop", allocate_proportional))
CLONE_SJF = register(_clone_spec("clone_sjf", allocate_sjf))
