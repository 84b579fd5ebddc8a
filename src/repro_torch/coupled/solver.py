"""Cluster-wide joint r* under a shared machine-time budget; counterpart
of `repro.coupled.solver`.

    max   sum_j U_j(r_j)
    s.t.  sum_j C_j E_j[T](r_j)  <=  B          (priced machine time)

over the integer grid Algorithm 1 enumerates. One scalar Lagrange
multiplier decouples the jobs: at price lam each job maximizes
U_j(r) - lam C_j E_j[T](r) over its precomputed grid row, and total spend
does not grow with lam, so the binding lam is found by doubling, then
bisection (`dual_lambda`).

What the port holds, on the CPU and the card:

* lam = 0 gives the independent solve's bits: U - 0 cost is U for
  finite cost grids, the grids are formed as the plain grid solve forms
  them (`kernels.grid_solve.utility_rows`), and PoCD and cost at r* are
  re-evaluated by the same code (`evaluate_at`). On the CPU a slack
  budget reproduces `solve_jobs` bit for bit; on the card `solve_jobs`
  is the CUDA kernel, which equals these grids' argmax up to near-ties.
* the selection returned is one whose spend was compared with B: the
  loop and the final selection both read `select_at`, and eager
  evaluation computes its score the same way each time, so the final
  selection's spend is the spend the loop checked; `dual_lambda` checks
  its returned lam once more, and where no lam was verified the solve
  returns the cheapest selection it could make (`cheapest`), so
  `feasible` is exactly `spend <= budget`. Levels whose U is -inf (PoCD
  below R_min) never win the priced argmax, so they count toward neither
  the cheapest selection nor feasibility.
* the loop stays on the device (`torch.where` on device scalars, no host
  read per step); the one host read of `feasible` is `warn_infeasible`'s.

The grids are plain torch, as the reference's are XLA: the budgeted path
does not launch the grid-solve kernel. Competitive cloning baselines
plug in through `StrategySpec.allocate`, which replaces the dual solve.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..core.utility import JobSpec, jobspec_to
from ..device import resolve_device
from ..kernels.grid_solve import evaluate_at, job_columns, utility_rows
from ..strategies import get
from ..strategies.spec import StrategySpec, cost_of_spec

#: doubling steps bounding lam from above (2^40 ~ 1.1e12) and the fixed
#: bisection depth, as in the reference
_DOUBLINGS = 40
_BISECT_ITERS = 60


class CoupledInfo(NamedTuple):
    """Summary of one joint solve; 0-dim tensors on the solve's device."""
    lam: torch.Tensor         # f32, the solved shadow price
    spend: torch.Tensor       # f32, priced machine time of the selection
    budget: torch.Tensor      # f32, the budget solved against
    spend_free: torch.Tensor  # f32, spend of the independent argmax
    feasible: torch.Tensor    # bool, spend <= budget
    binding: torch.Tensor     # bool, the independent solution overspends B


def utility_cost_grids(spec: StrategySpec, jobs: JobSpec, r_max: int):
    """(U, E), each (J, r_max), over r = 0..r_max-1: U as the plain grid
    solve forms it, E the unpriced expected machine time. Priced spend is
    E * C."""
    col = job_columns(jobs)
    rs = torch.arange(r_max, dtype=torch.float32,
                      device=jobs.t_min.device)[None, :]
    return utility_rows(spec, col, rs), cost_of_spec(spec, rs, col)


def _gather(grid, i):
    return torch.gather(grid, 1, i[:, None].long())[:, 0]


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def select_at(U, cost, lam):
    """Per-job first argmax of the lam-priced score U - lam cost, (J,)
    int32. The dual loop and the final selection both call this, and in
    eager PyTorch the score is the same at the same lam each time."""
    return torch.argmax(U - lam * cost, dim=-1).to(torch.int32)


def cheapest(U, cost):
    """Per-job cheapest level the priced argmax can select, (J,) int32:
    the least cost over levels with finite U (a row whose U is -inf
    throughout keeps level 0, the argmax's pick). This is the selection
    as lam grows without bound."""
    reach = torch.where(torch.isfinite(U), cost, torch.inf)
    return torch.argmin(reach, dim=1).to(torch.int32)


def spend_at(U, cost, lam):
    """Total priced spend of the lam-selection (non-increasing in lam)."""
    return torch.sum(_gather(cost, select_at(U, cost, lam)))


def dual_lambda(U, cost, budget):
    """Smallest lam >= 0 whose selection spends <= budget, as (lam, ok),
    0-dim device tensors; ok says lam's selection was checked to spend
    <= budget.

    Doubling brackets lam, then fixed-depth bisection moves the upper
    end only where the check passed; the returned lam is checked once
    more. Where no bracket end passed (no selection fits, or one fits
    only where f32 cannot price it), ok is False and lam is the bracket's
    upper end. No host read.
    """
    budget = _f32(budget, U)
    zero = torch.zeros((), dtype=torch.float32, device=U.device)
    slack = spend_at(U, cost, zero) <= budget
    hi = torch.ones_like(zero)
    for _ in range(_DOUBLINGS):
        hi = torch.where(spend_at(U, cost, hi) <= budget, hi, hi * 2.0)
    lo = zero
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        ok = spend_at(U, cost, mid) <= budget
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    lam = torch.where(slack, zero, hi)
    return lam, spend_at(U, cost, lam) <= budget


def coupled_from_grids(spec: StrategySpec, jobs: JobSpec, U, E, budget):
    """Joint selection from precomputed grids. jobs: (J,) JobSpec of the
    grid rows; U, E: (J, r_max) from `utility_cost_grids`. Returns the
    `solve_jobs` tuple (r, choice, u, p, c, sat), c unpriced, and a
    `CoupledInfo` whose `feasible` is the returned selection's
    spend <= budget, for the dual solve and an `allocate` policy alike."""
    r_max = U.shape[1]
    cost = E * jobs.C[:, None]          # priced grid: what the budget caps
    budget = _f32(budget, U)
    spend_free = torch.sum(_gather(cost, torch.argmax(U, dim=-1)))
    if spec.allocate is not None:
        i = spec.allocate(jobs, U, cost, budget).to(torch.int32)
        lam = torch.zeros_like(budget)
    else:
        lam, ok = dual_lambda(U, cost, budget)
        i = torch.where(ok, select_at(U, cost, lam), cheapest(U, cost))
    spend = torch.sum(_gather(cost, i))
    choice, p, c = evaluate_at(spec, i, job_columns(jobs))
    info = CoupledInfo(lam=lam, spend=spend, budget=budget,
                       spend_free=spend_free, feasible=spend <= budget,
                       binding=spend_free > budget)
    sat = (i >= r_max - 1).to(torch.int32)
    return (i, choice, _gather(U, i), p, c, sat), info


def solve_jobs_coupled(strategy: str, jobs: JobSpec, r_max: int, budget, *,
                       device=None):
    """Budgeted counterpart of `strategies.solve_jobs`, on `device`
    (default the card): ((r, choice, u, p, c, sat), CoupledInfo). `c` is
    unpriced E[T]; the budget caps priced spend sum(C E[T])."""
    spec = get(strategy)
    if not spec.optimized:
        raise ValueError(f"strategy {strategy!r} is a baseline (r = 0 "
                         f"always): a speculation budget cannot apply")
    jobs = jobspec_to(jobs, resolve_device(device))
    U, E = utility_cost_grids(spec, jobs, r_max)
    return coupled_from_grids(spec, jobs, U, E, budget)


def warn_infeasible(strategy: str, info: CoupledInfo):
    """One RuntimeWarning per solve when the returned selection spends
    more than B (the dual solve then returned `cheapest`'s selection, an
    `allocate` policy its own); one host read."""
    if not bool(info.feasible):
        warnings.warn(
            f"coupled solve[{strategy}]: no selection meets the budget "
            f"{float(info.budget):.6g}: the returned selection spends "
            f"{float(info.spend):.6g} (over budget)",
            RuntimeWarning, stacklevel=3)


def repair_independent(U, E, C, budget):
    """Naive feasible baseline: walk every job the same fraction of the
    way from its independent r* back toward its cheapest grid level,
    floored to the grid, bisecting on the fraction and keeping only
    fractions whose spend it verified. (J,) int32."""
    cost = E * C[:, None]
    budget = _f32(budget, U)
    i_free = torch.argmax(U, dim=-1).to(torch.int32)
    i_cheap = cheapest(U, cost)
    spend_free = torch.sum(_gather(cost, i_free))

    def scaled(s):
        step = (i_free - i_cheap).to(torch.float32) * s
        return i_cheap + torch.floor(step).to(torch.int32)

    lo = torch.zeros((), dtype=torch.float32, device=U.device)
    hi = torch.ones_like(lo)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        ok = torch.sum(_gather(cost, scaled(mid))) <= budget
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(spend_free <= budget, i_free, scaled(lo))


def total_utility(U, i) -> float:
    """Float64 total of the selected per-job utilities, summed on the host
    in trace order."""
    u = _gather(U, i).cpu().numpy()
    return float(np.sum(u.astype(np.float64)))
