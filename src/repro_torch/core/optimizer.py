"""Algorithm 1, the unifying optimization (paper Section V.B);
counterpart of `repro.core.optimizer`. Two solvers, tested to agree:

1. `solve_algorithm1`, the paper's hybrid: gradient ascent with
   backtracking on the continuous relaxation over the concave region
   r > Gamma (Theorem 8), then exhaustive search over the integer prefix
   below Gamma (Theorem 9). The gradient comes from `torch.autograd`.
2. `solve_grid` / `solve_batch`: U over an integer grid whose upper bound
   is certified (`r_upper_bound`), through `strategies.solve_jobs`, so on
   the card this is the CUDA grid-solve kernel.

Entry points take `device=` (default the card) and move the job there.
The registry import is function-local: `repro_torch.strategies` imports
this package's leaf math.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..obs import trace as obs_trace
from .utility import JobSpec, cost_of, gamma, jobspec_to, pocd_of, utility


class Solution(NamedTuple):
    strategy: str
    r_opt: int
    utility: float
    pocd: float
    cost: float


def r_upper_bound(strategy: str, job: JobSpec, u_floor) -> int:
    """Smallest R such that U(r) < u_floor for all r >= R.

    U(r) <= lg(1 - R_min) - theta C slope r, where the spec's `r_slope`
    lower-bounds the machine time of one extra attempt.
    """
    from ..strategies import get
    spec = get(strategy)
    if spec.r_slope is None:
        raise ValueError(f"strategy {strategy!r} has no certified grid "
                         f"bound (r_slope)")
    slope = spec.r_slope(job) * float(job.theta) * float(job.C)
    cap = float(np.log10(max(1.0 - float(job.R_min), 1e-30)))
    if slope <= 0.0 or not np.isfinite(u_floor):
        return 64
    bound = int(np.ceil((cap - u_floor) / slope)) + 1
    return int(np.clip(bound, 1, 4096))


def _r(r, job: JobSpec) -> torch.Tensor:
    """r as an f32 tensor on the job's device (rounded as jnp.float32)."""
    return torch.as_tensor(r, dtype=torch.float32, device=job.t_min.device)


def utility_grid(strategy: str, job: JobSpec, r_max: int):
    """(r = 0..r_max-1, U(r)) for one job."""
    rs = torch.arange(r_max, dtype=torch.float32, device=job.t_min.device)
    return rs, utility(strategy, rs, job)


def solve_grid(strategy: str, job: JobSpec, r_max: int | None = None, *,
               device=None) -> Solution:
    """Exact integer solve for one job (0-dim JobSpec fields) over
    r < r_max; r_max=None takes the certified bound. One device-to-host
    transfer for the four results."""
    from ..strategies import solve_jobs
    with obs_trace.span("optimizer.solve_grid", strategy=strategy) as sp:
        dev = resolve_device(device)
        job = jobspec_to(job, dev)
        if r_max is None:
            u0 = float(utility(strategy, _r(0.0, job), job))
            r_max = max(r_upper_bound(strategy, job, u0), 2)
        sp.set(r_max=int(r_max))
        r, _, u, p, c, _ = solve_jobs(strategy,
                                      JobSpec(*(x.reshape(1) for x in job)),
                                      int(r_max), device=dev)
        out = torch.stack([r.to(torch.float32), u, p, c])[:, 0]
        r, u, p, c = out.tolist()
        return Solution(strategy, int(r), u, p, c)


def solve(job: JobSpec, strategies=None, *, r_max: int | None = None,
          device=None) -> Solution:
    """Best (strategy, r) for a job; `strategies=None` sweeps every
    registered Chronos strategy (`names(kind="chronos")`). `r_max` is
    `solve_grid`'s."""
    if strategies is None:
        from ..strategies import names
        strategies = names(kind="chronos")
    with obs_trace.span("optimizer.solve", n_strategies=len(strategies)):
        best = None
        for s in strategies:
            sol = solve_grid(s, job, r_max, device=device)
            if best is None or sol.utility > best.utility:
                best = sol
        return best


def solve_batch(strategy: str, jobs: JobSpec, r_max: int = 64, *,
                device=None):
    """Exact solve for a batch of jobs ((J,) JobSpec fields): (r_opt i32,
    utility, pocd, cost), all (J,). r_max must reach the certified bound;
    a job whose argmax landed on the grid's last point raises a
    RuntimeWarning, since its r* may be truncated."""
    from ..strategies import solve_jobs
    r, _, u, p, c, sat = solve_jobs(strategy, jobs, r_max, device=device)
    n_sat = int(sat.sum())
    if n_sat:
        warnings.warn(
            f"solve_batch({strategy!r}, r_max={r_max}): argmax saturated "
            f"at the grid edge for {n_sat} job(s) — r* may be truncated; "
            f"raise r_max past core.optimizer.r_upper_bound",
            RuntimeWarning, stacklevel=2)
    return r, u, p, c


def utility_grad(strategy: str, r: float, job: JobSpec) -> float:
    """dU/dr at r on the continuous relaxation, by torch.autograd."""
    rt = _r(r, job).requires_grad_()
    (g,) = torch.autograd.grad(utility(strategy, rt, job), rt)
    return float(g)


def solve_algorithm1(strategy: str, job: JobSpec, eta: float = 1e-6,
                     alpha: float = 0.3, xi: float = 0.5,
                     max_iters: int = 200, *, device=None) -> Solution:
    """Phase 1: gradient ascent with Armijo backtracking (eta, alpha, xi)
    on the concave region r >= max(ceil(Gamma), 0); Phase 2: exhaustive
    over the integer prefix below Gamma. Mirrors the paper's pseudocode."""
    job = jobspec_to(job, resolve_device(device))
    g = float(gamma(strategy, job))
    r0 = max(int(np.ceil(g)), 0)

    def u_fn(r):
        return float(utility(strategy, _r(r, job), job))

    # --- Phase 1: continuous concave maximization from r0 ---
    r = float(r0)
    if np.isfinite(u_fn(r)):
        for _ in range(max_iters):
            grad_val = utility_grad(strategy, r, job)
            if abs(grad_val) <= eta:
                break
            step = 1.0
            dr = grad_val  # ascent direction
            while True:    # Armijo backtracking
                cand = max(r + step * dr, float(r0))
                if u_fn(cand) >= u_fn(r) + alpha * step * grad_val * dr:
                    break
                step *= xi
                if step < 1e-10:
                    break
            new_r = max(r + step * dr, float(r0))
            if abs(new_r - r) < 1e-9:
                break
            r = new_r
    # concave region: the best integer is next to the continuous optimum
    cands = {r0, int(np.floor(r)), int(np.ceil(r))}
    # --- Phase 2: the integer prefix below Gamma ---
    cands.update(range(0, r0))
    best_r, best_u = 0, -np.inf
    for c in sorted(c for c in cands if c >= 0):
        u = u_fn(c)
        if u > best_u:
            best_r, best_u = c, u
    rb = _r(best_r, job)
    return Solution(strategy, best_r, best_u,
                    float(pocd_of(strategy, rb, job)),
                    float(cost_of(strategy, rb, job)))
