"""Cluster-wide joint r* under a shared machine-time budget (a Lagrangian
dual over Algorithm 1); counterpart of `repro.coupled`.
`solve_jobs_coupled(strategy, jobs, r_max, budget)` is the budgeted
counterpart of `strategies.solve_jobs`; `sim.runner.run_all(...,
budget=)` threads it through the trace runner."""
from .solver import (CoupledInfo, coupled_from_grids, dual_lambda,
                     repair_independent, select_at, solve_jobs_coupled,
                     spend_at, total_utility, utility_cost_grids,
                     warn_infeasible)

__all__ = [
    "CoupledInfo", "coupled_from_grids", "dual_lambda",
    "repair_independent", "select_at", "solve_jobs_coupled", "spend_at",
    "total_utility", "utility_cost_grids", "warn_infeasible",
]
