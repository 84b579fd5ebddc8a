"""Closed-form PoCD / cost theory (paper Theorems 1-6), the Algorithm-1
solvers (Section V), the Theorem 7 orderings, the Pareto model and its
fit, startup-aware completion estimation and the work-preserving handoff
(Section VI), on tensors; multi-wave executions in numpy. Counterpart of
`repro.core` (its `*_jit` helpers need none)."""
from .pareto import (ParetoParams, cdf, fit_mle, mean, min_of_n_mean, pdf,
                     sample, sf)
from .cost import cost_clone, cost_srestart, cost_sresume
from .pocd import pocd_clone, pocd_srestart, pocd_sresume
from .utility import JobSpec, cost_of, gamma, pocd_of, utility
from .optimizer import (Solution, r_upper_bound, solve, solve_algorithm1,
                        solve_batch, solve_grid, utility_grid)
from .estimator import (ProgressReport, estimate_completion_chronos,
                        estimate_completion_naive, handoff_offset,
                        is_straggler)
from . import theory
from . import multiwave

__all__ = [
    "JobSpec", "ParetoParams", "ProgressReport", "Solution", "cdf",
    "cost_clone", "cost_of", "cost_srestart", "cost_sresume",
    "estimate_completion_chronos", "estimate_completion_naive", "fit_mle",
    "gamma", "handoff_offset", "is_straggler", "mean", "min_of_n_mean",
    "multiwave", "pdf", "pocd_clone", "pocd_of", "pocd_srestart",
    "pocd_sresume", "r_upper_bound", "sample", "sf", "solve",
    "solve_algorithm1", "solve_batch", "solve_grid", "theory", "utility",
    "utility_grid",
]
