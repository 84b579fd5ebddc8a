"""Closed-form PoCD / cost theory (paper Theorems 1-6), the Algorithm-1
solvers (Section V) and the Theorem 7 orderings, on tensors; counterpart
of `repro.core`."""
from .cost import cost_clone, cost_srestart, cost_sresume
from .pocd import pocd_clone, pocd_srestart, pocd_sresume
from .utility import JobSpec, cost_of, gamma, pocd_of, utility
from .optimizer import (Solution, r_upper_bound, solve, solve_algorithm1,
                        solve_batch, solve_grid, utility_grid)
from . import theory

__all__ = [
    "JobSpec", "Solution", "cost_clone", "cost_of", "cost_srestart",
    "cost_sresume", "gamma", "pocd_clone", "pocd_of", "pocd_srestart",
    "pocd_sresume", "r_upper_bound", "solve", "solve_algorithm1",
    "solve_batch", "solve_grid", "theory", "utility", "utility_grid",
]
