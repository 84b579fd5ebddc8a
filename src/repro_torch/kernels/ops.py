"""The kernel wrappers by the reference's names; counterpart of
`repro.kernels.ops`. Each takes CPU tensors to its plain PyTorch version
and CUDA tensors to its hand-written kernel."""
from __future__ import annotations

from .flash_attention import attention
from .grid_solve import grid_solve
from .pocd_mc import MODES, pocd_mc, pocd_mc_all

__all__ = ["MODES", "attention", "grid_solve_fused", "pocd_mc",
           "pocd_mc_all"]


def grid_solve_fused(strategy: str, jobs, r_max: int):
    """The Algorithm-1 grid solve (`kernels/grid_solve.py`) of the named
    strategy on a batched JobSpec: (r_opt, choice, utility, pocd, cost,
    sat), all (J,)."""
    from ..strategies import get
    return grid_solve(get(strategy), jobs, r_max)
