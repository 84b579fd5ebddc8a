"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (`grid_solve.py`, `pocd_mc.py`, `flash_attention.py`), built on
first use by `build.py`. `ops.py` holds the wrappers by the reference's
names, and this package exports them as the reference's does (so the
attribute `pocd_mc` is the wrapper, not its module)."""
from . import ops
from .ops import MODES, attention, grid_solve_fused, pocd_mc, pocd_mc_all

__all__ = ["MODES", "attention", "grid_solve_fused", "ops", "pocd_mc",
           "pocd_mc_all"]
