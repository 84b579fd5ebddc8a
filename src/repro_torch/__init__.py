"""PyTorch/CUDA port of the Chronos reproduction (`repro`).

The package mirrors `repro`'s module names so each counterpart is easy to
find, and imports neither `jax` nor anything of `repro`. Entry points take
an explicit `device`; they run on `cuda` by default and raise when no card
is visible, unless the caller asks for `device="cpu"`, which runs the
plain PyTorch path (kernel wrappers route CPU tensors to their plain
versions). Random numbers come from explicit `torch.Generator`s through a
uniform source the caller hands in (`repro_torch.sim.draws`).

Ported so far: the paper's trace pipeline, `sim.runner.run_all`, with the
Algorithm-1 grid solve as a hand-written CUDA kernel
(`kernels/csrc/grid_solve.cu`).
"""
from .device import resolve_device
from .sim import (JobSet, Philox, SimParams, SimResult, build_jobset,
                  generate, run_all, run_strategy)
from .strategies import get, index_of, names, solve_jobs

__all__ = [
    "JobSet", "Philox", "SimParams", "SimResult", "build_jobset", "generate",
    "get", "index_of", "names", "resolve_device", "run_all", "run_strategy",
    "solve_jobs",
]
