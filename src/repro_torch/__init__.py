"""PyTorch/CUDA port of the Chronos reproduction (`repro`).

The package mirrors `repro`'s module names so each counterpart is easy to
find, and imports neither `jax` nor anything of `repro`. Entry points take
an explicit `device`; they run on `cuda` by default and raise when no card
is visible, unless the caller asks for `device="cpu"`, which runs the
plain PyTorch path (kernel wrappers route CPU tensors to their plain
versions). Random numbers come from explicit `torch.Generator`s through a
uniform source the caller hands in (`repro_torch.sim.draws`).

Ported so far:
1. the paper's trace pipeline, `sim.runner.run_all`, with the Algorithm-1
   grid solve as a hand-written CUDA kernel (`kernels/csrc/grid_solve.cu`);
2. the quickstart path (`core`: closed forms, `solve_grid` and
   `solve_algorithm1`, `theory`), with the Monte-Carlo kernels `pocd_mc`
   and `pocd_mc_all` (`kernels/csrc/pocd_mc.cu`);
3. the text serving engine (`serve.Engine` over `models`, `configs`:
   gemma2-2b, prefill then greedy decode), with flash attention
   (`kernels/csrc/flash_attention_sm90.cu`, `flash_attention.cu`);
4. workload scenarios (`workloads`), the joint budget solve (`coupled`)
   and span tracing (`obs`), through `run_all(source, "<scenario>", p,
   budget=B)`;
5. the finite-capacity replay (`cluster`: `run_cluster` over a bounded
   slot pool, FIFO or EDF, with the governor and admission control), with
   the slot-dispatch recursion as a hand-written CUDA kernel
   (`kernels/csrc/dispatch_scan.cu`).
"""
from .cluster import run_cluster, run_cluster_strategy
from .device import resolve_device
from .sim import (JobSet, Philox, SimParams, SimResult, build_jobset,
                  generate, run_all, run_strategy)
from .strategies import get, index_of, names, solve_jobs

__all__ = [
    "JobSet", "Philox", "SimParams", "SimResult", "build_jobset", "generate",
    "get", "index_of", "names", "resolve_device", "run_all", "run_cluster",
    "run_cluster_strategy", "run_strategy", "solve_jobs",
]
