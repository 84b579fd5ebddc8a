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
   (`kernels/csrc/dispatch_scan.cu`);
6. the fleet layer (`fleet`): `run_all(..., chunk_jobs=, block_jobs=,
   devices=1)` streams a trace in chunks of job blocks whose draws are
   keyed by (replication, global block), so chunked equals monolithic bit
   for bit, and `run_cluster(..., chunk_jobs=)` replays windows, every
   (window, replication) a segment of one dispatch launch. One card: a
   larger mesh raises. Its draws are counter-keyed Philox
   (`sim.draws.Philox.uniform_rows`, `kernels/csrc/philox_rows.cu`);
7. hedged online serving (`serve`: `run_serve`, `serve_trace`,
   `HedgedScheduler`), known-tail or with the online tail governor
   (`obs.tail`), every request's draws keyed by its rid;
8. fault injection, chunk checkpoints and resume (`chaos`, `ckpt`):
   `run_all(..., chaos=, checkpoint=, resume=)` and `run_cluster(...)`
   run the fleet's chunk loops under a seeded `FaultPlan`, and a resumed
   run gives the uninterrupted run's bits;
9. the facade, `RunConfig` and `simulate` (`api`), which route one config
   to the flat, capacity or serving path. They resolve lazily, so
   `import repro_torch` does not import the facade;
10. the governed training path (`train.Trainer`, `launch/train.py`):
   AdamW over the dense transformer's `loss_fn` with remat, the input
   pipeline (`data`) under the Chronos `runtime.StepGovernor` (the
   grid-solve kernel) and `SpeculativeTaskRunner`, with flash attention
   differentiable (the kernel forward, `attention_backward` a kernel
   too: `csrc/flash_attention_bwd_bf16.cu` on the tensor cores for
   bfloat16, `csrc/flash_attention_bwd.h` for float32; `remat="dots"` a
   selective checkpoint); with it the rest of `core` (`pareto`,
   `estimator`, `multiwave`).
"""
from .cluster import run_cluster, run_cluster_strategy
from .device import resolve_device
from .sim import (JobSet, Philox, SimParams, SimResult, build_jobset,
                  generate, run_all, run_strategy)
from .strategies import get, index_of, names, solve_jobs

__all__ = [
    "JobSet", "Philox", "RunConfig", "SimParams", "SimResult",
    "build_jobset", "generate", "get", "index_of", "names",
    "resolve_device", "run_all", "run_cluster", "run_cluster_strategy",
    "run_strategy", "simulate", "solve_jobs",
]


def __getattr__(name):
    if name in ("RunConfig", "simulate"):
        from . import api
        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
