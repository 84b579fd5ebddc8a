#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases; each raises on failure, so any failure exits non-zero:

1. print the card (nvidia-smi name and power limit) and build every kernel
   of the main path from `src/repro_torch/kernels/csrc/` (grid_solve.cu,
   pocd_mc.cu, flash_attention.cu, flash_attention_sm90.cu,
   dispatch_scan.cu), one nvcc process per source, timed, with ptxas's
   registers and spills (dispatch_scan's for both pool placements), and
   the tensor-core kernel's dynamic shared memory;
2. hold each kernel against its plain PyTorch version on the card, for
   every optimized strategy at (J, r_max) = (37, 9), (64, 33), (2700, 9)
   and (65536, 64): r*, choice and sat equal; U rtol 1e-4 / atol 1e-5,
   PoCD rtol 1e-5 / atol 1e-7, cost rtol 1e-4 / atol 1e-5 (the reference's
   own kernel tolerances, tests/test_grid_solve.py). The kernel's device
   time per launch (torch.profiler), the wrapper's and the plain
   version's call times (CUDA events), and the least time the card could
   take (operations counted from grid_solve.cu: the quadrature's factors
   that do not depend on r once per job, one powf per (r, node)). The
   (2700, 9) times make the kernels line's sum over one run_all; the
   (65536, 64) times, a fleet-sized chunk, stand beside them;
3. the main path: `run_all` over the paper's trace, generate(2700, seed=0)
   (912,199 tasks), all registered strategies, max_r=8, at reps=1 and
   reps=8, twice each; the grid-solve launch count is set to 0 before
   each run and must read 6 (one per optimized strategy) after it, and
   the two runs must give the same job_cost and job_met bits for every
   strategy (the per-job sums are fixed-order segment sums). Cold and warm
   wall times per strategy come from `run_strategy` calls made just
   before, in run_all's order;
4. replay the uniforms of one reps=1 run on the card through the plain
   CPU path: r* equal, job_met equal except jobs whose completion lies
   within f32 rtol 1e-5 of the deadline, pocd within rtol 1e-5 (plus 1/J
   per such job) and mean_cost within rtol 1e-4;
5. one torch.profiler pass over run_all reps=1: device busy time, idle
   share and the top device ops;
6. workloads on the card: every registered scenario synthesized at its
   registry default size (paper-hadoop 2700 jobs, request-storm 20,000,
   the others 600), timed first and warm, summarized, the same columns
   twice; its variates copied to the CPU and run through the CPU path:
   integer columns equal, float columns within rtol 1e-5, every job at
   the same place in arrival order unless its arrival ties within that
   tolerance (counted); paper-hadoop within tests/test_workloads.py's
   calibration bounds of PAPER_TRACE_STATS;
7. the grid-solve kernel on every scenario's inputs (jobspecs_of at theta
   1e-4, R_min 0.03, r_max 9): against its plain version for every
   optimized strategy with phase 2's tolerances, timed per scenario (one
   run_all's six launches) and per strategy at request-storm's J = 20,000;
8. run_all(Philox(0), name, SimParams(), reps=1) for every scenario by
   name, twice: 6 grid-solve launches a run (the counter's readings
   printed), the same job_cost and job_met bits; class_summary of
   multi-tenant-sla (per-tier PoCD, cost, mean r*) for every optimized
   strategy;
9. the budgeted path at the paper's scale: multi-tenant-sla at 2700 jobs,
   B the midpoint of clone's band [sum of per-job minimum priced cost,
   spend at the independent argmax] from the port's grids at run_all's
   R_min; run_all(..., budget=B) launches the grid-solve kernel 0 times
   and spends at most B wherever feasible (lam, spend, spend_free,
   feasible, binding printed per strategy); the reference's acceptance
   property for clone at B and at R_min 0 (the reference test's): total
   utility of the dual selection >= repair_independent's and > clone_prop's
   and clone_sjf's, each within budget; at budget=1e12, r* of the plain
   grids equal to the kernel's (unbudgeted run) but near-ties within
   phase 2's U tolerance (counted), job_met / job_cost bit-equal where
   all r* are equal, lam 0 and not binding (clone_prop, whose policy fills
   each job's budget share, is exempt from the r* identity, as in the
   reference); at half the minimum spend a RuntimeWarning and, per job,
   the cheapest level with finite U; at a budget between the sum of row
   minima and the cheapest selection with finite U (a window that exists
   only because R_min > 0 makes some levels' U -inf), either a selection
   within B or feasible False with a RuntimeWarning; the budgeted solve's
   call time, device launches and busy time per strategy;
10. one traced run_all("multi-tenant-sla", budget=B') with obs.enable()
   (B' the band midpoint at the default size): the spans
   workloads.synthesize, workloads.jobset_build, sim.run[<s>] and
   sim.run[<s>].wait for every strategy, stage_breakdown's top entries,
   coverage, the Chrome trace written to chiprun_out/spans.json, and the
   traced wall beside the untraced one;
10b. the capacity replay (repro_torch.cluster): the dispatch kernel
   (csrc/dispatch_scan.cu) against its plain version, whole outputs
   (starts and final pool) bit-equal, on tests/test_torch_cluster.py's
   inputs (ties in release and in free times, 20% inactive), FIFO and
   EDF, at K = 1, 5, 37, 300, 20,000 (the pool in shared memory) and
   100,000 (in device memory); the uniform 150x10 trace at K = 20,000
   (starts equal releases, mean wait 0); the paper trace's offered
   primary load at 500 slots (cluster.offered_load, 3600 s windows: mean,
   p95, max); then the main path,
   run_cluster(Philox(0), generate(2700, seed=0), SimParams(), slots=500,
   theta=1e-4) over all 10 strategies at reps 1, twice, traced: 6
   grid-solve and 20 dispatch launches a run, job_cost and job_met the
   same bits, each strategy's first and warm wall from its spans, and its
   PoCD, utilization and mean wait printed beside the JAX package's (a
   sanity line); every strategy's full replay (build_strategy_table +
   replay, the table not narrowed): the main path's bits, start >=
   release, at most 500 units in service (an integer sweep over start
   and start + hold events), 0 <= utilization <= 1 + 1e-6; for clone and
   hadoop_s both passes' dispatch-ordered inputs rebuilt with the
   engine's functions, the kernel on the full arrays equal to the plain
   version on the CPU over the first 100,000 rows; slots=None against
   run_all (r* equal, job_met equal but at deadline ties, 0 dispatch
   launches); EDF with passes=3, the governor and admission (slack 1.0)
   for sresume; slots 250 to 2000 and None for sresume and hadoop_s; a
   budgeted run_cluster on 2700 multi-tenant-sla jobs at phase 9's B
   (spend <= B wherever feasible). Timed at the very end of the script,
   after every other profiler session (a large session can cost the next
   one its first records): a profiled warm run_cluster (busy, idle share,
   top ops; the kernel's device time per run, per pass and per step,
   the sorts'), taken again until it records all 20 dispatch launches
   (up to three times; else the mean over those recorded, at least
   half, times 20), the wrapper's call on clone's pass 2 and the small
   case's kernel and plain times. Its JSON is also written to
   chiprun_out/cluster.json;
11. the quickstart path (examples/quickstart.py step for step, through the
   port, on the card): JobSpec.make, the closed forms at r = 0..3,
   solve_grid and solve_algorithm1 (equal r*), gamma, the Theorem 7
   orderings, and the Monte-Carlo cross-check of clone and sresume with
   pocd_mc at (J, N, R) = (4096, 10, 4), clone within 0.02 of Theorem 1;
   then the full-width cross-check: the trace job whose task count is
   nearest the trace's mean (338), r* per mode by solve_grid, and one
   pocd_mc_all launch over 65,536 replications x N x R (R = max r* + 2,
   at least 4), clone within 0.01 of Theorem 1. The launch counts are set
   to 0 before the phase and must read pocd_mc 2, pocd_mc_all 1 and
   grid_solve 6 after it. A second, warm run gives each step's wall time,
   and a third, profiled run the device busy time and idle share;
12. check the premise of the Monte-Carlo kernel's range minima with its
   own build: logf non-decreasing over every f32 in (0, 1] and expf over
   every f32 in [0, 89) (0 violations, else the phase fails); then hold
   pocd_mc (each mode) and pocd_mc_all against their plain versions
   on the card at the reference test shapes (256, 16, 6), (128, 64, 4),
   (384, 8, 8), (200, 8, 4), (129, 8, 4), the benchmark shape
   (1024, 32, 6), the quickstart shape (4096, 10, 4) and the full width,
   each with r in [0, R-1) and with r >= R-1: met equal except jobs with
   a task within f32 rtol 1e-5 of D (counted), cost within rtol 2e-5,
   row m of pocd_mc_all equal to pocd_mc of mode m. Per shape and kernel:
   device time per launch (torch.profiler), wrapper call and plain times
   (CUDA events), the bound (the uniforms the modes' slot ranges need)
   and the dense bound (every uniform, which the card reads at R = 5);
13. time the path's own launches (phase 11's inputs) for the kernels line:
   pocd_mc at the quickstart shape, pocd_mc_all at the full width, and
   each single-mode launch on the full-width inputs;
14. hold the flash-attention kernels against their plain version on the
   card (each launch synchronized): tests/test_kernels.py's shapes in f32
   and bf16 (MHA (1, 4, 256, 64) and (2, 8, 256, 128), GQA with 1, 2 and
   4 kv heads, softcap and non-causal), ragged lengths 200 and 77, head
   dim 256, the bf16 edge shapes (D 64, 128, 256; 1, 2, 4 kv heads;
   S 77, 200, 2048, 2049; causal with and without softcap, non-causal
   with softcap 30; contiguous and strided (B, S, heads, D) views), and
   the serving path's shape (B 4, H 8, K 4, S 2048, D 256, causal,
   softcap 50, bf16, as the model's strided views), within f32 2e-5 /
   bf16 2e-2 (the reference's own kernel tolerances). Softcap cases with
   q scaled by 16 (FA_HOT_SHAPES, the path's shape among them) put the
   scores past the cap, where a wrong tanh shows. Every bf16 case is also
   held against the output's own size: mean |err| within 2^-8 of mean
   |want|, max |err| within 2^-6 of max |want|. Every bf16 case must move
   the tensor-core route's count by one and every f32 case the SIMT
   route's. At the path's shape: the tensor-core kernel's ms
   (torch.profiler) and call ms (CUDA events), the SIMT kernel's on the
   same bf16 inputs through its own launcher (the previous design, never
   on the path; held once against the plain version), the plain ms, the
   bound, and the yardstick
   F.scaled_dot_product_attention(is_causal=True, enable_gqa=True) on the
   same inputs without the softcap (no PyTorch call has one; the port
   never calls it);
15. the serving path at full width. First a reference check on a small
   input: gemma2-2b cut to 2 layers, f32 compute, the same seeded weights
   on the card (through the SIMT kernel, the f32 route: 2 launches) and on
   the CPU (through the plain version, which the CPU tests hold against
   the JAX package), B 2, prompt 200, 4 decode steps fed the CPU's
   choices: logits within 1e-4 at every step, and the choices equal
   wherever the CPU's top-2 margin exceeds 2e-4. Then gemma2-2b unreduced (26 layers, d 2304, 8/4 heads,
   head dim 256, d_ff 9216, vocab 256,000; 3.2 B parameters, weights
   cast once to bf16) built on the card from a seeded generator; the
   batch make_batch(cfg, 4, 2048, "prefill", seed=0); max_seq 2080;
   generate 32 tokens. Every launch count is set to 0 just before the
   first generate and read just after: flash attention must read 26 (one
   per layer of the one prefill), all on the tensor-core route. Build s, prefill ms first and warm,
   decode ms per token, tokens/s, peak device memory, and one warm
   generate under the profiler (device busy, idle share, the kernel's
   share); the tokens must be in range and equal between the first and
   the warm generate; then one prefill and the 32 decode steps profiled
   apart.

The last lines are the cluster JSON (phase 10b), the scenarios JSON
(phases 6-10), the kernels JSON, the card line and the result JSON.
The script needs one CUDA card and exits non-zero without one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import Philox, SimParams, generate, names, run_all  # noqa: E402
from repro_torch import run_strategy  # noqa: E402
from repro_torch.core import (JobSpec, cost_of, gamma, pocd_of,  # noqa: E402
                              solve_algorithm1, solve_grid, theory, utility)
from repro_torch import obs  # noqa: E402
from repro_torch.cluster import (DISCIPLINES, AdmissionConfig,  # noqa: E402
                                 GovernorConfig, admit_jobs,
                                 build_strategy_table, dispatch_key_order,
                                 masked_dispatch, offered_load,
                                 predicted_holds, replay, run_cluster,
                                 run_cluster_strategy)
from repro_torch.cluster.engine import (combined_release,  # noqa: E402
                                        primary_slice)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.coupled import (repair_independent,  # noqa: E402
                                 solve_jobs_coupled, total_utility,
                                 utility_cost_grids)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import dispatch_scan as ds  # noqa: E402
from repro_torch.kernels import grid_solve as gs  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models.inputs import make_batch  # noqa: E402
from repro_torch.models.transformer import padded_vocab  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.sim.draws import WorkloadPhilox  # noqa: E402
from repro_torch.sim.metrics import aggregate, class_summary  # noqa: E402
from repro_torch.sim.runner import jobspecs_of  # noqa: E402
from repro_torch.sim.trace import jobset_to, uniform_jobset  # noqa: E402
from repro_torch.strategies import get  # noqa: E402
from repro_torch.workloads import (PAPER_TRACE_STATS,  # noqa: E402
                                   TRACE_COLUMNS, get_scenario,
                                   list_scenarios, make_jobset, make_trace,
                                   summarize, synthesize)

# the module of the Monte-Carlo kernels (its launch counts); the package
# attribute `repro_torch.kernels.pocd_mc` is the wrapper function
pm = importlib.import_module("repro_torch.kernels.pocd_mc")
fa = importlib.import_module("repro_torch.kernels.flash_attention")

# H100 SXM data sheet, at the full 700 W: HBM rate, the f32 rate outside
# the tensor cores and the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12

# f32 operations of csrc/grid_solve.cu, counted from the source: each add,
# mul, div, compare or select and each transcendental call (powf, logf,
# ...) counts one, so this is a lower bound on the work. OPS_PER_POINT is
# per (job, r) and family outside the quadrature; OPS_PER_JOB the terms
# that do not depend on r, formed once per job (load_job): the log-miss
# head of every family, the straggler probability and E[T | T <= D] that
# the reactive families share ("slow"), and each one's own. S-Restart's
# quadrature adds, per (job, r), 5 per node (one powf, three products, one
# add) and 1 (beta r): QUAD_OPS_PER_R; and per job, once, the factors that
# do not depend on r, 7 per node (w, w + tau, the quotient, its powf,
# t_min / w, u^2, Dm / u^2): QUAD_OPS_PER_JOB. I(r*) is kept from the
# grid, so the re-evaluation at r* costs OPS_PER_POINT alone.
OPS_PER_POINT = {"clone": 28, "srestart": 39, "sresume": 39}
OPS_PER_JOB = {"head": 4, "slow": 21, "srestart": 10, "sresume": 10}
QUAD_OPS_PER_R = 5 * 128 + 1
QUAD_OPS_PER_JOB = 7 * 128

# f32 operations of csrc/pocd_mc.cu, counted from the source as above:
# forming one attempt time (logf, negate, divide, expf, multiply); the
# kernel forms T1 for every task, clone's best where its range passes
# slot 0, and a straggler's one or two range minima; one compare per slot
# read into a range maximum; per task and mode the mode's outcome (the
# clone and reactive bills, the deadline compare, the AND and the sum),
# plus one straggler compare per task
OPS_PER_ATTEMPT = 5
OPS_PER_TASK = {"clone": 5, "srestart": 13, "sresume": 11}
MODE_BITS = {"clone": 1, "srestart": 2, "sresume": 4}

# (J, N, R): tests/test_kernels.py's shapes, benchmarks/perf.py's and
# examples/quickstart.py's; the full width is added at run time
MC_SHAPES = ((256, 16, 6), (128, 64, 4), (384, 8, 8), (200, 8, 4),
             (129, 8, 4), (1024, 32, 6), (4096, 10, 4))
MC_COST_RTOL = 2e-5          # the reference's own kernel tolerance
QUICKSTART = dict(t_min=10.0, beta=2.0, D=50.0, N=10, tau_est=3.0,
                  tau_kill=8.0, phi_est=0.25, C=1.0, theta=1e-3, R_min=0.0)
QS_SHAPE = (4096, 10, 4)
FULL_REPS = 65536

TOL = {"u": (1e-4, 1e-5), "pocd": (1e-5, 1e-7), "cost": (1e-4, 1e-5)}

# flash attention: (B, H, K, S, D, dtype, causal, softcap, views); the
# reference test's shapes (tests/test_kernels.py), ragged lengths, head dim
# 256, then the tensor-core kernel's edge shapes (those of
# tests/test_torch_flash_attention.py's card test): every head dim, 1, 2
# and 4 kv heads, ragged and tile-multiple lengths, the three mask modes,
# contiguous and the model's strided (B, S, heads, D) views
FA_SHAPES = tuple(
    [(1, 4, 4, 256, 64, dt, True, None, False)
     for dt in ("float32", "bfloat16")]
    + [(2, 8, 8, 256, 128, dt, True, None, False)
       for dt in ("float32", "bfloat16")]
    + [(1, 8, kv, 256, 64, "float32", True, None, False) for kv in (1, 2, 4)]
    + [(1, 2, 2, 256, 64, "float32", c, cap, False)
       for c, cap in ((False, None), (True, 50.0), (False, 30.0))]
    + [(2, 4, 2, 200, 64, "float32", True, 50.0, False),
       (2, 8, 4, 77, 256, "bfloat16", True, 50.0, False),
       (1, 8, 4, 512, 256, "float32", True, 50.0, False)]
    + [(1, 8, (1, 2, 4)[(i + i // 3) % 3], S, D, "bfloat16", causal, cap,
        i % 2 == 1)
       for i, (D, S, (causal, cap)) in enumerate(
           (D, S, mode) for D in (64, 128, 256) for S in (77, 200, 2048, 2049)
           for mode in ((True, None), (True, 50.0), (False, 30.0)))])
# softcap cases with q scaled by FA_HOT_SCALE: the scores reach and pass
# the cap (std 16 against caps of 30 and 50), so a kernel that computes
# the tanh wrongly, or not at all, fails them; unscaled scores (std 1)
# stay where cap * tanh(s / cap) is within 0.02 of s
FA_HOT_SCALE = 16.0
FA_HOT_SHAPES = (
    (4, 8, 4, 2048, 256, "bfloat16", True, 50.0, True),
    (1, 8, 2, 2049, 128, "bfloat16", False, 30.0, True),
    (1, 8, 4, 2048, 64, "bfloat16", False, 30.0, False),
    (2, 8, 4, 77, 256, "bfloat16", True, 50.0, False),
    (1, 8, 1, 200, 64, "bfloat16", True, 50.0, True),
    (1, 8, 4, 512, 256, "float32", True, 50.0, False))
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# bf16 only, beside FA_TOL: errors held against the output's own size,
# mean |err| <= FA_MEAN_REL mean |want| and max |err| <= FA_MAX_REL
# max |want|; about 2.5x the largest readings of every bf16 case on an
# H100 (0.0016 and 0.0061)
FA_MEAN_REL = 2.0 ** -8
FA_MAX_REL = 2.0 ** -6
# the serving path: gemma2-2b, batch 4, a 2048-token prompt, 32 tokens
SERVE = dict(arch="gemma2-2b", batch=4, prompt=2048, tokens=32)
FA_PATH = (SERVE["batch"], 8, 4, SERVE["prompt"], 256, "bfloat16", True,
           50.0)
CHECK_SERVE = dict(layers=2, batch=2, prompt=200, tokens=4, tol=1e-4)
SOURCES = ("grid_solve", "pocd_mc", "flash_attention",
           "flash_attention_sm90", "dispatch_scan")
CHECK_SHAPES = ((37, 9), (64, 33), (2700, 9), (65536, 64))
FLEET_SHAPE = (65536, 64)   # a fleet-sized chunk (ROADMAP A.5)
THETA = 1e-4
CHECK_R_MIN = 0.03   # about the main path's R_min, so -inf rows occur
# the card's workload columns against the CPU's from the same variates
WORKLOAD_RTOL = 1e-5
# the budgeted path at the paper trace's job count
BUDGET_JOBS = 2700
# budget-share policy that ignores U, so a slack budget does not give
# the independent solve (as in the reference)
SLACK_EXEMPT = ("clone_prop",)
# the capacity replay: the paper trace on a pool of 500 slots (a loaded
# pool, not a drowned one: phase 10b prints the offered primary load over
# 3600 s windows), a sweep of pool sizes, the kernel's
# test cases (K 20,000 keeps the pool in shared memory, 100,000 puts it in
# device memory) and the rows of the full-size prefix check
CLUSTER_SLOTS = 500
CLUSTER_SWEEP = (250, 500, 1000, 2000, None)
DISPATCH_KS = (1, 5, 37, 300, 20_000, 100_000)
PREFIX_ROWS = 100_000
# (PoCD, utilization, mean wait s) of the JAX package's run_cluster on the
# same trace at 500 slots, run on a CPU with its own jax.random draws:
# printed beside the port's as a sanity line, not a check
REF_AT_500 = {
    "hadoop_ns": (0.019, 0.080, 82.8), "hadoop_s": (0.169, 0.475, 44.9),
    "mantri": (0.257, 0.475, 42.3), "clone": (0.515, 0.562, 77.3),
    "srestart": (0.600, 0.400, 32.9), "sresume": (0.614, 0.391, 31.7),
    "hedge": (0.033, 0.487, 45.6), "adaptive": (0.619, 0.391, 31.6),
    "clone_prop": (0.520, 0.562, 77.4), "clone_sjf": (0.518, 0.562, 77.3)}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(name: str, marker: str) -> dict:
    """Registers, spills and stack of the kernel of `csrc/<name>.cu` whose
    mangled name holds `marker`, from ptxas's -v report in the build log."""
    import re
    out, inside = {}, False
    for line in build.build_log(name).splitlines():
        if "Compiling entry function" in line:
            inside = marker in line
        elif inside:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                          r" (\d+) bytes spill loads", line)
            if m:
                out.update(stack=int(m[1]), spill_stores=int(m[2]),
                           spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out["registers"] = int(m[1])
    if "registers" not in out:
        raise AssertionError(f"no ptxas report of {marker} in {name}'s log")
    return out


def cuda_ms(fn, iters: int) -> float:
    """Mean time of fn() over `iters` back-to-back calls, CUDA events: the
    call's cost as a caller sees it (host enqueue included where the host
    is slower than the card)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_ms(fn, iters: int, name, tries: int = 3) -> float:
    """Mean device time per launch of the kernels whose name holds `name`
    (a string, or a tuple of alternatives), from torch.profiler over
    `iters` calls of fn(). The profiler now and then drops kernel records
    (one session of 20 launches has shown 2), so a session that does not
    see all `iters` is run again, up to `tries` sessions; after that the
    session that saw the most launches is taken if it saw at least half,
    and the mean is over the launches it recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names_ = (name,) if isinstance(name, str) else name
    fn()
    torch.cuda.synchronize()
    seen, best = [], (0, 0.0)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and any(n in e.key for n in names_)]
        count = sum(e.count for e in rows)
        total = sum(e.device_time_total for e in rows)
        if count == iters:
            return total / count / 1e3
        seen.append(count)
        best = max(best, (count, total))
    if 2 * best[0] >= iters and best[0] <= iters:
        print(f"  profiler saw {seen} of {iters} {name} launches in "
              f"{tries} sessions; mean over the {best[0]} it recorded")
        return best[1] / best[0] / 1e3
    raise AssertionError(f"profiler saw {seen} {name} launches in {tries} "
                         f"sessions, expected {iters}")


def grid_solve_bound(spec, J: int, r_max: int):
    """(bytes ms, operations ms) for one grid solve: the least time the card
    could take is the larger of the two."""
    forms = [get(n).form for n in (spec.components or (spec.name,))]
    per_r = sum(OPS_PER_POINT[f] for f in forms)
    # the grid, then every form again at r*; one max per extra form and
    # one argmax compare per grid point; the quadrature where S-Restart is
    reactive = [f for f in forms if f != "clone"]
    per_job = (OPS_PER_JOB["head"] + (OPS_PER_JOB["slow"] if reactive else 0)
               + sum(OPS_PER_JOB[f] for f in set(reactive)))
    ops = J * ((r_max + 1) * per_r + r_max * len(forms) + per_job)
    if "srestart" in forms:
        ops += J * (r_max * QUAD_OPS_PER_R + QUAD_OPS_PER_JOB)
    nbytes = J * (10 + 6) * 4 + 2 * 128 * 4
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S


def bound_of(bytes_ms: float, ops_ms: float):
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def check_grid(spec, job, r_max: int, what: str) -> list:
    """The kernel against the plain version on one input: r*, choice and
    sat equal, U, PoCD and cost within TOL. Returns the max |error| of U,
    PoCD and cost over finite entries."""
    k = gs.grid_solve(spec, job, r_max)
    ref = gs.grid_solve_plain(spec, job, r_max)
    torch.cuda.synchronize()
    for i, name in ((0, "r*"), (1, "choice"), (5, "sat")):
        if not torch.equal(k[i], ref[i]):
            bad = int((k[i] != ref[i]).sum())
            raise AssertionError(f"grid_solve[{spec.name}] {what}: {name} "
                                 f"differs from the plain version in {bad} "
                                 f"jobs")
    errs = []
    for i, name in ((2, "u"), (3, "pocd"), (4, "cost")):
        rtol, atol = TOL[name]
        close = torch.isclose(k[i], ref[i], rtol=rtol, atol=atol)
        if not bool(close.all()):
            raise AssertionError(
                f"grid_solve[{spec.name}] {what}: {name} outside rtol {rtol}"
                f" / atol {atol} in {int((~close).sum())} jobs")
        fin = torch.isfinite(ref[i])
        errs.append(float((k[i] - ref[i])[fin].abs().max())
                    if bool(fin.any()) else 0.0)
    return errs


def grid_times(spec, job, r_max: int) -> dict:
    """Kernel ms per launch (profiler), wrapper call and plain ms (CUDA
    events) and the bound of one grid solve."""
    J = job.t_min.shape[0]
    launch = lambda: gs.grid_solve_cuda(spec, job, r_max)
    bytes_ms, ops_ms = grid_solve_bound(spec, J, r_max)
    return dict(ms=kernel_ms(launch, 20, "grid_solve"),
                call_ms=cuda_ms(launch, 50),
                plain_ms=cuda_ms(lambda: gs.grid_solve_plain(spec, job,
                                                             r_max), 5),
                bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=bound_of(bytes_ms, ops_ms)[0])


def phase_check(dev, p: SimParams) -> dict:
    """Kernel against plain on the card at every check shape."""
    out = {"max_abs_err": 0.0, "main": {}, "fleet": {}}
    for J, r_max in CHECK_SHAPES:
        job = jobspecs_of(generate(J, seed=0, device=dev), p, THETA,
                          CHECK_R_MIN)
        for name in names("optimized"):
            spec = get(name)
            errs = check_grid(spec, job, r_max, f"J={J} r_max={r_max}")
            out["max_abs_err"] = max(out["max_abs_err"], *errs)
            row = grid_times(spec, job, r_max)
            print(f"grid_solve[{name}] J={J} r_max={r_max}: equal r*/choice/"
                  f"sat; max abs err u {errs[0]:.3g} pocd {errs[1]:.3g} "
                  f"cost {errs[2]:.3g}; kernel {row['ms']:.4f} ms (wrapper "
                  f"call {row['call_ms']:.4f} ms), plain {row['plain_ms']:.3f}"
                  f" ms, bound {row['bound_ms']:.6f} ms "
                  f"({bound_of(row['bytes_ms'], row['ops_ms'])[1]})")
            if (J, r_max) == (2700, 9):
                out["main"][name] = row
            elif (J, r_max) == FLEET_SHAPE:
                out["fleet"][name] = row
    return out


def timed_run_all(source, jobs, p, reps: int, dev):
    """One run_all on the card: (outs, r_min, wall s); the launch count is
    set to 0 just before and must read 6 just after."""
    gs.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, r_min = run_all(source, jobs, p, theta=THETA, max_r=8, reps=reps,
                          device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = len(names("optimized"))
    if gs.launches != want:
        raise AssertionError(f"run_all reps={reps} launched the grid-solve "
                             f"kernel {gs.launches} times, expected {want}")
    return outs, r_min, wall


def check_deterministic(a: dict, b: dict, reps: int) -> None:
    """Two run_all outputs of the same source: job_cost (and job_met) the
    same bits for every strategy, as the reference's segment_sum gives."""
    for name, x in a.items():
        y = b[name]
        if not (torch.equal(x.result.job_cost, y.result.job_cost)
                and torch.equal(x.result.job_met, y.result.job_met)):
            bad = int((x.result.job_cost != y.result.job_cost).sum())
            raise AssertionError(f"run_all reps={reps} {name}: job_cost "
                                 f"differs between two runs in {bad} jobs")
    print(f"run_all reps={reps}: job_cost and job_met bit-equal between two "
          f"runs for all {len(a)} strategies")


def strategy_walls(jobs, p, reps: int, dev) -> dict:
    """{strategy: (first call s, second call s)} of run_strategy, in
    run_all's order and with its R_min; at reps=1 the first calls are the
    process's first runs of each strategy (cold)."""
    walls, r_min = {}, 0.0
    for name in names():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run_strategy(Philox(0), jobs, name, p, theta=THETA,
                               r_min=r_min, reps=reps, device=dev)
            torch.cuda.synchronize()
            walls.setdefault(name, []).append(time.perf_counter() - t0)
        if name == "hadoop_ns":
            r_min = float(out.result.pocd) - 1e-3
    return walls


class Recording:
    """A uniform source that keeps a host copy of every draw it hands out."""

    def __init__(self, inner):
        self.inner, self.draws = inner, {}

    def uniform(self, strategy, rep, name, shape, device):
        u = self.inner.uniform(strategy, rep, name, shape, device)
        self.draws[(strategy, rep, name)] = u.cpu()
        return u


class Replay:
    """A uniform source that hands out recorded draws."""

    def __init__(self, draws):
        self.draws = draws

    def uniform(self, strategy, rep, name, shape, device):
        u = self.draws[(strategy, rep, name)]
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"replay {strategy}/{name}: recorded "
                             f"{tuple(u.shape)}, asked {tuple(shape)}")
        return u.to(device)


def phase_replay(jobs, p, dev) -> None:
    rec = Recording(Philox(0))
    gpu, r_min_gpu = run_all(rec, jobs, p, theta=THETA, reps=1, device=dev)
    t0 = time.perf_counter()
    cpu, r_min_cpu = run_all(Replay(rec.draws), jobset_to(jobs, "cpu"), p,
                             theta=THETA, reps=1, device="cpu")
    cpu_s = time.perf_counter() - t0
    D = jobs.D.cpu()
    J = jobs.n_jobs
    n_ties = 0
    for name, g in gpu.items():
        c = cpu[name]
        if not torch.equal(g.r_opt.cpu(), c.r_opt):
            raise AssertionError(f"replay {name}: r* differs on the CPU")
        comp = g.result.job_completion.cpu()
        flips = g.result.job_met.cpu() != c.result.job_met
        ties = (comp - D).abs() <= 1e-5 * D
        if bool((flips & ~ties).any()):
            raise AssertionError(f"replay {name}: job_met differs away "
                                 f"from the deadline")
        n_flip = int(flips.sum())
        n_ties += n_flip
        pg, pc = float(g.result.pocd), float(c.result.pocd)
        cg, cc = float(g.result.mean_cost), float(c.result.mean_cost)
        if abs(pg - pc) > 1e-5 * abs(pc) + n_flip / J:
            raise AssertionError(f"replay {name}: pocd {pg} vs {pc}")
        if abs(cg - cc) > 1e-4 * abs(cc):
            raise AssertionError(f"replay {name}: mean_cost {cg} vs {cc}")
    print(f"cpu replay of run_all reps=1: {cpu_s:.2f} s; r_min card "
          f"{r_min_gpu:.9f} cpu {r_min_cpu:.9f}; r* equal for every "
          f"strategy; job_met flips at the deadline: {n_ties}")


def phase_profile(fn, label: str, wall_s: float) -> dict:
    """One torch.profiler pass over fn(): device busy time, the idle share
    over the unprofiled warm wall `wall_s`, the port's kernels' device
    time and the top device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in rows)
    n_ops = sum(e.count for e in rows)
    if busy_us <= 0:
        raise AssertionError("profiler recorded no device time")
    ours = {k: sum(e.device_time_total for e in rows if k in e.key) / 1e3
            for k in ("grid_solve", "pocd_mc", "flash_attention",
                      "dispatch_scan")}
    sort_ms = sum(e.device_time_total for e in rows
                  if "sort" in e.key.lower()) / 1e3
    # each dispatch_scan launch's device time, in launch order
    dispatch_ms = [e.time_range.elapsed_us() / 1e3 for e in sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA
         and "dispatch_scan" in e.name), key=lambda e: e.time_range.start)]
    idle = 1.0 - (busy_us / 1e3) / (wall_s * 1e3)
    print(f"profile {label}: device busy {busy_us / 1e3:.3f} ms in "
          f"{n_ops} device ops; unprofiled warm wall {wall_s * 1e3:.3f} ms; "
          f"device idle share {idle:.3f}; grid_solve kernel "
          f"{ours['grid_solve']:.3f} ms, pocd_mc kernels "
          f"{ours['pocd_mc']:.3f} ms, flash_attention kernels "
          f"{ours['flash_attention']:.3f} ms, dispatch_scan kernel "
          f"{ours['dispatch_scan']:.3f} ms, sorts {sort_ms:.3f} ms")
    for e in sorted(rows, key=lambda e: -e.device_time_total)[:8]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms "
              f"{100 * e.device_time_total / busy_us:5.1f}% x{e.count:<5d} "
              f"{e.key[:90]}")
    return dict(device_busy_ms=busy_us / 1e3, device_ops=n_ops,
                idle_share=idle, grid_solve_ms=ours["grid_solve"],
                pocd_mc_ms=ours["pocd_mc"],
                flash_attention_ms=ours["flash_attention"],
                dispatch_scan_ms=ours["dispatch_scan"],
                dispatch_scan_launches=sum(e.count for e in rows
                                           if "dispatch_scan" in e.key),
                dispatch_scan_each_ms=dispatch_ms, sort_ms=sort_ms)


class WorkloadRecording:
    """A workload source that keeps a host copy of every variate its inner
    source hands out."""

    def __init__(self, inner):
        self.inner, self.draws = inner, {}

    def __getattr__(self, law):
        def draw(name, *args):
            x = getattr(self.inner, law)(name, *args)
            self.draws[name] = x.cpu()
            return x
        return draw


class WorkloadReplay:
    """A workload source that hands out recorded variates: the arguments
    end in (shape, device), but categorical's in (logits, shape)."""

    def __init__(self, draws):
        self.draws = draws

    def __getattr__(self, law):
        def draw(name, *args):
            shape, device = ((args[1], args[0].device) if law == "categorical"
                             else args[-2:])
            x = self.draws[name]
            if tuple(x.shape) != tuple(shape):
                raise ValueError(f"replay {name}: recorded {tuple(x.shape)},"
                                 f" asked {tuple(shape)}")
            return x.to(device)
        return draw


def synthesize_scenario(name: str, dev, source=None):
    s = get_scenario(name)
    return synthesize(s.classes, s.n_jobs, seed=s.seed, arrival=s.arrival,
                      hours=s.hours, arrival_kw=s.arrival_kw, source=source,
                      device=dev)


def compare_traces(name: str, card_tr, cpu_tr) -> int:
    """The card's trace against the CPU's from the same variates: the same
    jobs (matched by their t_min and beta bits, which both devices form by
    the same IEEE operations), integer columns equal, float columns within
    WORKLOAD_RTOL, and each job at the same place in arrival order unless
    its arrival ties, within WORKLOAD_RTOL, with the job at its other
    place. Returns the number of jobs so moved."""
    import numpy as np
    key = lambda tr: (tr.t_min.view(np.uint32).astype(np.uint64) << 32
                      | tr.beta.view(np.uint32))
    kg, kc = key(card_tr), key(cpu_tr)
    if len(np.unique(kg)) != len(kg):
        raise AssertionError(f"workloads {name}: (t_min, beta) do not "
                             f"identify the jobs")
    ig, ic = np.argsort(kg), np.argsort(kc)
    if not np.array_equal(kg[ig], kc[ic]):
        raise AssertionError(f"workloads {name}: the card's jobs are not "
                             f"the CPU's")
    where = np.empty(len(kg), np.int64)
    where[ig] = ic                  # card row i is CPU row where[i]
    for col in ("n_tasks", "job_class"):
        a, b = getattr(card_tr, col), getattr(cpu_tr, col)[where]
        if not np.array_equal(a, b):
            raise AssertionError(f"workloads {name}: {col} differs in "
                                 f"{int((a != b).sum())} jobs")
    for col in ("t_min", "beta", "D", "arrival", "C", "theta_scale"):
        a, b = getattr(card_tr, col), getattr(cpu_tr, col)[where]
        if not np.allclose(a, b, rtol=WORKLOAD_RTOL, atol=0.0):
            raise AssertionError(f"workloads {name}: {col} outside rtol "
                                 f"{WORKLOAD_RTOL}")
    moved = np.nonzero(where != np.arange(len(kg)))[0]
    arr = card_tr.arrival.astype(np.float64)
    tied = np.abs(arr[moved] - arr[where[moved]]) <= WORKLOAD_RTOL * arr[moved]
    if not tied.all():
        raise AssertionError(f"workloads {name}: {int((~tied).sum())} jobs "
                             f"change place in arrival order away from a "
                             f"tie")
    return len(moved)


def phase_workloads(dev) -> dict:
    """Every registered scenario synthesized on the card at its default
    size (timed: first and warm), summarized, the same twice, and replayed
    on the CPU from the card's variates; paper-hadoop held against
    PAPER_TRACE_STATS."""
    out = {}
    for name in sorted(list_scenarios()):
        walls = []
        for _ in range(2):
            tr, wall = synced(lambda: make_trace(name, device=dev))
            walls.append(wall)
        rec = WorkloadRecording(WorkloadPhilox(get_scenario(name).seed))
        again = synthesize_scenario(name, dev, rec)
        for col in TRACE_COLUMNS:
            if not (getattr(tr, col) == getattr(again, col)).all():
                raise AssertionError(f"workloads {name}: {col} differs "
                                     f"between two syntheses on the card")
        t0 = time.perf_counter()
        cpu = synthesize_scenario(name, "cpu", WorkloadReplay(rec.draws))
        cpu_s = time.perf_counter() - t0
        moved = compare_traces(name, tr, cpu)
        stats = summarize(tr)
        out[name] = dict(n_jobs=tr.n_jobs, total_tasks=tr.total_tasks,
                         first_ms=1e3 * walls[0], warm_ms=1e3 * walls[1],
                         cpu_replay_s=cpu_s, moved_at_ties=moved,
                         summary=stats)
        print(f"workloads {name}: {tr.n_jobs} jobs, {tr.total_tasks} tasks; "
              f"synthesize on the card first {1e3 * walls[0]:.2f} ms, warm "
              f"{1e3 * walls[1]:.2f} ms; equal twice; CPU replay of its "
              f"variates equal (jobs moved at arrival ties: {moved}); "
              f"summary {json.dumps(stats)}")
    s = out["paper-hadoop"]["summary"]
    lo, hi = PAPER_TRACE_STATS["beta_range"]
    if not (abs(s["mean_tasks"] / PAPER_TRACE_STATS["mean_tasks"] - 1) <= 0.25
            and abs(s["hours"] / PAPER_TRACE_STATS["hours"] - 1) <= 0.25
            and lo <= s["beta_range"][0] and s["beta_range"][1] <= hi):
        raise AssertionError(f"workloads paper-hadoop: {s} outside "
                             f"PAPER_TRACE_STATS' calibration bounds")
    print("workloads paper-hadoop: within PAPER_TRACE_STATS (mean tasks and "
          "hours within 25%, beta inside [1.1, 2.0])")
    return out


def phase_scenario_kernel(dev, p: SimParams) -> dict:
    """Kernel #1 against its plain version on every scenario's inputs
    (theta 1e-4, r_max 9), every optimized strategy; timed per scenario
    (the six launches of one run_all) and per strategy at request-storm's
    J."""
    out = {"max_abs_err": 0.0, "per_scenario": {}, "request_storm": {}}
    for name in sorted(list_scenarios()):
        job = jobspecs_of(make_jobset(name, device=dev), p, THETA,
                          CHECK_R_MIN)
        J = int(job.t_min.shape[0])
        rows = {}
        for s in names("optimized"):
            errs = check_grid(get(s), job, 9, f"{name} J={J}")
            out["max_abs_err"] = max(out["max_abs_err"], *errs)
            rows[s] = grid_times(get(s), job, 9)
        out["per_scenario"][name] = dict(
            J=J, ms=sum(r["ms"] for r in rows.values()),
            plain_ms=sum(r["plain_ms"] for r in rows.values()),
            bound_ms=bound_of(sum(r["bytes_ms"] for r in rows.values()),
                              sum(r["ops_ms"] for r in rows.values()))[0])
        if name == "request-storm":
            out["request_storm"] = rows
        x = out["per_scenario"][name]
        print(f"grid_solve on {name} (J={J}, r_max 9): r*/choice/sat equal "
              f"for every strategy; six launches {x['ms']:.4f} ms, plain "
              f"{x['plain_ms']:.3f} ms, bound {x['bound_ms']:.6f} ms")
    for s, r in out["request_storm"].items():
        print(f"  request-storm {s:10s} kernel {r['ms']:.4f} ms (call "
              f"{r['call_ms']:.4f}), plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.6f} ms")
    return out


def phase_scenario_runs(dev, p: SimParams) -> dict:
    """run_all by scenario name, twice each: 6 grid-solve launches a run,
    the same job_cost and job_met bits; class_summary of
    multi-tenant-sla."""
    out = {}
    want = len(names("optimized"))
    for name in sorted(list_scenarios()):
        runs, counts = [], []
        for _ in range(2):
            gs.launches = 0
            (outs, r_min), wall = synced(lambda: run_all(
                Philox(0), name, p, theta=THETA, reps=1, device=dev))
            counts.append(gs.launches)
            if counts[-1] != want:
                raise AssertionError(f"run_all {name} launched the grid "
                                     f"solve {counts[-1]} times, expected "
                                     f"{want}")
            runs.append((outs, r_min, wall))
        quietly(check_deterministic, runs[0][0], runs[1][0], 1)
        out[name] = dict(r_min=runs[0][1], first_s=runs[0][2],
                         second_s=runs[1][2], launches=counts, pocd={
                             k: float(o.result.pocd)
                             for k, o in runs[1][0].items()})
        print(f"run_all {name!r}: grid-solve launches {counts} in two "
              f"runs, job_cost and job_met bit-equal; r_min {runs[0][1]:.6f};"
              f" wall first {runs[0][2]:.4f} s, second {runs[1][2]:.4f} s")
        if name == "multi-tenant-sla":
            jobs = make_jobset(name, device=dev)
            cls = jobs.job_class
            tiers = get_scenario(name).classes
            for s in names("optimized"):
                o = runs[1][0][s]
                summ = class_summary(jobs, o.result)
                print(f"  class_summary {s:10s} " + "; ".join(
                    f"{tiers[c].name}: n {v['n_jobs']} pocd {v['pocd']:.4f} "
                    f"cost {v['mean_cost']:.1f} mean r* "
                    f"{float(o.r_opt[cls == c].float().mean()):.3f}"
                    for c, v in summ.items()))
    return out


def band(specs, strategy="clone"):
    """(U, E, priced cost, min spend, independent spend) of a strategy's
    grids: the feasible-binding budget band is [min, independent]."""
    U, E = utility_cost_grids(get(strategy), specs, 9)
    cost = E * specs.C[:, None]
    free = torch.gather(cost, 1, torch.argmax(U, dim=1, keepdim=True))
    return U, E, cost, float(cost.amin(dim=1).sum()), float(free.sum())


def spend_of(cost, i) -> float:
    return float(torch.gather(cost, 1, i[:, None].long()).sum())


def device_ops(fn) -> tuple:
    """(device busy ms, device launches) of one call of fn()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return (sum(e.device_time_total for e in rows) / 1e3,
            sum(e.count for e in rows))


def acceptance(specs, B: float, label: str) -> dict:
    """The reference's acceptance property at B: clone's dual selection
    has total utility >= the repaired independent selection's and > both
    competitive policies', each within B, all on clone's grids."""
    U, E, cost, _, _ = band(specs)
    dev = specs.t_min.device
    (i_dual, *_), info = solve_jobs_coupled("clone", specs, 9, B, device=dev)
    picks = {"dual": i_dual,
             "repair": repair_independent(U, E, specs.C, B)}
    for s in ("clone_prop", "clone_sjf"):
        picks[s] = solve_jobs_coupled(s, specs, 9, B, device=dev)[0][0]
    tot = {k: total_utility(U, i) for k, i in picks.items()}
    spend = {k: spend_of(cost, i) for k, i in picks.items()}
    over = [k for k, v in spend.items() if v > B]
    if over:
        raise AssertionError(f"acceptance {label}: {over} spend over B "
                             f"{B}: {spend}")
    if not (tot["dual"] >= tot["repair"] and tot["dual"] > tot["clone_prop"]
            and tot["dual"] > tot["clone_sjf"]):
        raise AssertionError(f"acceptance {label}: total utility {tot}")
    print(f"acceptance ({label}, B {B:.1f}): total utility " + ", ".join(
        f"{k} {tot[k]:.4f} (spend {spend[k]:.1f})" for k in tot)
        + "; dual >= repair and > both competitive policies")
    return dict(budget=B, total_utility=tot, spend=spend,
                lam=float(info.lam))


def phase_budget(dev, p: SimParams) -> dict:
    """The budgeted path at the paper's scale: multi-tenant-sla at 2700
    jobs, B the midpoint of clone's band from the port's grids; the
    slack identity at 1e12; the infeasible warning; the solve's times."""
    jobs = make_jobset("multi-tenant-sla", n_jobs=BUDGET_JOBS, device=dev)
    gs.launches = 0
    free, r_min = run_all(Philox(0), jobs, p, theta=THETA, device=dev)
    if gs.launches != len(names("optimized")):
        raise AssertionError(f"unbudgeted run_all: {gs.launches} launches")
    specs = jobspecs_of(jobs, p, THETA, r_min)
    U, E, cost, lo, hi = band(specs)
    B = 0.5 * (lo + hi)
    print(f"budget: multi-tenant-sla, {jobs.n_jobs} jobs, {jobs.total_tasks} "
          f"tasks, r_min {r_min:.6f}; clone's band [{lo:.1f}, {hi:.1f}], "
          f"B = {B:.1f}")
    gs.launches = 0
    (outs, r_min_b), wall = synced(lambda: run_all(
        Philox(0), jobs, p, theta=THETA, budget=B, device=dev))
    launches_b = gs.launches
    if launches_b != 0 or r_min_b != r_min:
        raise AssertionError(f"budgeted run_all: {launches_b} grid-solve "
                             f"launches (expected 0), r_min {r_min_b}")
    info = {}
    for s in names("optimized"):
        c = outs[s].coupled
        info[s] = {f: (bool(getattr(c, f)) if f in ("feasible", "binding")
                       else float(getattr(c, f))) for f in c._fields}
        if info[s]["feasible"] and not info[s]["spend"] <= B:
            raise AssertionError(f"budget {s}: feasible but spends "
                                 f"{info[s]['spend']} > B {B}")
        print(f"  {s:10s} lam {info[s]['lam']:.9g} spend "
              f"{info[s]['spend']:.1f} spend_free {info[s]['spend_free']:.1f}"
              f" feasible {info[s]['feasible']} binding "
              f"{info[s]['binding']}")
    if not (info["clone"]["feasible"] and info["clone"]["binding"]):
        raise AssertionError("budget clone: B inside clone's band must be "
                             "feasible and binding")
    accept = {"run": acceptance(specs, B, f"run_all's R_min {r_min:.6f}")}
    specs0 = jobspecs_of(jobs, p, THETA, 0.0)
    _, _, _, lo0, hi0 = band(specs0)
    accept["r_min_0"] = acceptance(specs0, 0.5 * (lo0 + hi0),
                                   "R_min 0, the reference test's")

    # a slack budget: the kernel's r* (unbudgeted) against the plain grids'
    # argmax (budgeted); a differing job must be a near-tie of its U row
    slack, _ = run_all(Philox(0), jobs, p, theta=THETA, budget=1e12,
                       device=dev)
    ties = {}
    for s in names("optimized"):
        a, b = free[s], slack[s]
        if float(b.coupled.lam) != 0.0 or bool(b.coupled.binding):
            raise AssertionError(f"slack {s}: lam {float(b.coupled.lam)}, "
                                 f"binding {bool(b.coupled.binding)}")
        if s in SLACK_EXEMPT:
            continue
        diff = torch.nonzero(a.r_opt != b.r_opt)[:, 0]
        if len(diff):
            Us = utility_cost_grids(get(s), specs, 9)[0][diff]
            ua = torch.gather(Us, 1, a.r_opt[diff, None].long())[:, 0]
            ub = torch.gather(Us, 1, b.r_opt[diff, None].long())[:, 0]
            rtol, atol = TOL["u"]
            if not bool(torch.isclose(ua, ub, rtol=rtol, atol=atol).all()):
                raise AssertionError(f"slack {s}: r* differs from the "
                                     f"kernel's away from a near-tie")
        elif not (torch.equal(a.result.job_met, b.result.job_met)
                  and torch.equal(a.result.job_cost, b.result.job_cost)):
            raise AssertionError(f"slack {s}: equal r* but job_met / "
                                 f"job_cost bits differ")
        ties[s] = len(diff)
    print(f"slack budget 1e12: lam 0, not binding; r* of the plain grids "
          f"against the kernel's, near-ties within the U tolerance: {ties}"
          f" (clone_prop fills each job's budget share by design and is "
          f"not held to the identity); bit-equal job_met / job_cost where "
          f"no tie")

    # infeasible: half the minimum spend
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        o = run_strategy(Philox(0), jobs, "clone", p, theta=THETA,
                         r_min=r_min, budget=0.5 * lo, device=dev)
    if not any(w.category is RuntimeWarning and "no selection meets" in
               str(w.message) for w in caught) or bool(o.coupled.feasible):
        raise AssertionError("infeasible budget: no RuntimeWarning")
    cheapest = torch.where(torch.isfinite(U), cost, torch.inf).amin(dim=1)
    got = torch.gather(cost, 1, o.r_opt[:, None].long())[:, 0]
    if not torch.equal(got, cheapest):
        raise AssertionError("infeasible budget: not the minimum-cost "
                             "selection")
    print(f"infeasible budget {0.5 * lo:.1f}: RuntimeWarning raised; the "
          f"cheapest level with finite U for every job, spend "
          f"{float(o.coupled.spend):.1f} (sum of row minima {lo:.1f})")

    # between the sum of row minima and the cheapest selection with finite
    # U: levels with U = -inf (PoCD below R_min) never win the priced
    # argmax, so either a selection within B or an infeasible warning
    lo_finite = float(cheapest.sum())
    if not lo < lo_finite:
        raise AssertionError(f"no window at R_min {r_min}: row minima "
                             f"{lo} >= finite minima {lo_finite}")
    Bw = 0.5 * (lo + lo_finite)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        o = run_strategy(Philox(0), jobs, "clone", p, theta=THETA,
                         r_min=r_min, budget=Bw, device=dev)
    warned = any(w.category is RuntimeWarning and "no selection meets" in
                 str(w.message) for w in caught)
    feas, spend_w = bool(o.coupled.feasible), float(o.coupled.spend)
    if not ((feas and spend_w <= Bw and not warned)
            or (not feas and warned)):
        raise AssertionError(f"window budget {Bw}: feasible {feas}, spend "
                             f"{spend_w}, warned {warned}")
    print(f"window budget {Bw:.1f} in [{lo:.1f}, {lo_finite:.1f}): feasible"
          f" {feas}, spend {spend_w:.1f}, RuntimeWarning {warned}")

    solve_t = {}
    for s in names("optimized"):
        fn = lambda: solve_jobs_coupled(s, specs, 9, B, device=dev)
        busy, ops = device_ops(fn)
        solve_t[s] = dict(call_ms=cuda_ms(fn, 5), device_ms=busy,
                          launches=ops)
    print("budgeted solve (grids + dual loop) per strategy: " + ", ".join(
        f"{s} {t['call_ms']:.3f} ms ({t['launches']} device launches, "
        f"{t['device_ms']:.3f} ms busy)" for s, t in solve_t.items()))
    return dict(n_jobs=jobs.n_jobs, total_tasks=jobs.total_tasks,
                r_min=r_min, band=[lo, hi], budget=B, info=info,
                run_all_s=wall, launches_run_all=launches_b,
                window=dict(budget=Bw, finite_min=lo_finite, feasible=feas,
                            spend=spend_w, warned=warned), acceptance=accept, slack_near_ties=ties,
                solve=solve_t)


def phase_spans(dev, p: SimParams) -> dict:
    """One traced, budgeted run_all by scenario name (multi-tenant-sla at
    its default size, B the midpoint of clone's band there): the spans of
    every stage, coverage, the Chrome trace, and the traced wall beside
    the untraced one."""
    name = "multi-tenant-sla"
    jobs = make_jobset(name, device=dev)
    _, r_min = run_all(Philox(0), jobs, p, theta=THETA,
                       strategies=("hadoop_ns",), device=dev)
    _, _, _, lo, hi = band(jobspecs_of(jobs, p, THETA, r_min))
    B = 0.5 * (lo + hi)
    run = lambda: run_all(Philox(0), name, p, theta=THETA, budget=B,
                          device=dev)
    untraced = [synced(run)[1] for _ in range(2)][1]
    obs.enable()
    traced = synced(run)[1]
    obs.disable()
    seen = {sp.name for sp in obs.get_tracer().closed_spans()}
    want = {"workloads.synthesize", "workloads.jobset_build"}
    for s in names():
        want |= {f"sim.run[{s}]", f"sim.run[{s}].wait"}
    if not want <= seen:
        raise AssertionError(f"spans missing: {sorted(want - seen)}")
    cov = obs.coverage()
    rows = obs.stage_breakdown()
    path = obs.write_chrome_trace(ROOT / "chiprun_out" / "spans.json")
    print(f"spans: traced run_all({name!r}, budget={B:.1f}) wall "
          f"{1e3 * traced:.2f} ms, untraced {1e3 * untraced:.2f} ms; "
          f"{len(seen)} span names, coverage {cov:.4f}; Chrome trace "
          f"{path.relative_to(ROOT)}")
    print(obs.summary(top=12))
    return dict(budget=B, traced_ms=1e3 * traced,
                untraced_ms=1e3 * untraced, coverage=cov,
                top=dict(sorted(rows.items(),
                                key=lambda kv: -kv[1]["self_ms"])[:12]))


def dispatch_inputs(n: int = 3000, seed: int = 0):
    """tests/test_torch_cluster.py's recursion inputs: releases and holds
    on coarse grids (ties in release and in the times slots come free),
    deadlines with ties, 20% inactive units; numpy f32 / bool."""
    rng = np.random.default_rng(seed)
    release = (rng.integers(0, n // 6, n) * 0.5).astype(np.float32)
    hold = (1.0 + rng.integers(0, 12, n) * 0.25).astype(np.float32)
    deadline = (release + rng.integers(1, 8, n) * 2.0).astype(np.float32)
    return release, hold, deadline, rng.random(n) >= 0.2


def sorted_case(discipline: str, seed: int = 0):
    """(release, hold, count) of dispatch_inputs in dispatch order, on the
    CPU."""
    t = torch.from_numpy
    release, hold, deadline, active = dispatch_inputs(seed=seed)
    order = dispatch_key_order(discipline, t(release), t(deadline),
                               inactive=~t(active))
    return (t(release)[order], t(hold)[order],
            t(active).sum(dtype=torch.int32))


def kernel_vs_plain(rel, hold, count, slots: int, dev, rows=None) -> float:
    """The kernel on the card against the plain version on the CPU: starts
    and final pool bit-equal; with `rows`, the kernel runs on the whole
    arrays and only their first `rows` starts are compared (the recursion
    is causal: the first n starts depend on the first n rows alone).
    Returns the largest |difference| of the starts compared (0 when it
    passes)."""
    free = torch.zeros(slots, device=dev)
    got = ds.dispatch_scan_cuda(rel.to(dev), hold.to(dev), count.to(dev),
                                free)
    n = rel.shape[0] if rows is None else min(rows, rel.shape[0])
    free_p = torch.zeros(slots)
    want = ds.dispatch_scan_plain(rel[:n].cpu(), hold[:n].cpu(),
                                  count.cpu().clamp(max=n), free_p)
    torch.cuda.synchronize()
    if not torch.equal(got[:n].cpu(), want):
        bad = int((got[:n].cpu() != want).sum())
        raise AssertionError(f"dispatch_scan K={slots}: {bad} of {n} starts "
                             f"differ from the plain version")
    if rows is None and not torch.equal(free.cpu(), free_p):
        raise AssertionError(f"dispatch_scan K={slots}: final pool differs")
    return float((got[:n].cpu() - want).abs().max())


def pass_inputs(table, race, jobs, slots: int):
    """Both passes' dispatch-ordered (release, hold, count), built with the
    engine's own functions; pass 1's starts come from masked_dispatch."""
    T = jobs.total_tasks
    hold = predicted_holds(table, race, T)
    arrival_u = jobs.arrival[table.job_id]
    deadline_u = (jobs.arrival + jobs.D)[table.job_id]
    act_prim = primary_slice(table.active & table.is_primary, T)
    p1 = (primary_slice(arrival_u, T), primary_slice(hold, T), act_prim,
          primary_slice(deadline_u, T))
    o1 = dispatch_key_order("fifo", p1[0], p1[3], inactive=~act_prim)
    release = combined_release(table, arrival_u, act_prim,
                               masked_dispatch(slots, "fifo", *p1))
    o2 = dispatch_key_order("fifo", release, deadline_u,
                            inactive=~table.active)
    return ((p1[0][o1], p1[1][o1], act_prim.sum(dtype=torch.int32)),
            (release[o2], hold[o2], table.active.sum(dtype=torch.int32)))


def max_in_service(start, hold, active) -> int:
    """The most units holding a slot at once: events (start, +1) and
    (start + hold, -1), a release before a start at one time (a slot freed
    at t is taken at t), summed as integers."""
    st = start[active]
    times = torch.cat([st, st + hold[active]])
    delta = torch.cat([torch.ones_like(st, dtype=torch.int32),
                       -torch.ones_like(st, dtype=torch.int32)])
    o = torch.sort(delta, stable=True).indices
    o = o[torch.sort(times[o], stable=True).indices]
    return int(torch.cumsum(delta[o], 0).max())


def cluster_run(dev, jobs, p, traced: bool = False, **kw):
    """One run_cluster on the card: (outs, r_min, wall s, (grid-solve,
    dispatch) launches, {strategy: span ms}); the counts are set to 0
    just before and read just after."""
    gs.launches = ds.launches = 0
    if traced:
        obs.enable()
    (outs, r_min), wall = synced(lambda: run_cluster(
        Philox(0), jobs, p, theta=THETA, device=dev, **kw))
    spans = {}
    if traced:
        obs.disable()
        for sp in obs.get_tracer().closed_spans():
            for s in outs:
                if sp.name in (f"cluster.replay[{s}]",
                               f"cluster.replay[{s}].wait"):
                    spans[s] = spans.get(s, 0.0) + sp.duration_ns / 1e6
                elif sp.name == "cluster.solve" and \
                        sp.attrs.get("strategy") == s:
                    spans[s] = spans.get(s, 0.0) + sp.duration_ns / 1e6
    return outs, r_min, wall, (gs.launches, ds.launches), spans


def queue_line(o) -> str:
    return (f"pocd {float(o.result.pocd):.4f} util "
            f"{float(o.queue.utilization):.4f} mean wait "
            f"{float(o.queue.mean_wait):.2f} s")


def phase_cluster(dev, p: SimParams, budget_B: float):
    """The capacity replay on the card (phase 10b): (its JSON, the state
    `cluster_times` needs)."""
    out = {}
    # 1. the kernel against the plain version on the test cases
    t0 = time.perf_counter()
    err = max(kernel_vs_plain(*sorted_case(disc), K, dev)
              for K in DISPATCH_KS for disc in DISCIPLINES)
    print(f"dispatch_scan: bit-equal to the plain version (starts and final"
          f" pool) at K = {DISPATCH_KS}, FIFO and EDF; the pool in shared "
          f"memory at K = " + ", ".join(
              f"{K}: {ds.pool_in_shared_memory(K)}" for K in DISPATCH_KS)
          + f" ({time.perf_counter() - t0:.1f} s)")
    uni = uniform_jobset(150, 10, t_min=10.0, beta=2.0, D=50.0, device=dev)
    for s in ("sresume", "hadoop_s"):
        table, race = build_strategy_table(Philox(0), uni, s, p, theta=1e-3,
                                           device=dev)
        _, rel, st = replay(table, race, uni, 20_000, device=dev)
        o = run_cluster_strategy(Philox(0), uni, s, p, slots=20_000,
                                 theta=1e-3, device=dev)
        if not (torch.equal(st[table.active], rel[table.active])
                and float(o.queue.mean_wait) == 0.0):
            raise AssertionError(f"uniform 150x10 at K=20,000, {s}: a unit "
                                 f"waited")
    print("uniform 150x10 trace at K = 20,000: starts equal releases, mean "
          "wait 0 (sresume, hadoop_s)")

    # 2. the main path, twice
    jobs = generate(2700, seed=0, device=dev)
    rho = offered_load(jobs, CLUSTER_SLOTS, 3600.0)
    out["offered_load"] = dict(mean=float(rho.mean()),
                               p95=float(np.quantile(rho, 0.95)),
                               max=float(rho.max()))
    print(f"offered primary load at {CLUSTER_SLOTS} slots over 3600 s "
          f"windows: " + ", ".join(f"{k} {v:.4f}"
                                   for k, v in out["offered_load"].items()))
    runs = [cluster_run(dev, jobs, p, traced=True, slots=CLUSTER_SLOTS)
            for _ in range(2)]
    (outs, r_min, _, launches, _), second = runs[0], runs[1][0]
    for k, run in enumerate(runs):
        if run[3] != (len(names("optimized")), 2 * len(names())):
            raise AssertionError(f"run_cluster {k + 1}: (grid-solve, "
                                 f"dispatch) launches {run[3]}, expected "
                                 f"(6, 20)")
    for name, o in outs.items():
        y = second[name].result
        if not (torch.equal(o.result.job_cost, y.job_cost)
                and torch.equal(o.result.job_met, y.job_met)):
            raise AssertionError(f"run_cluster {name}: job_cost or job_met "
                                 f"differs between two runs")
    print(f"run_cluster(Philox(0), generate(2700), slots={CLUSTER_SLOTS}): "
          f"r_min {r_min:.6f}; walls {runs[0][2]:.3f} s, {runs[1][2]:.3f} s;"
          f" launches (grid-solve, dispatch) {runs[0][3]}, {runs[1][3]}; "
          f"job_cost and job_met bit-equal over the two runs")
    for name, o in outs.items():
        ref = REF_AT_500[name]
        print(f"  {name:10s} {queue_line(o)} (the JAX package, its own "
              f"draws: pocd {ref[0]}, util {ref[1]}, wait {ref[2]} s); "
              f"run_cluster_strategy first {runs[0][4][name]:.1f} ms, warm "
              f"{runs[1][4][name]:.1f} ms")
    out["main"] = dict(
        r_min=r_min, wall_s=[r[2] for r in runs], launches=list(launches),
        strategy_ms={"first": runs[0][4], "warm": runs[1][4]},
        per_strategy={n: dict(pocd=float(o.result.pocd),
                              utilization=float(o.queue.utilization),
                              mean_wait=float(o.queue.mean_wait),
                              max_wait=float(o.queue.max_wait),
                              preempted=float(o.queue.preempted),
                              mean_cost=float(o.result.mean_cost),
                              sum_r=int(o.r_opt.sum()))
                      for n, o in outs.items()})

    # 3-4. every strategy's full replay: invariants, the same bits as the
    # main path (the table not narrowed), the steps; the prefix check
    T = jobs.total_tasks
    steps, rows, prefix = {}, {}, {}
    for s in names():
        table, race = build_strategy_table(
            Philox(0), jobs, s, p, theta=THETA,
            r_min=0.0 if s == "hadoop_ns" else r_min, device=dev)
        realized, rel, st = replay(table, race, jobs, CLUSTER_SLOTS,
                                   device=dev)
        act = table.active
        res = aggregate(jobs, realized.task_completion
                        - jobs.arrival[jobs.job_id], realized.task_machine)
        if not (torch.equal(res.job_cost, outs[s].result.job_cost)
                and torch.equal(res.job_met, outs[s].result.job_met)):
            raise AssertionError(f"replay {s}: the full-width table gives "
                                 f"other bits than the main path")
        if bool((st[act] < rel[act]).any()):
            raise AssertionError(f"replay {s}: a unit starts before its "
                                 f"release")
        busy = max_in_service(st, predicted_holds(table, race, T), act)
        util = float(realized.busy_time / (CLUSTER_SLOTS * realized.span))
        if busy > CLUSTER_SLOTS or not 0.0 <= util <= 1.0 + 1e-6:
            raise AssertionError(f"replay {s}: {busy} units in service at "
                                 f"once, utilization {util}")
        width = act.shape[0] // T
        if get(s).optimized:
            width = min(width, int(outs[s].r_opt.max()) + 2)
        n_prim = int(primary_slice(act & table.is_primary, T).sum())
        steps[s] = [n_prim, int(act.sum())]
        rows[s] = [T, T * width]
        print(f"  replay {s:10s}: start >= release, at most {busy} of "
              f"{CLUSTER_SLOTS} slots held, util {util:.4f}; steps "
              f"{steps[s]} over rows {rows[s]}; the main path's bits")
        if s in ("clone", "hadoop_s"):
            both = pass_inputs(table, race, jobs, CLUSTER_SLOTS)
            err = max(err, *(kernel_vs_plain(*args, CLUSTER_SLOTS, dev,
                                             rows=PREFIX_ROWS)
                             for args in both))
            prefix[s] = PREFIX_ROWS
            print(f"  {s}: the kernel's starts on both passes' full arrays "
                  f"equal the plain version's on the CPU over the first "
                  f"{PREFIX_ROWS} rows")
            if s == "clone":
                big = both[1]
        del table, realized, rel, st
    out.update(steps=steps, rows=rows, prefix_rows=prefix, max_abs_err=err)

    # 5. slots=None on the paper trace against run_all
    flat, r_flat = run_all(Philox(0), jobs, p, theta=THETA, device=dev)
    inf, r_inf, _, (_, n_ds), _ = cluster_run(dev, jobs, p, slots=None)
    D = jobs.D.cpu()
    # the replay computes completions on the trace's clock, arrival +
    # offset + dur in f32, less the arrival; at the last arrivals (1.08e5
    # s) that clock's spacing is 2^-7 s, so a completion moves by up to
    # about two spacings of arrival + D against run_all's: a deadline tie
    # is a completion within rtol 1e-5 of D or within two such spacings
    due = (jobs.arrival + jobs.D).cpu()
    clock = 2.0 * (torch.nextafter(due, torch.tensor(torch.inf)) - due)
    n_ties = 0
    for s, f in flat.items():
        c = inf[s]
        if not torch.equal(c.r_opt, f.r_opt):
            raise AssertionError(f"slots=None {s}: r* differs from run_all")
        flips = (c.result.job_met != f.result.job_met).cpu()
        ties = (f.result.job_completion.cpu() - D).abs() <= 1e-5 * D + clock
        if bool((flips & ~ties).any()):
            raise AssertionError(f"slots=None {s}: job_met differs away "
                                 f"from the deadline")
        n_ties += int(flips.sum())
        dp = abs(float(c.result.pocd) - float(f.result.pocd))
        dc = abs(float(c.result.mean_cost) - float(f.result.mean_cost))
        if dp > 1e-6 + int(flips.sum()) / jobs.n_jobs or \
                dc > 1e-4 * abs(float(f.result.mean_cost)):
            raise AssertionError(f"slots=None {s}: pocd or mean_cost")
    if n_ds != 0 or r_inf != r_flat:
        raise AssertionError(f"slots=None: {n_ds} dispatch launches, r_min "
                             f"{r_inf} vs {r_flat}")
    print(f"slots=None equals run_all on the card: r* equal, {n_ties} "
          f"job_met flips, all at deadline ties (rtol 1e-5 or two clock "
          f"spacings), 0 dispatch launches")
    out["slots_none"] = dict(deadline_tie_flips=n_ties)

    # 6. printed runs
    adm = admit_jobs(jobs, CLUSTER_SLOTS, AdmissionConfig(slack=1.0))
    ds.launches = 0
    o, wall = synced(lambda: run_cluster_strategy(
        Philox(0), jobs, "sresume", p, slots=CLUSTER_SLOTS, theta=THETA,
        r_min=r_min, discipline="edf", passes=3, governor=GovernorConfig(),
        admitted=adm, device=dev))
    print(f"sresume EDF, passes=3, governor, admission slack 1.0: admitted "
          f"{float(o.queue.admitted_frac):.4f}, mean r* "
          f"{float(o.r_opt.float().mean()):.3f} (FIFO run "
          f"{float(outs['sresume'].r_opt.float().mean()):.3f}); "
          f"{queue_line(o)}; {ds.launches} dispatch launches, "
          f"{1e3 * wall:.1f} ms")
    out["edf_governed"] = dict(admitted=float(o.queue.admitted_frac),
                               mean_r=float(o.r_opt.float().mean()),
                               pocd=float(o.result.pocd),
                               utilization=float(o.queue.utilization),
                               mean_wait=float(o.queue.mean_wait))
    out["sweep"] = {}
    for s in ("sresume", "hadoop_s"):
        for slots in CLUSTER_SWEEP:
            o = run_cluster_strategy(Philox(0), jobs, s, p, slots=slots,
                                     theta=THETA, r_min=r_min, device=dev)
            out["sweep"][f"{s}@{slots}"] = [float(o.result.pocd),
                                            float(o.queue.mean_wait),
                                            float(o.queue.utilization)]
            print(f"  {s:8s} slots {str(slots):>5s}: {queue_line(o)}")
    mts = make_jobset("multi-tenant-sla", n_jobs=BUDGET_JOBS, device=dev)
    bud, _, wall, (n_gs, n_ds), _ = cluster_run(
        dev, mts, p, slots=CLUSTER_SLOTS, budget=budget_B)
    out["budget"] = {}
    for s, o in bud.items():
        c = o.coupled
        spend = None if c is None else float(c.spend)
        if c is not None and bool(c.feasible) and spend > budget_B:
            raise AssertionError(f"budget {s}: spend {spend} > B {budget_B}")
        out["budget"][s] = dict(spend=spend, pocd=float(o.result.pocd),
                                utilization=float(o.queue.utilization),
                                mean_wait=float(o.queue.mean_wait))
    print(f"budget B {budget_B:.1f} at {CLUSTER_SLOTS} slots on "
          f"multi-tenant-sla ({mts.n_jobs} jobs): {1e3 * wall:.1f} ms, "
          f"{n_gs} grid-solve and {n_ds} dispatch launches; spend <= B "
          f"wherever feasible: " + ", ".join(
              f"{s} {v['spend']:.0f}" for s, v in out["budget"].items()
              if v["spend"] is not None))

    # 7. the times come last in the script (cluster_times): a profiler
    # session this large can cost the next session its first records
    n_steps = sum(sum(v) for v in steps.values())
    return out, dict(jobs=jobs, warm_wall_s=runs[1][2], big=big,
                     n_steps=n_steps, steps=steps,
                     n_rows=sum(sum(v) for v in rows.values()))


def cluster_times(dev, p: SimParams, state: dict) -> dict:
    """The dispatch kernel's times (phase 10b, run at the end): one
    profiled warm run_cluster (busy, idle share, top ops; the kernel's
    device time per run and per step, the sorts'), taken again up to
    three times until it records all 20 dispatch launches (else the mean
    over those it recorded, if at least half, times 20); the wrapper's
    call on clone's pass 2 and the small case's kernel and plain times
    (CUDA events)."""
    jobs, n_steps, n_rows = state["jobs"], state["n_steps"], state["n_rows"]
    want = 2 * len(names())
    seen = []
    for _ in range(3):
        prof = phase_profile(lambda: run_cluster(
            Philox(0), jobs, p, slots=CLUSTER_SLOTS, theta=THETA,
            device=dev), f"run_cluster slots={CLUSTER_SLOTS}",
            state["warm_wall_s"])
        seen.append(prof["dispatch_scan_launches"])
        if seen[-1] == want:
            break
    got = seen[-1]
    if 2 * got < want or got > want:
        raise AssertionError(f"profiler saw {seen} dispatch_scan launches, "
                             f"expected {want}")
    kernel_ms = prof["dispatch_scan_ms"] * want / got
    per_pass = {}
    if got == want:     # launches in run order: two passes a strategy
        each = prof["dispatch_scan_each_ms"]
        for k, s in enumerate(names()):
            per_pass[s] = [dict(ms=each[2 * k + i],
                                steps=state["steps"][s][i],
                                ns_per_step=1e6 * each[2 * k + i]
                                / state["steps"][s][i]) for i in (0, 1)]
            print(f"  dispatch_scan {s:10s}: " + "; ".join(
                f"pass {i + 1} {v['ms']:.2f} ms over {v['steps']} steps "
                f"({v['ns_per_step']:.1f} ns a step)"
                for i, v in enumerate(per_pass[s])))
    bytes_ms = 1e3 * (12 * n_steps + 8 * (n_rows - n_steps)) \
        / HBM_BYTES_PER_S
    rel, hold, count = state["big"]
    call_ms = cuda_ms(lambda: ds.dispatch_scan_cuda(
        rel, hold, count, torch.zeros(CLUSTER_SLOTS, device=dev)), 2)
    small = [x.to(dev) for x in sorted_case("fifo")]
    small_ms = cuda_ms(lambda: ds.dispatch_scan_cuda(
        *small, torch.zeros(CLUSTER_SLOTS, device=dev)), 20)
    t0 = time.perf_counter()
    for _ in range(3):
        ds.dispatch_scan_plain(*small, torch.zeros(CLUSTER_SLOTS,
                                                   device=dev))
    plain_ms = 1e3 * (time.perf_counter() - t0) / 3
    times = dict(
        kernel_ms_per_run=kernel_ms, launches_recorded=seen,
        per_pass=per_pass,
        kernel_ms_per_launch=kernel_ms / want,
        ns_per_step=1e6 * kernel_ms / n_steps,
        steps_per_run=n_steps, rows_per_run=n_rows,
        sort_ms_per_run=prof["sort_ms"], bytes_ms=bytes_ms,
        call_ms_clone_pass2=call_ms, clone_pass2_steps=int(count),
        small_case=dict(rows=int(small[0].shape[0]),
                        steps=int(small[2]), slots=CLUSTER_SLOTS,
                        kernel_ms=small_ms, plain_ms=plain_ms),
        profile=prof)
    print(f"dispatch_scan: {kernel_ms:.2f} ms of device time per "
          f"run_cluster in {want} launches (recorded {seen}) over {n_steps} "
          f"steps ({times['ns_per_step']:.1f} ns a step); sorts "
          f"{prof['sort_ms']:.2f} ms; bound {bytes_ms:.5f} ms (bytes); "
          f"wrapper call on clone's pass 2 ({int(count)} steps) "
          f"{call_ms:.2f} ms; small case ({small[0].shape[0]} rows, K "
          f"{CLUSTER_SLOTS}) kernel {small_ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms")
    return times


def uniforms(shape, seed: int, dev, low: float = 1e-7):
    """Seeded uniforms on the card in [low, 1)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.rand(shape, generator=g, device=dev).clamp_(min=low)


def qs_pocd_mc_inputs(job, r_star, dev):
    """Phase 11's Monte-Carlo inputs: quickstart's (4096, 10, 4) uniforms,
    its job's columns and each mode's r* row."""
    J, N, R = QS_SHAPE
    u = uniforms((J, N, R), 0, dev)
    cols = tuple(torch.full((J,), float(x), device=dev)
                 for x in (job.t_min, job.beta, job.D))
    rows = {m: torch.full((J,), r_star[m], dtype=torch.int32, device=dev)
            for m in r_star}
    return u, cols, rows


def full_width_job(dev):
    """The paper trace's job whose task count is nearest the mean (ties
    to the lowest index), as a JobSpec at the kernel's fractions."""
    jobs = generate(2700, seed=0, device=dev)
    n = jobs.n_tasks.cpu().numpy().astype("float64")
    i = int(abs(n - n.sum() / len(n)).argmin())
    job = JobSpec.make(float(jobs.t_min[i]), float(jobs.beta[i]),
                       float(jobs.D[i]), int(n[i]), phi_est=0.25, C=1.0,
                       theta=1e-4, R_min=0.0, device=dev)
    return i, int(n[i]), job


def quietly(fn, *args):
    """fn(*args) with its printing dropped (a repeat run of a phase)."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def phase_quickstart(dev) -> dict:
    """examples/quickstart.py through the port on the card, then the
    full-width cross-check. The launch counts are set to 0 just before
    and read just after; `steps` holds each step's wall time (host clock,
    synchronized)."""
    steps = {}
    mark = [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        steps[name] = steps.get(name, 0.0) + now - mark[0]
        mark[0] = now

    gs.launches = pm.launches = pm.launches_all = 0
    lap("start")
    del steps["start"]
    job = JobSpec.make(**QUICKSTART)
    print("quickstart: closed-form PoCD / cost (Theorems 1-6)")
    for s in pm.MODES:
        for r in range(4):
            rt = torch.tensor(float(r), device=dev)
            print(f"  {s:9s} r={r} PoCD={float(pocd_of(s, rt, job)):.4f} "
                  f"E[T]={float(cost_of(s, rt, job)):7.1f} "
                  f"U={float(utility(s, rt, job)):+.4f}")
    lap("closed_forms")
    sols = {}
    for s in pm.MODES:
        sols[s] = solve_grid(s, job)
        lap("solve_grid")
        paper = solve_algorithm1(s, job)
        lap("solve_algorithm1")
        if sols[s].r_opt != paper.r_opt:
            raise AssertionError(f"quickstart {s}: solve_grid r*="
                                 f"{sols[s].r_opt} but solve_algorithm1 "
                                 f"r*={paper.r_opt}")
        print(f"  {s:9s} r*={sols[s].r_opt} U={sols[s].utility:+.4f} "
              f"(Algorithm 1 agrees: r*={paper.r_opt}) "
              f"Gamma={float(gamma(s, job)):+.2f}")
    orders = (bool(theory.clone_beats_srestart(job, 2)),
              bool(theory.sresume_beats_srestart(job, 2)))
    print(f"  Theorem 7: clone beats srestart {orders[0]}, sresume beats "
          f"srestart {orders[1]}")
    if not all(orders):
        raise AssertionError("quickstart: a Theorem 7 ordering fails")
    lap("gamma_theory")
    r_star = {s: sols[s].r_opt for s in ("clone", "sresume")}
    u, cols, rows = qs_pocd_mc_inputs(job, r_star, dev)
    for s in r_star:
        met, _ = pm.pocd_mc(u, *cols, rows[s], mode=s)
        p = float(met.mean())
        print(f"  {s:9s} r*={r_star[s]} theory PoCD={sols[s].pocd:.4f} "
              f"kernel MC PoCD={p:.4f}")
        if s == "clone" and abs(p - sols[s].pocd) > 0.02:
            raise AssertionError(f"quickstart: clone MC PoCD {p} vs "
                                 f"Theorem 1 {sols[s].pocd}")
    lap("pocd_mc")

    i, N, fjob = full_width_job(dev)
    fsols = {s: solve_grid(s, fjob) for s in pm.MODES}
    lap("full_width_solve")
    R = max(4, max(x.r_opt for x in fsols.values()) + 2)
    fu = uniforms((FULL_REPS, N, R), 1, dev)
    fcols = tuple(torch.full((FULL_REPS,), float(x), device=dev)
                  for x in (fjob.t_min, fjob.beta, fjob.D))
    r_modes = torch.stack([torch.full((FULL_REPS,), fsols[s].r_opt,
                                      dtype=torch.int32, device=dev)
                           for s in pm.MODES])
    lap("full_width_uniforms")
    met, cost = pm.pocd_mc_all(fu, *fcols, r_modes)
    lap("pocd_mc_all")
    print(f"full width: trace job {i}, N={N}, t_min={float(fjob.t_min):.4f}"
          f" beta={float(fjob.beta):.4f} D={float(fjob.D):.4f}; one "
          f"pocd_mc_all launch over {FULL_REPS} x {N} x {R} "
          f"({fu.numel() * 4 / 1e6:.1f} MB of uniforms)")
    full = {}
    for m, s in enumerate(pm.MODES):
        p = float(met[m].mean())
        se = (p * (1.0 - p) / FULL_REPS) ** 0.5
        c = float(cost[m].mean())
        full[s] = dict(r=fsols[s].r_opt, mc_pocd=p, se=se,
                       theory_pocd=fsols[s].pocd, mc_cost=c,
                       theory_cost=fsols[s].cost)
        print(f"  {s:9s} r*={fsols[s].r_opt} MC PoCD {p:.6f} +- {se:.6f} "
              f"(closed form {fsols[s].pocd:.6f}); MC mean cost {c:.2f} "
              f"(cost_of {fsols[s].cost:.2f})")
    if abs(full["clone"]["mc_pocd"] - full["clone"]["theory_pocd"]) > 0.01:
        raise AssertionError("full width: clone MC PoCD is not within 0.01 "
                             "of Theorem 1")
    lap("readout")
    counts = dict(pocd_mc=pm.launches, pocd_mc_all=pm.launches_all,
                  grid_solve=gs.launches)
    want = dict(pocd_mc=2, pocd_mc_all=1, grid_solve=2 * len(pm.MODES))
    if counts != want:
        raise AssertionError(f"quickstart path launches {counts}, expected "
                             f"{want}")
    print("quickstart path, first run: " + ", ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in steps.items())
        + f"; launches {counts}")
    return dict(counts=counts, full=full, steps=steps, qs=(u, cols, rows),
                fw=(fu, fcols, r_modes), full_shape=(FULL_REPS, N, R))


def mc_bound(u, t_min, beta, D, r_rows: dict):
    """(bytes ms, operations ms, dense ms) of one launch over `r_rows`'
    modes: the uniforms this data needs (the union of the modes' slots,
    each read once), the columns, r rows and outputs; dense counts every
    uniform (J N R 4 bytes), which the card reads at R = 5 since every
    32-byte sector holds some task's slot 0."""
    J, N, R = u.shape
    M = len(r_rows)
    n = pm.slots_read(u, t_min, beta, D, r_rows)
    attempts = int(torch.stack(list(n.values())).amax(dim=0).sum())
    side = J * (3 * 4 + 4 * M) + J * 8 * M
    formed = J * N
    if "clone" in n:
        formed += int((n["clone"] > 1).sum())
    ranges = [n[m] for m in ("srestart", "sresume") if m in n]
    if ranges:
        lo = torch.minimum(ranges[0], ranges[-1])
        hi = torch.maximum(ranges[0], ranges[-1])
        formed += int((lo > 1).sum() + (hi > lo).sum())
    ops = OPS_PER_ATTEMPT * formed + J * N
    for m, k in n.items():
        ops += int((k - 1).sum()) + OPS_PER_TASK[m] * J * N
    return (1e3 * (4 * attempts + side) / HBM_BYTES_PER_S,
            1e3 * ops / F32_OPS_PER_S,
            1e3 * (4 * J * N * R + side) / HBM_BYTES_PER_S)


def mc_times(u, cols, r_rows: dict) -> dict:
    """Device time per launch, wrapper call and plain times and the bound
    of pocd_mc (one mode in r_rows) or pocd_mc_all (all of MODES)."""
    if len(r_rows) == 1:
        (mode, r), = r_rows.items()
        launch = lambda: pm.pocd_mc_cuda(u, *cols, r, mode=mode)
        plain = lambda: pm.pocd_mc_plain(u, *cols, r, mode=mode)
        bits = MODE_BITS[mode]
    else:
        rm = torch.stack([r_rows[m] for m in pm.MODES])
        launch = lambda: pm.pocd_mc_all_cuda(u, *cols, rm)
        plain = lambda: pm.pocd_mc_all_plain(u, *cols, rm)
        bits = sum(MODE_BITS.values())
    bytes_ms, ops_ms, dense_ms = mc_bound(u, *cols, r_rows)
    bound_ms, bound_by = bound_of(bytes_ms, ops_ms)
    # the profiler may show the name demangled or mangled
    names_ = (f"pocd_mc_kernel<{bits}>", f"pocd_mc_kernelILi{bits}E")
    return dict(ms=kernel_ms(launch, 20, names_),
                call_ms=cuda_ms(launch, 50), plain_ms=cuda_ms(plain, 3),
                bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_dense_ms=dense_ms)


def check_mc(what, got, want, near, single=None):
    """met equal off the deadline, cost within MC_COST_RTOL, and the fused
    row equal to the single-mode launch; returns max |cost error|."""
    met, cost = got
    if bool(((met != want[0]) & ~near).any()):
        raise AssertionError(f"{what}: met differs from the plain version "
                             f"away from the deadline")
    close = torch.isclose(cost, want[1], rtol=MC_COST_RTOL, atol=0.0)
    if not bool(close.all()):
        raise AssertionError(f"{what}: cost outside rtol {MC_COST_RTOL} in "
                             f"{int((~close).sum())} jobs")
    if single is not None and not (torch.equal(met, single[0])
                                   and torch.equal(cost, single[1])):
        raise AssertionError(f"{what}: pocd_mc_all row differs from "
                             f"pocd_mc")
    return float((cost - want[1]).abs().max())


def phase_mc_check(dev, full_shape) -> dict:
    """The premise of the kernel's range minima (logf and expf monotone
    over every f32 input they get), then both Monte-Carlo kernels against
    their plain versions at every shape, r below and past the slots;
    timed with r below."""
    monotone = pm.monotone_violations(dev)
    if monotone != (0, 0):
        raise AssertionError(f"pocd_mc: logf / expf decrease at {monotone} "
                             f"f32 inputs; the range minima need them "
                             f"monotone")
    print("pocd_mc: logf over every f32 in (0, 1] and expf over every f32 "
          "in [0, 89) are non-decreasing (0 violations)")
    err = {"pocd_mc": 0.0, "pocd_mc_all": 0.0}
    times = {}
    for J, N, R in MC_SHAPES + (full_shape,):
        n_near = 0
        for high in (False, True):
            seed = J * 1000 + N * 10 + R + high
            g = torch.Generator(device=dev)
            g.manual_seed(seed)
            u = uniforms((J, N, R), seed, dev, low=1e-6)
            cols = (5.0 + 15.0 * torch.rand(J, generator=g, device=dev),
                    1.2 + 1.8 * torch.rand(J, generator=g, device=dev),
                    40.0 + 80.0 * torch.rand(J, generator=g, device=dev))
            lo, hi = (R - 1, R + 2) if high else (0, R - 1)
            r = torch.randint(lo, hi, (J,), generator=g, device=dev,
                              dtype=torch.int32)
            rows = dict(zip(pm.MODES, (r, (r - 1).clamp(min=0), r + 1)))
            singles = {}
            for m, rr in rows.items():
                near = pm.near_deadline(u, *cols, rr, mode=m)
                n_near += int(near.sum())
                singles[m] = pm.pocd_mc(u, *cols, rr, mode=m)
                err["pocd_mc"] = max(err["pocd_mc"], check_mc(
                    f"pocd_mc[{m}] {(J, N, R)}", singles[m],
                    pm.pocd_mc_plain(u, *cols, rr, mode=m), near))
            rm = torch.stack([rows[m] for m in pm.MODES])
            met, cost = pm.pocd_mc_all(u, *cols, rm)
            want = pm.pocd_mc_all_plain(u, *cols, rm)
            for k, m in enumerate(pm.MODES):
                near = pm.near_deadline(u, *cols, rows[m], mode=m)
                err["pocd_mc_all"] = max(err["pocd_mc_all"], check_mc(
                    f"pocd_mc_all[{m}] {(J, N, R)}", (met[k], cost[k]),
                    (want[0][k], want[1][k]), near, singles[m]))
            torch.cuda.synchronize()
            if high:
                continue
            t = {m: mc_times(u, cols, {m: rows[m]}) for m in pm.MODES}
            t["all"] = mc_times(u, cols, rows)
            times[(J, N, R)] = t
        single_ms = sum(t[m]["ms"] for m in pm.MODES)
        print(f"pocd_mc {(J, N, R)}: kernels equal the plain versions "
              f"(r below and past the slots); jobs at the deadline "
              f"{n_near}; fused / three single launches "
              f"{t['all']['ms'] / single_ms:.3f}")
        for m in pm.MODES + ("all",):
            x = t[m]
            print(f"  {m:9s} kernel {x['ms']:.5f} ms (call "
                  f"{x['call_ms']:.5f}), plain {x['plain_ms']:.4f} ms, bound "
                  f"{x['bound_ms']:.6f} ms ({x['bound_by']}; every uniform "
                  f"{x['bound_dense_ms']:.6f} ms)")
    return dict(max_abs_err=err, times=times, monotone_violations=monotone)


def fa_inputs(B, H, K, S, D, dtype, seed, dev, views=False, q_scale=1.0):
    """Seeded q (B, H, S, D) times q_scale, k and v (B, K, S, D) on the
    card; with `views`, the model's (B, S, heads, D) activations seen as
    (B, heads, S, D), as attention_full hands them to the kernel."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    out = []
    for heads, scale in ((H, q_scale), (K, 1.0), (K, 1.0)):
        shape = (B, S, heads, D) if views else (B, heads, S, D)
        x = (scale * torch.randn(shape, generator=g, device=dev)).to(
            getattr(torch, dtype))
        out.append(x.transpose(1, 2) if views else x)
    return out


def fa_compare(what, got, want, dt) -> tuple:
    """Raise unless got is finite, of want's type, and within FA_TOL[dt]
    of want; for bf16 also within FA_MEAN_REL / FA_MAX_REL of want's own
    size. Returns (max |err|, mean |err| / mean |want|, max |err| /
    max |want|)."""
    tol = FA_TOL[dt]
    if got.dtype != want.dtype or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash_attention {what}: output {got.dtype}, "
                             f"not all finite")
    g, w = got.float(), want.float()
    close = torch.isclose(g, w, rtol=tol, atol=tol)
    if not bool(close.all()):
        raise AssertionError(f"flash_attention {what}: outside {tol} of the "
                             f"plain version in {int((~close).sum())} "
                             f"elements")
    err = (g - w).abs()
    mean_rel = float(err.mean() / w.abs().mean())
    max_rel = float(err.max() / w.abs().max())
    if dt == "bfloat16" and (mean_rel > FA_MEAN_REL or max_rel > FA_MAX_REL):
        raise AssertionError(f"flash_attention {what}: mean |err| / mean "
                             f"|want| {mean_rel:.3g} (limit {FA_MEAN_REL:.3g})"
                             f", max |err| / max |want| {max_rel:.3g} (limit "
                             f"{FA_MAX_REL:.3g})")
    return float(err.max()), mean_rel, max_rel


def fa_bound(B, H, K, S, D, dtype, causal):
    """(bytes ms, operations ms): q, k, v and out moved once; the two
    products' multiply-adds over the (query, key) pairs the mask allows
    (the softmax's few operations a pair are not counted), at the tensor
    rate for bf16 and the f32 rate for f32."""
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * D * S * (2 * B * H + 2 * B * K)
    pairs = S * (S + 1) // 2 if causal else S * S
    ops = 4 * B * H * pairs * D
    rate = BF16_TENSOR_OPS_PER_S if dtype == "bfloat16" else F32_OPS_PER_S
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / rate


def phase_fa_check(dev) -> dict:
    """The flash-attention kernels against their plain version at every
    shape of FA_SHAPES, at the path's, and at FA_HOT_SHAPES with q scaled
    by FA_HOT_SCALE: bf16 through the tensor-core kernel, f32 through the
    SIMT one, each case moving its route's count by one. Returns max
    |error| by type and the largest relative readings of the bf16
    cases."""
    err = {"float32": 0.0, "bfloat16": 0.0}
    rel = {"mean_rel": 0.0, "max_rel": 0.0}
    cases = ([(x, 1.0) for x in FA_SHAPES + (FA_PATH + (True,),)]
             + [(x, FA_HOT_SCALE) for x in FA_HOT_SHAPES])
    for i, (shape, q_scale) in enumerate(cases):
        B, H, K, S, D, dt, causal, cap, views = shape
        q, k, v = fa_inputs(B, H, K, S, D, dt, 100 + i, dev, views=views,
                            q_scale=q_scale)
        before = (fa.launches_sm90, fa.launches_simt)
        got = fa.attention(q, k, v, causal=causal, softcap=cap)
        torch.cuda.synchronize()
        moved = (fa.launches_sm90 - before[0], fa.launches_simt - before[1])
        route = "sm90" if dt == "bfloat16" else "simt"
        if moved != ((1, 0) if route == "sm90" else (0, 1)):
            raise AssertionError(f"flash_attention {shape}: route counts "
                                 f"moved (sm90, simt) = {moved}, expected "
                                 f"one {route} launch")
        want = fa.attention_plain(q, k, v, causal=causal, softcap=cap)
        e, mean_rel, max_rel = fa_compare(shape, got, want, dt)
        err[dt] = max(err[dt], e)
        if dt == "bfloat16":
            rel = {"mean_rel": max(rel["mean_rel"], mean_rel),
                   "max_rel": max(rel["max_rel"], max_rel)}
        print(f"flash_attention {shape} q x{q_scale:g}: {route} kernel "
              f"equals the plain version, max abs err {e:.3g} (tol "
              f"{FA_TOL[dt]}), mean |err| / mean |want| {mean_rel:.3g}, "
              f"max |err| / max |want| {max_rel:.3g}")
    return err, rel


def fa_times(dev) -> dict:
    """At the serving path's shape: the tensor-core kernel's ms (profiler)
    and call ms (CUDA events), the SIMT kernel's on the same bf16 inputs
    (the previous design, through its own launcher), the plain ms, the
    bound, and the yardstick SDPA without the softcap."""
    B, H, K, S, D, dt, causal, cap = FA_PATH
    q, k, v = fa_inputs(B, H, K, S, D, dt, 7, dev, views=True)
    launch = lambda: fa.attention_cuda(q, k, v, causal=causal, softcap=cap)
    previous = lambda: fa.attention_simt(q, k, v, causal=causal, softcap=cap)
    plain = lambda: fa.attention_plain(q, k, v, causal=causal, softcap=cap)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True)
    # the SIMT kernel's bf16 instantiation is timed below; hold it once
    e, mean_rel, max_rel = fa_compare("SIMT kernel on bf16", previous(),
                                      plain(), dt)
    print(f"flash_attention at {FA_PATH}: SIMT kernel on bf16 equals the "
          f"plain version, max abs err {e:.3g}, mean |err| / mean |want| "
          f"{mean_rel:.3g}, max |err| / max |want| {max_rel:.3g}")
    bytes_ms, ops_ms = fa_bound(B, H, K, S, D, dt, causal)
    bound_ms, bound_by = bound_of(bytes_ms, ops_ms)
    out = dict(ms=kernel_ms(launch, 20, "flash_attention_sm90_kernel"),
               call_ms=cuda_ms(launch, 20),
               # 20 launches, as every kernel_ms: the profiler has been
               # seen to drop 3 records a session, which 5 could not take
               previous_ms=kernel_ms(previous, 20, "flash_attention_kernel"),
               previous_call_ms=cuda_ms(previous, 3),
               plain_ms=cuda_ms(plain, 3), library_ms=cuda_ms(library, 20),
               bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=bound_ms,
               bound_by=bound_by)
    out["bound_share"] = bound_ms / out["ms"]
    out["tflops"] = ops_ms * BF16_TENSOR_OPS_PER_S / 1e12 / out["ms"]
    print(f"flash_attention at {FA_PATH}: tensor-core kernel {out['ms']:.4f} "
          f"ms (call {out['call_ms']:.4f}; {out['tflops']:.1f} TFLOP/s, "
          f"{out['bound_share']:.3f} of the bound), previous SIMT kernel "
          f"{out['previous_ms']:.4f} ms (call {out['previous_call_ms']:.4f}),"
          f" plain {out['plain_ms']:.3f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}; bytes {bytes_ms:.5f}, operations {ops_ms:.5f}); SDPA"
          f" without softcap (yardstick, not on the path) "
          f"{out['library_ms']:.4f} ms")
    return out


def step_compare(cfg, card, host, n_tokens, tol):
    """Prefill, then n_tokens greedy decode steps of the same weights on
    the card and on the CPU, the host's choice fed to both: logits within
    `tol` at every step, and the choices equal wherever the host's top-2
    margin exceeds 2 tol. Returns (max |logit error|, clear choices)."""
    V = cfg.vocab_size
    batch = make_batch(cfg, CHECK_SERVE["batch"], CHECK_SERVE["prompt"],
                       "prefill", seed=1, device="cpu")
    max_seq = CHECK_SERVE["prompt"] + n_tokens
    dev = card.params["embed"].device
    out = [eng.model.prefill(eng.params, {"tokens": batch["tokens"].to(
        eng.params["embed"].device)}, max_seq) for eng in (card, host)]
    worst, clear = 0.0, 0
    for step in range(n_tokens + 1):
        (lg, cg), (lc, cc) = out
        lg = lg.cpu()
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"serve check step {step}: logits not "
                                 f"finite")
        err = float((lg - lc).abs().max())
        if not torch.allclose(lg, lc, rtol=tol, atol=tol):
            raise AssertionError(f"serve check step {step}: card logits "
                                 f"{err:.3g} off the CPU's (tol {tol})")
        worst = max(worst, err)
        top = torch.topk(lc[:, -1, :V], 2).values
        sure = (top[:, 0] - top[:, 1]) > 2 * tol
        tok_c = torch.argmax(lc[:, -1:, :V], dim=-1).to(torch.int32)
        tok_g = torch.argmax(lg[:, -1:, :V], dim=-1).to(torch.int32)
        if not torch.equal(tok_g[sure], tok_c[sure]):
            raise AssertionError(f"serve check step {step}: greedy choices "
                                 f"differ from the CPU's")
        clear += int(sure.sum())
        if step == n_tokens:
            break
        out = [card.model.decode_step(card.params, tok_c.to(dev), cg),
               host.model.decode_step(host.params, tok_c, cc)]
    return worst, clear


def phase_serve_check(dev) -> dict:
    """gemma2-2b cut to CHECK_SERVE["layers"] layers at full width, f32
    compute: the card (kernel) against the CPU (plain path) on the same
    weights."""
    cfg = dataclasses.replace(get_config(SERVE["arch"]),
                              n_layers=CHECK_SERVE["layers"],
                              compute_dtype="float32")
    t0 = time.perf_counter()
    params = model_lib.build(cfg).init(seed=1, device=dev)
    max_seq = CHECK_SERVE["prompt"] + CHECK_SERVE["tokens"]
    card = Engine.build(cfg, max_seq=max_seq, params=params, device=dev)
    host = Engine.build(cfg, max_seq=max_seq, params=params, device="cpu")
    del params
    fa.launches = fa.launches_sm90 = fa.launches_simt = 0
    err, clear = step_compare(cfg, card, host, CHECK_SERVE["tokens"],
                              CHECK_SERVE["tol"])
    if (fa.launches, fa.launches_simt, fa.launches_sm90) != (
            cfg.n_layers, cfg.n_layers, 0):
        raise AssertionError(f"serve check: {fa.launches} flash-attention "
                             f"launches ({fa.launches_simt} simt, "
                             f"{fa.launches_sm90} sm90), expected "
                             f"{cfg.n_layers} on the f32 (simt) route")
    del card, host
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"serve check (gemma2-2b, {cfg.n_layers} layers, full width, "
          f"f32, B {CHECK_SERVE['batch']}, prompt {CHECK_SERVE['prompt']}): "
          f"{cfg.n_layers} simt launches; card equals the CPU's plain path; "
          f"max logit err {err:.3g} (tol "
          f"{CHECK_SERVE['tol']}); {clear} clear greedy choices equal; "
          f"{secs:.1f} s")
    return dict(max_logit_err=err, clear_choices=clear, seconds=secs,
                simt_launches=cfg.n_layers)


def n_elements(tree) -> int:
    if isinstance(tree, dict):
        return sum(n_elements(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(n_elements(v) for v in tree)
    return tree.numel()


def synced(fn):
    """(fn(), host seconds) with the card synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_serve(dev) -> dict:
    """The serving path at full width (SERVE): build, first prefill, the
    counted main-path generate, warm prefill and decode times, a warm
    generate, and one profiled generate."""
    cfg = get_config(SERVE["arch"])
    B, P, T = SERVE["batch"], SERVE["prompt"], SERVE["tokens"]
    eng, build_s = synced(lambda: Engine.build(cfg, max_seq=P + T, seed=0,
                                               device=dev))
    batch = make_batch(cfg, B, P, "prefill", seed=0, device=dev)
    n_params = n_elements(eng.params)
    torch.cuda.reset_peak_memory_stats()
    (logits, cache), first_ms = synced(
        lambda: eng.model.prefill(eng.params, batch, P + T))
    if (tuple(logits.shape) != (B, 1, padded_vocab(cfg))
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"serve: prefill logits {tuple(logits.shape)},"
                             f" not all finite")
    del logits, cache

    # the main path: every count set to 0 just before, read just after
    gs.launches = pm.launches = pm.launches_all = 0
    fa.launches = fa.launches_sm90 = fa.launches_simt = 0
    toks, gen_first_s = synced(lambda: eng.generate(batch, T))
    counts = dict(flash_attention=fa.launches,
                  flash_attention_sm90=fa.launches_sm90,
                  flash_attention_simt=fa.launches_simt,
                  grid_solve=gs.launches, pocd_mc=pm.launches,
                  pocd_mc_all=pm.launches_all)
    if (counts["flash_attention"], counts["flash_attention_sm90"],
            counts["flash_attention_simt"]) != (cfg.n_layers, cfg.n_layers, 0):
        raise AssertionError(f"serve: flash-attention launches in one "
                             f"generate {counts}, expected {cfg.n_layers} "
                             f"(one per layer), all on the sm90 route")
    peak = torch.cuda.max_memory_allocated()
    if toks.shape != (B, T) or toks.min() < 0 or toks.max() >= \
            cfg.vocab_size:
        raise AssertionError(f"serve: tokens {toks.shape} outside the "
                             f"vocabulary")

    warm = [synced(lambda: eng.model.prefill(eng.params, batch, P + T))[1]
            for _ in range(3)]
    (logits, cache), _ = synced(
        lambda: eng.model.prefill(eng.params, batch, P + T))

    def decode_all():
        nonlocal logits, cache
        for _ in range(T):
            tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1).to(
                torch.int32)
            logits, cache = eng.model.decode_step(eng.params, tok, cache)

    _, decode_s = synced(decode_all)
    toks2, gen_warm_s = synced(lambda: eng.generate(batch, T))
    if not (toks2 == toks).all():
        raise AssertionError("serve: the warm generate's tokens differ from "
                             "the first's")
    prof = phase_profile(lambda: eng.generate(batch, T),
                         f"serve generate (B {B}, prompt {P}, {T} tokens)",
                         gen_warm_s)
    # the two halves apart: one prefill, then T decode steps
    prof_prefill = phase_profile(
        lambda: eng.model.prefill(eng.params, batch, P + T),
        "serve prefill alone", sorted(warm)[1])
    (logits, cache), _ = synced(
        lambda: eng.model.prefill(eng.params, batch, P + T))
    prof_decode = phase_profile(decode_all, f"serve {T} decode steps alone",
                                decode_s)
    del logits, cache
    out = dict(
        params=n_params, build_s=build_s, prefill_first_ms=1e3 * first_ms,
        prefill_warm_ms=1e3 * sorted(warm)[1],
        decode_ms_per_token=1e3 * decode_s / T,
        generate_first_s=gen_first_s, generate_warm_s=gen_warm_s,
        tokens_per_s=B * T / gen_warm_s, peak_memory_bytes=peak,
        counts=counts, profile=prof, profile_prefill=prof_prefill,
        profile_decode=prof_decode,
        kernel_share=prof["flash_attention_ms"] / prof["device_busy_ms"],
        tokens_head=toks[:, :8].tolist())
    print(f"serve {SERVE['arch']} ({n_params:,} parameters; B {B}, prompt "
          f"{P}, {T} tokens, max_seq {P + T}): build {build_s:.2f} s; "
          f"prefill first {out['prefill_first_ms']:.2f} ms, warm "
          f"{out['prefill_warm_ms']:.2f} ms; decode "
          f"{out['decode_ms_per_token']:.3f} ms per token; generate first "
          f"{gen_first_s:.3f} s, warm {gen_warm_s:.3f} s = "
          f"{out['tokens_per_s']:.1f} tokens/s; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {counts}; flash-attention "
          f"share of device busy {out['kernel_share']:.3f}; first tokens "
          f"{out['tokens_head']}")
    del eng
    torch.cuda.empty_cache()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible")
    dev = torch.device("cuda")
    card_line = card()
    print(card_line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.compile_sources(SOURCES)
    build_s = time.perf_counter() - t0
    print(f"build: {', '.join(SOURCES)} in {build_s:.2f} s")
    for name in SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}:", line.strip())
    sm90 = ptxas_report("flash_attention_sm90", "Li256E")
    print(f"  flash_attention_sm90 at D 256: {sm90}, dynamic shared memory "
          f"{fa.SM90_SMEM_BYTES[256]} bytes")
    dsk = {where: ptxas_report("dispatch_scan", f"dispatch_scan_kernelILb{b}")
           for where, b in (("shared", 1), ("device", 0))}
    print(f"  dispatch_scan, pool in shared memory: {dsk['shared']}; in "
          f"device memory: {dsk['device']}")
    p = SimParams()

    check = phase_check(dev, p)

    jobs = generate(2700, seed=0, device=dev)
    print(f"trace: {jobs.n_jobs} jobs, {jobs.total_tasks} tasks")
    walls, launches = {}, None
    for reps in (1, 8):
        solo = strategy_walls(jobs, p, reps, dev)
        first = timed_run_all(Philox(0), jobs, p, reps, dev)
        if launches is None:
            launches = gs.launches
        outs, r_min, second_s = timed_run_all(Philox(0), jobs, p, reps, dev)
        walls[reps] = (first[2], second_s)
        check_deterministic(first[0], outs, reps)
        print(f"run_all reps={reps}: r_min {r_min:.6f}; wall first "
              f"{first[2]:.4f} s, second {second_s:.4f} s; grid_solve "
              f"launches {gs.launches}")
        for name, o in outs.items():
            print(f"  {name:10s} pocd {float(o.result.pocd):.6f} mean_cost "
                  f"{float(o.result.mean_cost):.4f} utility "
                  f"{float(o.utility):.6f} sum_r {int(o.r_opt.sum())} "
                  f"n_sat {int(o.n_saturated)}; run_strategy cold "
                  f"{1e3 * solo[name][0]:.2f} ms, warm "
                  f"{1e3 * solo[name][1]:.2f} ms")

    phase_replay(jobs, p, dev)
    prof = phase_profile(
        lambda: run_all(Philox(0), jobs, p, theta=THETA, reps=1, device=dev),
        "run_all reps=1", walls[1][1])
    workloads = phase_workloads(dev)
    scen_kernel = phase_scenario_kernel(dev, p)
    scen_runs = phase_scenario_runs(dev, p)
    budget = phase_budget(dev, p)
    spans = phase_spans(dev, p)
    cluster, cluster_state = phase_cluster(dev, p, budget["budget"])
    path = phase_quickstart(dev)
    warm = quietly(phase_quickstart, dev)
    print("quickstart path, warm second run: " + ", ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in warm["steps"].items()))
    mc = phase_mc_check(dev, path["full_shape"])
    u, cols, rows = path["qs"]
    qs_t = {m: mc_times(u, cols, {m: r}) for m, r in rows.items()}
    fu, fcols, r_modes = path["fw"]
    fw_t = mc_times(fu, fcols, dict(zip(pm.MODES, r_modes)))
    fw_single = {m: mc_times(fu, fcols, {m: r_modes[k]})
                 for k, m in enumerate(pm.MODES)}
    print(f"path launches: pocd_mc at {QS_SHAPE} " + ", ".join(
        f"{m} {t['ms']:.5f} ms (bound {t['bound_ms']:.6f})"
        for m, t in qs_t.items())
        + f"; pocd_mc_all at {path['full_shape']} {fw_t['ms']:.5f} ms "
        f"(bound {fw_t['bound_ms']:.6f}, plain {fw_t['plain_ms']:.3f}); "
        "single-mode launches on the same inputs " + ", ".join(
            f"{m} {t['ms']:.5f} ms" for m, t in fw_single.items()))

    fa_err, fa_rel = phase_fa_check(dev)
    fa_t = fa_times(dev)
    serve_check = phase_serve_check(dev)
    serve = phase_serve(dev)

    # last: a profiler session this large can cost the next session its
    # first kernel records, and kernel_ms counts every launch
    qs_prof = phase_profile(lambda: quietly(phase_quickstart, dev),
                            "quickstart path", sum(warm["steps"].values()))
    cluster["times"] = cluster_times(dev, p, cluster_state)
    del cluster_state

    at_main = check["main"].values()
    bound_ms, bound_by = bound_of(sum(m["bytes_ms"] for m in at_main),
                                  sum(m["ops_ms"] for m in at_main))
    kernels = [{
        "name": "grid_solve",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grid_solve.cu",
        "replaces": "src/repro/kernels/grid_solve.py:142",
        "launches": launches,
        "max_abs_err": max(check["max_abs_err"], scen_kernel["max_abs_err"]),
        # one run_all's work: the 6 optimized strategies at J=2700, r_max=9;
        # ms is device time per launch (profiler), call_ms the wrapper call
        # (CUDA events over back-to-back calls)
        "ms": sum(m["ms"] for m in at_main),
        "call_ms": sum(m["call_ms"] for m in at_main),
        "plain_ms": sum(m["plain_ms"] for m in at_main),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "per_strategy": check["main"],
        # the same six at a fleet-sized chunk, (J, r_max) = FLEET_SHAPE
        "fleet_shape": dict(zip(("J", "r_max"), FLEET_SHAPE)),
        "per_strategy_fleet_shape": check["fleet"],
        "build_s": build_s,
        "run_all_wall_s_first_second": {str(r): w
                                        for r, w in walls.items()},
        "profile_reps1": prof,
        "launches_quickstart_path": path["counts"]["grid_solve"],
        # one run_all per scenario by name (each run counted); the budgeted
        # run_all launches none (plain grids, as the reference's XLA ones)
        "launches_scenarios": {k: v["launches"]
                               for k, v in scen_runs.items()},
        "launches_budgeted_run_all": budget["launches_run_all"],
        # the six launches of one run_all on each scenario's inputs
        "per_scenario": scen_kernel["per_scenario"],
        "request_storm_shape": {
            "J": scen_kernel["per_scenario"]["request-storm"]["J"],
            "r_max": 9},
        "per_strategy_request_storm": scen_kernel["request_storm"],
    }]

    def mc_entry(name, line, launches, parts, err, **extra):
        return dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/pocd_mc.cu",
            replaces=f"src/repro/kernels/pocd_mc.py:{line}",
            launches=launches, max_abs_err=err,
            ms=sum(t["ms"] for t in parts),
            call_ms=sum(t["call_ms"] for t in parts),
            plain_ms=sum(t["plain_ms"] for t in parts),
            bound_ms=max(sum(t["bytes_ms"] for t in parts),
                         sum(t["ops_ms"] for t in parts)),
            bound_by=bound_of(sum(t["bytes_ms"] for t in parts),
                              sum(t["ops_ms"] for t in parts))[1],
            bound_dense_ms=sum(t["bound_dense_ms"] for t in parts),
            library_ms=None, **extra)

    per_shape = {str(k): v for k, v in mc["times"].items()}
    kernels += [
        # the quickstart path's two launches (clone, sresume) at (4096,
        # 10, 4) on its own inputs
        mc_entry("pocd_mc", 133, path["counts"]["pocd_mc"],
                 list(qs_t.values()), mc["max_abs_err"]["pocd_mc"],
                 per_mode=qs_t, per_shape={k: {m: v[m] for m in pm.MODES}
                                           for k, v in per_shape.items()}),
        # the full-width launch on its own inputs
        mc_entry("pocd_mc_all", 170, path["counts"]["pocd_mc_all"], [fw_t],
                 mc["max_abs_err"]["pocd_mc_all"],
                 single_mode_ms_same_inputs={m: t["ms"]
                                             for m, t in fw_single.items()},
                 per_shape={k: v["all"] for k, v in per_shape.items()},
                 monotone_violations=mc["monotone_violations"],
                 full_width=path["full"],
                 quickstart_path_ms={"first": {k: 1e3 * v for k, v in
                                               path["steps"].items()},
                                     "warm": {k: 1e3 * v for k, v in
                                              warm["steps"].items()}},
                 profile_quickstart_path=qs_prof),
        # per launch at the serving path's shape (FA_PATH); launches from
        # the main-path generate (one prefill of SERVE["arch"]), all on the
        # bf16 tensor-core route; previous_ms is the SIMT kernel, which
        # keeps the f32 route, on the same bf16 inputs
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             replaces="src/repro/kernels/flash_attention.py:90",
             launches=serve["counts"]["flash_attention"],
             route_counts={"sm90": serve["counts"]["flash_attention_sm90"],
                           "simt": serve["counts"]["flash_attention_simt"]},
             f32_route=dict(
                 source="src/repro_torch/kernels/csrc/flash_attention.cu",
                 launches_serve_check=serve_check["simt_launches"]),
             max_abs_err=max(fa_err.values()), max_abs_err_by_type=fa_err,
             bf16_relative_err=fa_rel,
             ms=fa_t["ms"], call_ms=fa_t["call_ms"],
             previous_ms=fa_t["previous_ms"],
             previous_call_ms=fa_t["previous_call_ms"],
             plain_ms=fa_t["plain_ms"], bound_ms=fa_t["bound_ms"],
             bound_by=fa_t["bound_by"], bound_share=fa_t["bound_share"],
             tflops=fa_t["tflops"], bytes_ms=fa_t["bytes_ms"],
             ops_ms=fa_t["ops_ms"], library_ms=fa_t["library_ms"],
             registers=sm90["registers"],
             spills=sm90["spill_stores"] + sm90["spill_loads"],
             smem_bytes=fa.SM90_SMEM_BYTES[256],
             library="torch.nn.functional.scaled_dot_product_attention("
                     "is_causal=True, enable_gqa=True) without the softcap",
             shape=dict(zip(("B", "H", "K", "S", "D", "dtype", "causal",
                             "softcap"), FA_PATH)),
             serve=serve, serve_check=serve_check),
    ]
    ct = cluster["times"]
    kernels.append(dict(
        name="dispatch_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/dispatch_scan.cu",
        replaces="src/repro/cluster/events.py:106 (lax.scan; no Pallas "
                 "kernel)",
        # one run_cluster over the 10 strategies at reps 1: 2 passes each;
        # ms is its device time (profiler), summed over the run's launches
        launches=cluster["main"]["launches"][1],
        # over every case and both strategies' prefixes (bit-equal: 0)
        max_abs_err=cluster["max_abs_err"],
        ms=ct["kernel_ms_per_run"], ms_per_launch=ct["kernel_ms_per_launch"],
        ns_per_step=ct["ns_per_step"], steps=ct["steps_per_run"],
        per_pass=ct["per_pass"],
        rows=ct["rows_per_run"],
        # the wrapper's call on clone's pass 2 (CUDA events), and the small
        # case (3000 rows, 2400 steps, K 500), kernel and plain
        call_ms=ct["call_ms_clone_pass2"],
        call_steps=ct["clone_pass2_steps"],
        plain_ms=ct["small_case"]["plain_ms"],
        small_case=ct["small_case"],
        # 12 bytes a row below count (release and hold read, start
        # written), 8 past it (release read, start written)
        bound_ms=ct["bytes_ms"], bound_by="bytes",
        sort_ms=ct["sort_ms_per_run"],
        library_ms=None,
        library="none: no PyTorch call computes the slot recursion (a "
                "serial argmin-and-update over a pool)",
        registers={k: v["registers"] for k, v in dsk.items()},
        spills={k: v["spill_stores"] + v["spill_loads"]
                for k, v in dsk.items()},
        profile_run_cluster=ct["profile"]))
    cluster_line = json.dumps({"cluster": cluster})
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "cluster.json").write_text(cluster_line)
    print(cluster_line)
    print(json.dumps({"scenarios": {
        "workloads": workloads, "runs": scen_runs, "budget": budget,
        "spans": spans}}))
    print(json.dumps({"kernels": kernels}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
