#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases; each raises on failure, so any failure exits non-zero:

1. print the card (nvidia-smi name and power limit) and build every kernel
   of the main path from `src/repro_torch/kernels/csrc/` (grid_solve.cu,
   pocd_mc.cu, flash_attention.cu, flash_attention_sm90.cu,
   flash_attention_bwd_bf16.cu, flash_attention_bwd_f32.cu,
   dispatch_scan.cu, philox_rows.cu), one nvcc
   process per source, all started together, timed each,
   with ptxas's
   registers and spills (dispatch_scan's for each of its three designs,
   and the tensor-core backward's two launches at D 256, which must show
   0 bytes of stack and 0 spills), the sorted design's
   SASS instructions for one dispatch step (cuobjdump), and the
   tensor-core kernels' dynamic shared memory; then start the worker
   process that computes, beside the phases that follow, the CPU's side
   of each card-against-CPU train check of phases 16 (b), 19 (b) and 24
   (e) (`cpu_reference`: the weights drawn from the seed by the CPU's
   generator and one step on the CPU, at most CPU_REFS_AHEAD at a time,
   handed back through shared memory; the check copies those weights to
   the card, keeps the card's gradients and parameters there and
   compares on the card, the CPU's AdamW on the card's gradients taken
   leaf by leaf; the worker never touches the card);
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
2b. the draw kernel (csrc/philox_rows.cu) against its plain version run
   on the CPU, bit for bit: 20,000 rows with cells past 2^32 and
   negative, rows up to 2^24, 1, 3, 9 and 10 columns, the three draw
   names, the fleet's and the serving tag; and its raw generator on the
   three Philox4x32-10 known-answer vectors;
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
   EDF, at K = 1, 5, 37, 300, 400, 500, 512 (the sorted pool in registers),
   513, 20,000 (lane-private groups in shared memory) and 100,000 (in
   device memory); the batched kernel, one launch for P = 1, 3 and 8
   segments (unequal counts, 0 and n among them) at K = 500 and 513,
   against the batched plain version; the uniform 150x10 trace at K = 20,000
   (starts equal releases, mean wait 0); the paper trace's offered
   primary load at 500 slots (cluster.offered_load, 3600 s windows: mean,
   p95, max); then the main path,
   run_cluster(Philox(0), generate(2700, seed=0), SimParams(), slots=500,
   theta=1e-4) over all 10 strategies at reps 1, twice, traced: 6
   grid-solve and 20 dispatch launches a run, job_cost and job_met the
   same bits, each strategy's first and warm wall from its spans, and its
   PoCD, utilization and mean wait equal, to the printed digits, to the
   first dispatch kernel's (PR18_AT_500) and printed beside the JAX
   package's (a sanity line); the same at reps 8, twice: 6 grid-solve and
   20 dispatch launches a run (a launch a pass for all eight
   replications), the same bits; every strategy's full replay (build_strategy_table +
   replay, the table not narrowed): the main path's bits, start >=
   release, at most 500 units in service (an integer sweep over start
   and start + hold events), 0 <= utilization <= 1 + 1e-6; for clone and
   hadoop_s both passes' dispatch-ordered inputs rebuilt with the
   engine's functions, the kernel on the full arrays equal to the plain
   version on the CPU over the first 100,000 rows; clone's both passes
   for eight replications, stacked as P = 8 segments, one launch each
   bit-equal to eight single-segment launches; slots=None against
   run_all (r* equal, job_met equal but at deadline ties, 0 dispatch
   launches); EDF with passes=3, the governor and admission (slack 1.0)
   for sresume; slots 250 to 2000 and None for sresume and hadoop_s; a
   budgeted run_cluster on 2700 multi-tenant-sla jobs at phase 9's B
   (spend <= B wherever feasible). Timed at the very end of the script,
   after every other profiler session (a large session can cost the next
   one its first records): a profiled warm run_cluster (busy, idle share,
   top ops, the sorts'), its 20 dispatch launches each timed by CUDA
   events around the kernel's C entry (`LaunchTimes`: per run, per pass
   and per step; complete by construction, where the profiler can drop
   kernel records), the same at reps 8, the wrapper's call on clone's
   pass 2, ns a step on clone's pass 2 at K = 500, 512, 513, 1,000 and
   20,000 (each K's own design) and at K = 500 and 512 with the
   lane-private groups forced (the cutover's evidence), the sorted design
   built with 1 and 2 warps in place of 4 at K 512 (held to the shipped
   kernel's starts), the SM clock
   while the kernel runs, and the small case's kernel and plain times.
   Its JSON is also written to chiprun_out/cluster.json;
10c. the fleet layer (`repro_torch.fleet`): the paper-hadoop scenario at
   100,000 jobs synthesized on the card and run through `run_all` in
   chunks of 8,192 jobs (blocks of 64) and monolithically
   (`devices=1`), first and warm: every strategy's job_met, job_cost,
   job_completion and r* bit-equal between the two and between runs;
   grid-solve launches one a strategy and chunk; the chunked peak device
   memory below the whole task axis's (T, 9) f32 draw; walls, the draws
   (one `uniform_rows` a replication, chunk and draw name, each one
   philox_rows launch, counted) and their host ms, Tb against the mean
   block, and a profiled chunked sresume run (idle share), each beside
   PR 20's (PR20_FLEET). The paper trace at reps 8 through the fleet
   against run_all: every PoCD within 6 standard errors (from the runs'
   per-job met frequencies), r* equal at run_all's R_min. The capacity
   replay in windows (`run_cluster(chunk_jobs=675)`, 4 windows x 8
   replications at 500 slots): 20 dispatch launches of 32 segments a
   run, bit-equal to one launch a window (80), start >= release, at most
   500 in service in any window, utilization in [0, 1]; in sresume's
   launches, the shortest (padded) and the longest window's segment of
   both passes, as the path's own launch gave them, bit-equal in starts
   and final pool to the plain version on the CPU over the same sorted
   inputs; the grid-solve kernel on the first solve's own inputs of the
   monolithic (100,000 jobs) and the chunked (8,192) run against the
   plain version, as phase 2 holds it; kernel ms a run both ways (CUDA
   events, `LaunchTimes`), ns a step; how many rows of two windows'
   draws coincide.
   Its JSON is also written to chiprun_out/fleet.json;
10d. hedged online serving (`repro_torch.serve`): request-storm
   synthesized on the card at its registry size (20,000 requests), and
   `run_serve(Philox(0), reqs, window=256)` over all ten strategies,
   known-tail and online (refit_every 500, probe_every 10), each first
   and warm with every count set to 0 just before and read just after:
   grid-solve launches one a strategy (known tail), and in the online
   regime the epoch solves plus five a governor refit; one philox_rows
   launch a draw; every column finite and of shape (20,000,), sresume's
   and adaptive's PoCD above hadoop_ns's; window 1024 and the warm run
   bit-equal to the first; known tail: every strategy's slice
   [5000, 7000) served alone bit-equal to the full run's rows, and the
   first 2048 requests' known-tail grid solve equal to its plain version
   (check_grid) and their windows, served on the card and on the CPU with
   the card's r*, within f32 rtol 1e-5 (met equal but deadline ties).
   Per strategy PoCD, mean cost, utility, p50/p95/p99, mean r*, probes
   and refits; per regime the walls, requests/s, windows, draws a window
   and their host ms, and a profiled warm sresume serve_trace (idle
   share). Then the draw kernel timed at the serving window (256, 9), a
   fleet chunk and the monolithic fleet's task axis: kernel, call and
   plain ms, the bytes bound, torch.rand of the shape as a yardstick.
   Its JSON is also written to chiprun_out/serving.json;
10e. fault injection, chunk checkpoints and resume (`repro_torch.chaos`)
   on phase 10c's configuration, each run with every count set to 0 just
   before and read just after: (a) run_all(chunk_jobs=8192) over the
   100,000 paper-hadoop jobs under a plan of two injected failures of
   chunk 1, a corruption of chunk 4's payload and a loss of 2 devices at
   chunk 2, and under EMPTY_PLAN: phase 10c's chunked bits for all ten
   strategies; grid-solve launches 10c's, draw launches 10c's plus chunk
   4's once more a strategy (printed beside the prediction); every
   strategy's audit log (2 retries, 'ignored: single-device run', corrupt
   and its retry); the integrity checks counted (EMPTY_PLAN: none finds
   NaN) and timed, and warm walls with and without EMPTY_PLAN in turns;
   (b) the same run with a crash after chunk 6 and checkpoint= in a child
   process that imports repro_torch only: it must end in
   SimulatedCrash(6) with step 7 committed; resumed here, through one
   more crash a strategy, to 10c's bits, with the child's and the
   parent's grid-solve and draw launches summing to one run's; saves and
   resumes timed, bytes on disk, warm walls with the checkpointer; (c)
   pod-loss-flash-crowd at 100,000 jobs through run_fleet_strategy for
   every optimized strategy under its own plan and
   ElasticGovernor(base_devices=8): the cost scales, each chunk's r*
   against the plain grids' argmax at the scaled C (near-ties within
   phase 2's U tolerance counted), the jobs the price moved; run_all by
   the scenario's name (600 jobs, chunks of 64) gives every strategy the
   scenario's plan; (d) the capacity fleet (500 slots, 4 windows x 8
   replications): EMPTY_PLAN equal to 10c's windowed run, queue metrics
   included, one dispatch launch a pass for each window; slot_change -100
   at window 2 checked launch by launch (each launch's pool read from the
   kernel's free tensor: 500, 500, 400, 400; start >= release, at most
   the pool in service) with sresume's first 400-slot launch held bit
   for bit against the plain version on the CPU, and with a crash after
   window 1 resumed to the faulted run's bits and per-window pools.
   Dispatch launches and kernel ms beside 10c's. Its JSON is also written to chiprun_out/chaos.json;
10f. the facade: simulate(Philox(0), jobs, p, cfg=RunConfig(...),
   device=cuda) against an earlier phase's own run, bit for bit, on each
   route: flat (phase 3's reps 8), flat fleet (10c's chunked), capacity
   (10b's 500 slots), serve (10d's known tail) and chaos (10e's plan);
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

16. the training path. (a) The differentiable flash-attention call
   (`attention`: the kernel forward, `attention_backward` as its
   gradient, the backward kernel) against autograd through
   the plain version on the card, at
   phase 14's shapes, one training microbatch's (B 1, H 8, K 4, S 2048,
   D 256, bf16, softcap 50, the model's strided views) and the hot
   softcap cases: the forward moves its route's count by one; dq, dk, dv
   within 2e-5 of max |want| (f32) or phase 14's bf16 criteria, nonzero
   wherever the plain version's are, but where the f64 gradient is
   within rounding of 0 (`excused_zeros`: |f64| at most the plain f32
   version's worst error over the tensor, both in units of the
   element's sum of |terms|); the backward's ms at the path's
   shape beside its bound and SDPA's forward and backward. (b) gemma2-2b
   cut to 2 layers at full width, f32 compute, one train_step (AdamW) on
   the card (SIMT route, 4 launches) and on the CPU from the same seeded
   weights (the CPU's step from phase 1's worker): loss within 1e-5
   relative, gradients and updated parameters
   within 1e-4 of each tensor's max (updated elements whose gradient is
   within that of 0 may move either way: counted). (c) Trainer(gemma2-2b)
   at full width, f32 parameters, bf16 compute, 4 steps of 4 microbatches
   of 1 x 2048 on one repeated batch, the speculative pipeline on: every
   count set to 0 just before the trainer (whose producer thread starts
   deciding at once) and read after step 4: flash attention 52 x 4 a
   step, all sm90; grid solve 5 (the Chronos strategies) per warm
   governor decision, in both runs; losses
   finite and lower at step 4 than at step 1, and the same bits in a
   second run; first and warm step s, tokens/s, peak memory; one warm
   step profiled (device busy, idle share, flash attention's and
   `attention_backward`'s shares), the lm-head with cross-entropy and
   the AdamW update timed alone; model FLOPs a step over the warm step
   against the dense bf16 peak; the governor's decide ms in the
   producer thread during the run and with the card idle. (d) a narrow
   2-layer gemma2 (d 256, 4/2 heads of 64, vocab 4096):
   run(fail_at=2) with checkpoints, restored into a fresh trainer, the
   continued losses equal to an uninterrupted run's.

17. the masks, head dim 80 and the moe, vlm and audio families. (a) Both
   flash-attention kernels against the plain version on every mask
   (FA_MASK_CASES: causal with windows 1 to 4096, at and off 64 and 128;
   prefixes 64 to 4096; bidirectional with and without a window and with
   a prefix; a window with a prefix) at D 64, 80, 128 and 256, S 1000 and 2049, 1, 2
   and 4 kv heads, views and softcaps, bf16 on the tensor-core route and
   one case in three in f32 on the SIMT route; and FA_HOT_SHAPES with a
   window of S / 3 and a prefix of S / 4, q scaled by 16; phase 14's
   limits. (b) Per launch at the paths' shapes: gemma2-2b's local
   (window 4096) and global layers at S 8192, paligemma-3b's prefix
   layer (B 4, S 2048, prefix 256, one kv head), hubert-xlarge's D 80
   (B 8, H 16, S 1024, bidirectional): kernel ms, call ms, plain ms, the
   bound over the allowed pairs only, SDPA with a boolean attn_mask and
   no softcap. (c) Each family cut to 2 layers at full width, f32
   compute, card (SIMT route, 2 launches) against the CPU's plain path:
   olmoe-1b-7b and paligemma-3b by prefill and 3 decode steps (logits
   within 1e-4), hubert-xlarge's forward logits. (d) The full-width
   paths, every count set to 0 just before the first run and each
   launch's mask recorded: gemma2-2b with a batch of 1 x 8192 tokens
   and 16 generated (26 launches, the 13 local ones with window 4096;
   one local and one global launch held against the plain version on
   their own tensors), olmoe-1b-7b cut to 8 of 16 layers (4 x 2048, 16
   tokens, 8 launches, one held), paligemma-3b (4 x (256 patches + 1792 text), 16 tokens, 18
   launches with prefix 256, one held) and hubert-xlarge's forward (8 x 1024
   frames, 48 launches at D 80, one held): first and warm wall,
   tokens/s or frames/s, peak memory, the same tokens twice, and one
   profiled run (idle share, flash attention's share).

18. head dim 112 and the ssm and hybrid families. (a) Both
   flash-attention kernels at D 112 against the plain version on every
   mask of FA_MASKS (FA_D112_CASES: S 1000 and 2049, 32 query heads over
   1, 2, 4 and 32 kv heads, views, softcaps; bf16 on the tensor-core
   route, one case in three in f32 on the SIMT route) and FA_D112_HOT (q
   scaled by 16), phase 14's limits; ptxas's registers and spills of the
   D 112 instantiations; zamba2-7b's launch (4, 32, 32, 2048, 112),
   causal, timed beside its bound and SDPA(is_causal=True). (b)
   mamba2-2.7b cut to 2 layers and zamba2-7b to 3 (one group of one
   mamba layer and the shared block, one tail layer) at full width, f32,
   card against the CPU's plain path, B 1 x 64 tokens and 3 decode steps:
   logits within 1e-4 at every step, each card step from the CPU's cache;
   the caches' f32 states within 1e-4 of their max and their bf16 states
   and kv within that and one bf16 ulp; the card's run from its own
   caches recorded beside it; zamba2's one launch on the SIMT route. (c)
   mamba2-2.7b cut to 32 of 64 layers and zamba2-7b to 45 of 81 (7 of
   13 groups, the tail kept) at full width, bf16, through the Engine, 4 x
   2048 + 16 tokens, every count set to 0 just before the first
   generate: 0 flash launches for mamba2, 7 sm90 ones for zamba2 (the
   first held against the plain
   version on its own tensors); generate first and warm (the same
   tokens), prefill and decode ms, tokens/s, peak memory, one profiled
   generate (idle share), and the device time of a prefill and of one
   decode step by op (profiler ranges around the Mamba2 projections, the
   SSD intra-chunk work, the chunk scan and the shared attention block).

19. training of the moe, vlm, audio, ssm and hybrid families. (a) The
   differentiable attention call at D 80 and 112 on every mask of
   FA_MASKS (FA_GRAD_CASES: S 1000 and 2049, 1 to all kv heads, views,
   softcaps none, 50 and 30; bf16 on the tensor-core route, one case in
   three in f32 on the SIMT route) and FA_GRAD_HOT (q scaled by 16): the
   forward moves its route's count by one, dq, dk and dv within phase
   16 (a)'s limits of autograd through the plain version on the card.
   (b) Each family cut in depth at full width, f32 compute
   (CHECK_TRAIN_FAMILIES: olmoe and paligemma 1 layer, hubert and mamba2
   2; zamba2 3, one group of one Mamba2 layer and the shared block, then
   one tail layer): one make_train_step
   on 1 x 128 tokens (paligemma 256 patches + 64 text tokens, hubert 128
   frames) on the card (SIMT route, 2 launches an attention layer) and
   on the CPU from the same seeded weights (from phase 1's worker); hubert
   on both gradient
   paths, its unused `embed` with an all-zero gradient on both: loss
   within 1e-5, the gradient norm within 1e-4 (2^-7 bf16-accumulated),
   each gradient within 1e-3 of its tensor's max (2^-7; the elements
   past 1e-4 counted), the updated parameters within 1e-4 of the CPU's
   AdamW on the card's gradients; the CPU's AdamW under
   host_heap_reuse, as phase 16 (b)'s. (c) Each family at
   full width, f32 parameters and AdamW, bf16 compute, remat per block,
   3 steps of 4 microbatches of 1 x 2048 tokens (paligemma 256 + 1792;
   hubert 2 x 1024 frames) on one repeated batch: olmoe-1b-7b,
   mamba2-2.7b and zamba2-7b through the Trainer (pipeline and governor
   on), paligemma-3b and hubert-xlarge (at lr 3e-4) through
   make_train_step; olmoe-1b-7b and zamba2-7b cut in depth to the most
   layers (groups) whose 16 bytes a parameter leave 10 GiB (zamba2 16
   GiB) of the card, and for time olmoe-1b-7b to 6 layers, mamba2-2.7b
   to 8 of 64 and zamba2-7b to 2 groups (phases 22 and 25 took their
   seconds from here). Every
   count set to 0 just before and read after the last step: flash
   attention 2 per attention layer, microbatch and step, all sm90; grid
   solve 5 per warm governor decision (Trainer) or none; losses finite
   and lower at the last step than at the first; first and warm step
   s, tokens (frames) a second, peak memory, MFU (phase 16's formula,
   olmoe's experts at top-8 of 64); one microbatch's warm step profiled
   (the device's activity: idle share against its own wall, top ops) and
   the attention gradient's call timed alone at the path's shape. (d)
   `repro_torch.launch.serve.main(SERVE_LAUNCHER)`: full-width gemma2-2b,
   16 tokens for a batch of 2, then 100 hedged requests; its two lines,
   26 sm90 flash-attention launches, and the grid-solve (1) and Philox
   launches and printed numbers of the same HedgedScheduler run alone.

20. the sharding planner, the dry run and the roofline. (a)
   `launch/dryrun.py`'s cells on fake CUDA tensors at full width, in 4
   spawned processes (DRYRUN_GROUPS) started before phase 18, beside
   phases 18 and 19 and while (b) and (c) use the card:
   every applicable shape of gemma2-2b and zamba2-7b and arctic-480b's
   train_4k, on `h100` and `16x16`; each cell checks every spec against
   its leaf (no mesh axis twice, every sharded dim divisible); per cell
   FLOPs and bytes per device, arguments per device, `fits` and the
   roofline's dominant term; arctic-480b must not fit one card. Every
   16x16 cell is traced sharded as rank 0 of a fake process group of
   256 (train, prefill and decode alike): its record must have
   `"per_device": "trace"` and wire bytes, and a decode cell (decode_32k,
   long_500k) raises if any collective's result holds a cache leaf's
   whole extent on a dim `cache_spec_tree` shards (a gathered cache;
   `dryrun.cache_gathers`). (b)
   gemma2-2b at full width, each step traced on fake tensors and run on
   the card under the op analyzer: one microbatch's train step
   (TRACE_TRAIN: 1 x 4096, AdamW) and one decode step (TRACE_DECODE: 8
   x 32,768 of cache): FLOPs equal, bytes within 1% (any op that
   differs printed), the flash-attention entries equal to the sm90
   launches, the warm device time (CUDA events) at least the roofline
   bound; MFU by `model_flops_analytic` and by phase 16's formula. (c)
   `card_mesh()` over NCCL: gemma2-2b's full-width parameters placed
   with the (1, 1) plan and re-sharded onto a fresh plan, every leaf
   placed as planned and bit-equal to the original; the process group
   destroyed.

21. the fleet on a mesh of several points (`fleet.fleet_mesh`), each run
   bit-equal to the same call without a mesh (pocd, mean_cost, job_met,
   job_completion, job_cost, r*, the theory columns; in (b) also the
   queue and capacity metrics), its outputs on the mesh's first point,
   the caller's current device unchanged after it, and each point's
   launches by kernel counted (PointCounts; every point launches
   philox_rows, and dispatch_scan in (b); the grid solve only on the
   first point): (a) `run_all_fleet` over every strategy on phase 10c's
   100,000 paper-hadoop jobs in chunks of 8,192, reps 3, on (2, 2) and
   (1, 4) meshes laid on cuda:0; with two cards or more also on (1, k)
   over k = min(4, cards) distinct cards (one card: printed as not run);
   (b) `run_cluster_fleet` on the paper trace, 500 slots, FIFO, windows
   of 675 jobs, reps 3, collect_metrics, on (2, 2); (c) `run_serve` over
   request-storm's 20,000 requests, window 254 (256 on the mesh), on
   (1, 4), known tail and online; (d) `run_fleet_strategy[sresume]` on
   eight points, reps 2, with a device loss of ids (3, 6) at chunk 1
   and of 2 points at chunk 2 and a crash after chunk 2, then resumed:
   the records `alive=6` and `alive=4`, an ElasticGovernor(alpha=0)'s
   history of both, and the fault-free eight-point run's bits. Each
   run's wall beside its wall without a mesh (one card: no speedup is
   expected).

22. the sharded train step (DTensor eager SPMD). (a) On `card_mesh()`
   (NCCL, (1, 1)): gemma2-2b at full width, olmoe-1b-7b cut in depth as
   phase 19 cuts it, and paligemma-3b, hubert-xlarge, mamba2-2.7b (2
   layers each) and zamba2-7b (3: one group and one tail layer) at full
   width in their bf16 compute (SHARDED_CUTS, phase 19 (b)'s depths), 2
   steps each of 4 microbatches of 1 x 2048 tokens (paligemma 256
   patches and 1792 text tokens, hubert 2048 frames) from seed 0,
   unsharded, then with the state and batch placed
   by the plan (`place_train_state`), "shard_grads" and the parameters'
   specs as grad_specs, under `plan_context`: losses, gradient norms and
   every parameter against the unsharded step (bit-equal, or the first
   differing leaf and its largest difference printed), flash-attention
   launches counted from 0 (2 an attention layer, microbatch and step,
   all sm90, each through the operator's DTensor rule; none for
   mamba2), the first such launch's
   local inputs through the plain version (FA_TOL and the bf16 relative
   limits), step times, peak memory beside phase 16's. (b) Only where
   two cards or more are visible: olmoe-1b-7b at full width cut to 2
   layers on a (1, n) mesh of NCCL ranks, one a card, its losses against
   one card's; on one card a line says that (b) did not run and why.
   (c) The 16x16 dry run of every family's train_4k at full width,
   sharded (gemma2-2b's and zamba2-7b's are phase 20 (a)'s records, the
   others traced in two spawned processes started before phase 18):
   per-device FLOPs
   and bytes from rank 0's trace, wire bytes by collective (all-gathers
   and reduce-scatters required) beside `fsdp_reckoning`'s by hand, the
   roofline row with its collective term.

23. sharded prefill and decode (SHARDED_SERVE). On `card_mesh()`:
   gemma2-2b at full width and zamba2-7b at full width cut to 4 of its
   13 groups (the tail kept), weights cast to bf16 once, a 4 x 2048
   prompt and 16 greedy decode steps from seed 0, unsharded, then with
   the weights, prompt, tokens and caches placed by `place_serve_state`
   under `plan_context`: every step's logits, the greedy tokens and
   every cache leaf after the prefill and after the last step bit-equal
   (it raises otherwise, naming the first difference); flash-attention
   launches counted from 0 (one a prefill's attention layer: 26 and 4,
   all sm90; none a decode step), the first one's local inputs through
   the plain version; prefill and decode-step seconds, peak memory.

24. the registered configs never built on the card before: chatglm3-6b
   (32 query heads over 2 kv heads, RoPE on half of each head dim),
   mistral-nemo-12b (a 131,072-token vocabulary), deepseek-coder-33b
   (d_model 7168, 56 heads over 8) and arctic-480b (128 experts top-2
   beside a dense residual, bf16 parameters, Adafactor), at published
   width, cut only in depth. (a) Each config's flash-attention launch,
   (4, 32, 2, 2048, 128), (4, 32, 8, 2048, 128) and (4, 56, 8, 2048,
   128) (groups 16, 4 and 7; arctic's is deepseek's), causal, bf16, the
   model's strided views: the first launch moves the sm90 count by one
   and is held against the plain version (phase 14's bf16 criteria);
   kernel, call and plain ms, the bound over the causal pairs, SDPA with
   enable_gqa as a yardstick. (b) The Engine in bf16 compute, 4 x 2048
   prompts and 16 greedy tokens: chatglm3-6b cut to 14 of 28 layers,
   mistral-nemo-12b to 20 of 40 (both at full depth before PR 32),
   deepseek-coder-33b to 16 of 62, arctic-480b to 2 of 35 in its bf16; every count set to 0 just before the first generate
   and read just after (one sm90 launch a layer, causal, all in the
   prefill; the first held against the plain version); a warm generate
   with the same tokens, prefill ms, decode ms a token, tokens/s, peak
   memory, one profiled generate of the prompt and 8 tokens (idle
   share); phase 17's paths now print prefill and decode ms too. (c) Card against the CPU
   at full width, f32 compute: the dense configs cut to 2 layers through
   ssm_step_compare (prefill and 3 decode steps, each card step from the
   CPU's cache: logits within 1e-4, the bf16 caches within one ulp; the
   drift of the card decoding from its own cache recorded; one SIMT
   launch a layer); arctic-480b cut to 1 layer with its bf16
   parameters on both sides, the forward's logits of 1 x 32 tokens within
   1e-4, after the host's MemAvailable is printed beside what the CPU's
   side needs (it raises if the host is short): after (e), once the
   worker has stopped, so that its ~50 GB of host memory are its own.
   (d) Training at full
   width: the dense configs through the Trainer as phase 19 (c) trains
   olmoe-1b-7b (f32 parameters, AdamW, bf16 compute, remat, 3 steps of 4
   microbatches of 1 x 2048, the governor on), cut in depth to the most
   layers whose 16 bytes a parameter leave 10 GiB of the card, with phase
   19 (c)'s checks and readings; arctic-480b cut to 1 layer through
   make_train_step with its own Adafactor and bf16 parameters, 3 steps
   of one 4 x 2048 microbatch: 2 sm90 launches a step, the loss finite
   and falling, step s, peak memory. (e) The dense configs cut to 1 layer,
   one make_train_step on the card and on the CPU (phase 19 (b)'s
   limits); and the streamed Adafactor update of the card's own gradient
   of 8 of arctic's experts (taken as a leaf of its own, 1.1 GB in f32)
   against the unstreamed update: vr and vc bit-equal, parameters within
   1e-6 of their max. (e)'s CPU steps are the worker's last; it stops
   after them.
   The script's total time is printed before the JSON lines.

25. the attention gradient as a kernel (csrc/flash_attention_bwd_bf16.cu
   on the tensor cores for bf16, csrc/flash_attention_bwd.h for f32) and
   remat="dots". (a) The backward kernel against
   `attention_backward_plain` on the card (BWD_CASES: phase 16 (a)'s
   cases and hot softcaps, phase 17's masks, phase 19 (a)'s head dims 80
   and 112 and their hot cases, phase 24's groups 16, 4 and 7; f32 and
   bf16; the first case of each type also with inputs one element off
   an allocation: the f32 kernel loads them element by element, the
   wrapper copies them into fresh tensors for the bf16 kernel's TMA;
   the aligned inputs' bits): each case
   called twice, one launch a call and the same bits,
   dq, dk and dv within phase 16 (a)'s limits (its zeros too: a zero
   where the plain version's is not is lost unless `excused_zeros`
   excuses it), the worst readings by type; at FA_TRAIN each of its launches (profiler), the
   call, the plain version, SDPA's backward alone (yardstick: the median
   of BWD_LIBRARY_RUNS runs, and its device time) and the bound, and its
   TFLOP/s against the bf16 tensor rate; the dk/dv launch under both of
   its schedules (`splits_heads`) at FA_TRAIN and at two of phase 24's
   launches (BWD_ROUTE_SHAPES), the two within the bf16 limits.
   (b) The extra peak memory of one backward at (1, 8, 4, 8192, 256),
   causal, window 4096, softcap 50: the kernel's under 256 MiB, the
   plain version's at least 2 GiB. (c) gemma2-2b at full width and
   olmoe-1b-7b cut to 2 layers, 2 steps of 4 x 1 x 2048, remat "full"
   then "dots" from seed 0: losses, gradient norms, the first step's
   gradients and the updated parameters bit-equal (each leaf's 64-bit
   digest of its bits, taken on the card), launches counted
   (forward, recompute and backward), warm step s and peak memory of
   both; gemma2-2b cut to 2 layers under "dots" on card_mesh against
   unsharded, phase 22 (a)'s check. (d) The dry run's gemma2-2b and
   olmoe-1b-7b train_4k cells on h100 and 16x16 with remat_dots and
   with blockattn (traced in three processes started after phase 20)
   against the default cells: on h100 remat_dots's FLOPs are the
   default's less the blocks' weight products' forward FLOPs, on 16x16
   fewer; blockattn's records equal the default's.

The last lines are the backward JSON (phase 25), the configs JSON
(phase 24), the sharded-serve JSON
(phase 23), the sharded-train
JSON (phase 22), the mesh JSON
(phase 21), the planner JSON (phase 20),
the training-families
JSON (phase 19), the ssm JSON
(phase 18), the families JSON (phase 17), the training JSON (phase 16),
the chaos JSON (phases 10e and 10f), the serving JSON (phase 10d), the
fleet JSON (phase 10c), the cluster JSON (phase 10b), the scenarios JSON
(phases 6-10), the kernels JSON, the card line and the result JSON; each
of the first fourteen and the kernels JSON is also written under
`chiprun_out/`.
The script needs one CUDA card and exits non-zero without one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# the script's clock starts here, before torch and the port are imported:
# the time it prints at the end is the whole run's but the interpreter's
# start and exit
T_START = time.perf_counter()

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import Philox, SimParams, generate, names, run_all  # noqa: E402
from repro_torch import run_strategy  # noqa: E402
from repro_torch import RunConfig, ckpt, simulate  # noqa: E402
from repro_torch.chaos import (EMPTY_PLAN, ChaosContext,  # noqa: E402
                               ElasticGovernor, FaultEvent, FaultPlan,
                               SimulatedCrash, from_faults)
from repro_torch.chaos import inject as chaos_inject  # noqa: E402
from repro_torch.chaos import recovery as chaos_recovery  # noqa: E402
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
from repro_torch.cluster import engine as cluster_engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.coupled import (repair_independent,  # noqa: E402
                                 solve_jobs_coupled, total_utility,
                                 utility_cost_grids)
from repro_torch.fleet import blocks as fleet_blocks  # noqa: E402
from repro_torch.fleet import runner as fleet_runner  # noqa: E402
from repro_torch.fleet import run_fleet_strategy  # noqa: E402
from repro_torch.fleet import (fleet_mesh, run_all_fleet,  # noqa: E402
                               run_cluster_fleet)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import dispatch_scan as ds  # noqa: E402
from repro_torch.kernels import grid_solve as gs  # noqa: E402
from repro_torch.kernels import philox as ph  # noqa: E402
from repro_torch.launch.op_analyzer import BWD_PRODUCTS  # noqa: E402
from repro_torch.data.pipeline import (PipelineConfig,  # noqa: E402
                                       assemble, make_shard)
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models import mamba2 as model_mamba2  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import transformer as model_tf  # noqa: E402
from repro_torch.models.inputs import make_batch  # noqa: E402
from repro_torch.models.transformer import (layer_specs,  # noqa: E402
                                            padded_vocab)
from repro_torch.runtime.governor import WARM_DECISIONS  # noqa: E402
from repro_torch.serve import (Engine, HedgedScheduler,  # noqa: E402
                               ReplicaPool, Request)
from repro_torch.serve.engine import cast_weights  # noqa: E402
from repro_torch.train import (AdamW, Trainer, TrainerConfig,  # noqa: E402
                               TrainState, cosine_schedule, make_optimizer,
                               make_train_step)
from repro_torch.train.trainer import to_host  # noqa: E402
from repro_torch.serve import (make_requests, run_serve,  # noqa: E402
                               serve_trace)
from repro_torch.serve import loop as serve_loop  # noqa: E402
from repro_torch.serve import scheduler as serve_scheduler  # noqa: E402
from repro_torch.sim.draws import (DRAW_NAMES, FLEET_TAG,  # noqa: E402
                                   SERVE_TAG, WorkloadPhilox)
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
# the training path (phase 16): gemma2-2b at full width, f32 parameters
# and bf16 compute, 4 steps of 4 microbatches of 1 x 2048 tokens on one
# repeated batch (data_cycle 1), the speculative input pipeline on
TRAIN = dict(arch="gemma2-2b", n_steps=4, global_batch=4, seq_len=2048,
             n_micro=4, n_data_shards=4, data_cycle=1)
# one microbatch's attention call, as the model's strided views
FA_TRAIN = (1, 8, 4, TRAIN["seq_len"], 256, "bfloat16", True, 50.0)
# gradients of the f32 (SIMT) route: max |err| <= 2e-5 max |want|
FA_GRAD_F32 = 2e-5
# (b): gemma2-2b cut to 2 layers at full width, f32 compute, one
# train_step on one 1 x 128 batch on the card and on the CPU
CHECK_TRAIN = dict(layers=2, batch=1, seq=128, lr=3e-3, loss_rtol=1e-5,
                   tol=1e-4)
# (d): a narrow 2-layer gemma2 whose head dim the kernels take
RESTART = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
               head_dim=64, d_ff=512, vocab_size=4096)
RESTART_RUN = dict(n_steps=4, global_batch=4, seq_len=256, n_micro=2,
                   ckpt_every=2, log_every=1000)
SOURCES = ("grid_solve", "pocd_mc", "flash_attention",
           "flash_attention_sm90", "flash_attention_bwd_bf16",
           "flash_attention_bwd_f32", "dispatch_scan", "philox_rows")
# phase 17: the masks (causal, window, prefix) of both flash-attention
# kernels: (B, H, K, S, D, dtype, causal, window, prefix, softcap, views)
# at every head dim, ragged lengths, windows and prefixes at and off the
# kernels' tiles (64 and 128 keys, 64-row warpgroups, 128-row blocks),
# bidirectional with and without a window and with a prefix (which does
# nothing without causal); every bf16 case through the
# tensor-core kernel, one in three also in f32 through the SIMT kernel
FA_MASKS = ((True, 1, 0), (True, 63, 0), (True, 64, 0), (True, 65, 0),
            (True, 127, 0), (True, 128, 0), (True, 129, 0), (True, 700, 0),
            (True, 4096, 0), (True, None, 64), (True, None, 77),
            (True, None, 128), (True, None, 256), (True, None, 1000),
            (True, None, 4096), (False, None, 0), (False, None, 64),
            (False, 64, 0), (False, 300, 0), (True, 100, 50))
FA_MASK_CASES = tuple(
    (1, 8, (1, 2, 4)[i % 3], S, D, dt, causal, window, prefix,
     (None, 50.0, 30.0)[i // 2 % 3], i % 2 == 0)
    for i, (S, D, (causal, window, prefix), dt) in enumerate(
        (S, D, m, dt) for S in (1000, 2049) for D in (64, 80, 128, 256)
        for m in FA_MASKS for dt in ("bfloat16", "float32"))
    if dt == "bfloat16" or i % 3 == 0)
# the full-width paths of the new masks and families: gemma2-2b past its
# 4096-token window (13 local layers of 26), olmoe-1b-7b (moe), paligemma-3b
# (vlm: 256 patches + 1792 text tokens under the prefix-LM mask, one kv
# head of 256) through the Engine, and hubert-xlarge (audio: 8 x 1024
# frames, about 20 s of 16 kHz audio each at 50 frames/s, bidirectional,
# head dim 80) through Model.forward
# (16 tokens since PR 32: decode is host-bound, and phase 25 needed the
# script's seconds; the ms a decoded token is read as before)
WINDOW_SERVE = dict(arch="gemma2-2b", batch=1, prompt=8192, tokens=16)
FAMILY_SERVE = (dict(arch="olmoe-1b-7b", batch=4, prompt=2048, tokens=16,
                     n_layers=8),
                dict(arch="paligemma-3b", batch=4, prompt=2048, tokens=16))
ENCODER = dict(arch="hubert-xlarge", batch=8, frames=1024)
# each family cut to 2 layers at full width, f32 compute, card against
# the CPU's plain path: B 1, 64 text tokens (after 256 patches for vlm)
# or 128 frames, 3 decode steps
CHECK_FAMILY = dict(layers=2, batch=1, prompt=64, frames=128, tokens=3,
                    tol=1e-4)
# phase 18: head dim 112 (zamba2-7b's shared attention) in both kernels,
# (B, H, K, S, D, dtype, causal, window, prefix, softcap, views): every
# mask of FA_MASKS at S 1000 and 2049, 32 query heads over 1, 2, 4 and 32
# kv heads, contiguous and strided views, no softcap and caps of 50 and
# 30; every case in bf16 through the tensor-core kernel, one in three also
# in f32 through the SIMT kernel
FA_D112_CASES = tuple(
    (1, 32, (1, 2, 4, 32)[j % 4], S, 112, dt, causal, window, prefix,
     (None, 50.0, 30.0)[j // 4 % 3], j // 4 % 2 == 0)
    for j, (S, (causal, window, prefix)) in enumerate(
        (S, m) for S in (1000, 2049) for m in FA_MASKS)
    for dt in ("bfloat16", "float32") if dt == "bfloat16" or j % 3 == 0)
# q scaled by FA_HOT_SCALE at D 112: zamba2-7b's launch shape with a
# softcap, a window, a prefix, and f32 bidirectional
FA_D112_HOT = (
    (4, 32, 32, 2048, 112, "bfloat16", True, None, 0, 50.0, True),
    (1, 32, 4, 2049, 112, "bfloat16", True, 683, 0, 30.0, True),
    (1, 32, 2, 2049, 112, "bfloat16", True, None, 512, 50.0, False),
    (1, 32, 32, 1000, 112, "float32", False, None, 0, 30.0, False))
# zamba2-7b's launch: 4 x 2048 tokens, 32 heads of 112, causal, no softcap
FA_D112_PATH = (4, 32, 32, 2048, 112)
# (b): each family cut in depth at full width, f32 compute, card against
# the CPU's plain path: mamba2-2.7b at 2 layers; zamba2-7b at 3 layers,
# one group of one mamba layer and the shared block, then one tail layer
CHECK_SSM = dict(batch=1, prompt=64, tokens=3, tol=1e-4,
                 cuts={"mamba2-2.7b": dict(n_layers=2),
                       "zamba2-7b": dict(n_layers=3, shared_attn_every=2)})
# (c): both at full width through the Engine, bf16 weights (16 tokens
# since PR 32, as phase 17's paths)
SSM_SERVE = (dict(arch="mamba2-2.7b", batch=4, prompt=2048, tokens=16,
                  n_layers=32),
             dict(arch="zamba2-7b", batch=4, prompt=2048, tokens=16,
                  n_layers=45))
# the functions whose device time phase 18 (c) reads as a profiler range:
# (range, module, function)
SSM_RANGES = (("projections", model_mamba2, "_project"),
              ("projections", model_mamba2, "_out_proj"),
              ("ssd_intra", model_mamba2, "_ssd_intra"),
              ("ssd_chunk_scan", model_mamba2, "_ssd_chunk_scan"),
              ("shared_block", model_tf, "apply_block"))
# phase 19: training of the moe, vlm, audio, ssm and hybrid families.
# (a) the attention gradient at head dims 80 (hubert-xlarge's 16 heads)
# and 112 (zamba2-7b's 32) on every mask of FA_MASKS at S 1000 and 2049,
# 1 to all kv heads, views, softcaps none, 50 and 30: every case in bf16
# on the tensor-core route, one in three also in f32 on the SIMT route;
# then the hot cases (q scaled by FA_HOT_SCALE), FA_D112_HOT and their
# D 80 counterparts
FA_GRAD_CASES = tuple(
    (1, H, kvs[j % 4], S, D, dt, causal, window, prefix,
     (None, 50.0, 30.0)[j // 4 % 3], j // 4 % 2 == 0)
    for D, H, kvs in ((80, 16, (1, 2, 4, 16)), (112, 32, (1, 2, 4, 32)))
    for j, (S, (causal, window, prefix)) in enumerate(
        (S, m) for S in (1000, 2049) for m in FA_MASKS)
    for dt in ("bfloat16", "float32") if dt == "bfloat16" or j % 3 == 0)
FA_GRAD_HOT = FA_D112_HOT + (
    (8, 16, 16, 1024, 80, "bfloat16", False, None, 0, 30.0, True),
    (1, 16, 4, 2049, 80, "bfloat16", True, 683, 0, 50.0, True),
    (1, 16, 2, 2049, 80, "bfloat16", True, None, 512, 30.0, False),
    (1, 16, 16, 1000, 80, "float32", False, 300, 0, 50.0, False))
# (b): each family cut in depth at full width, f32 compute: one
# make_train_step (AdamW, no schedule) on one batch of 1 x 128 tokens
# (paligemma 256 patches + 64 text tokens, hubert 128 frames), card
# against the CPU's plain path from the same seeded weights; hubert on
# both gradient paths (its `embed` gets no gradient). The loss within
# loss_rtol; gradients and their norm within tol of each tensor's max,
# bf16-accumulated ones within bf16_tol (one that rounds the other way
# is one bf16 ulp, 2^-8, off); the updated parameters within tol of the
# CPU's AdamW applied to the card's gradients (phase 16 (b)'s rule).
# Each gradient tensor is held within grad_tol of its max (the elements
# past tol counted): a Mamba2 layer's per-head A_log, dt_bias and D sum
# every token's and channel's terms of their head, and f32 sums in the
# card's order and the CPU's part by up to ~1.3e-4 of their largest
CHECK_TRAIN_FAMILIES = dict(
    batch=1, seq=128, text=64, lr=3e-3, loss_rtol=1e-5, tol=1e-4,
    grad_tol=1e-3, bf16_tol=2.0 ** -7,
    cuts={"olmoe-1b-7b": dict(n_layers=1), "paligemma-3b": dict(n_layers=1),
          "hubert-xlarge": dict(n_layers=2), "mamba2-2.7b": dict(n_layers=2),
          "zamba2-7b": dict(n_layers=3, shared_attn_every=2)},
    paths={"hubert-xlarge": ((), ("bf16_grads",))})
# (c): each family at full width, f32 parameters and AdamW, bf16 compute,
# remat each block (zamba2: each group), FAMILY_STEPS steps of TRAIN's 4
# microbatches on one repeated batch: 1 x 2048 tokens (paligemma 256
# patches + 1792 text tokens; hubert 2 x 1024 frames). olmoe, mamba2 and
# zamba2 through the Trainer, the speculative pipeline and governor on;
# paligemma and hubert through make_train_step with the Trainer's
# optimizer and schedule (the Trainer feeds tokens only, as the
# reference's). At 16 bytes a parameter olmoe-1b-7b (103 GiB) and
# zamba2-7b (86 GiB) do not fit: their depth is cut, never their width,
# to the most layers (zamba2: groups of 5 Mamba2 layers and the shared
# block, its 3 tail layers kept) that leave `headroom` bytes of the card
# for activations: 10 GiB for olmoe; 16 GiB for zamba2, whose backward
# of a group holds five Mamba2 layers' recomputed activations and the
# plain attention backward's (1, 32, 2048, 2048) f32 tensors (10 GiB ran
# out of memory at 10 groups). `units` caps a cut further, for time: the
# sharded steps of phase 22 took their seconds back from here (mamba2-2.7b
# 16 of 64 layers, zamba2-7b 3 groups, 3 steps where 4 were), and phase
# 25 some more (olmoe-1b-7b 6 layers, mamba2-2.7b 8, zamba2-7b 2 groups;
# the script ran 1,213 s on a slow host with the earlier cuts; the first
# step moves no weight: the schedule's warm-up starts at 0, so 3 steps is
# the fewest whose losses can fall). hubert-xlarge
# trains at lr 3e-4, not the Trainer's 3e-3, at which its 48 layers'
# loss rose over 4 steps on this batch of random frame labels
FAMILY_STEPS = 3
TRAIN_FAMILIES = (
    dict(arch="olmoe-1b-7b", via="trainer", cut="layers",
         headroom=10 * 2 ** 30, units=6),
    dict(arch="paligemma-3b", via="step", batch=4, seq=2048, lr=3e-3),
    dict(arch="hubert-xlarge", via="step", batch=8, seq=1024, lr=3e-4),
    dict(arch="mamba2-2.7b", via="trainer", cut="layers",
         headroom=10 * 2 ** 30, units=8),
    dict(arch="zamba2-7b", via="trainer", cut="groups",
         headroom=16 * 2 ** 30, units=2))
# (d): the serving launcher on the card, as a user runs it
SERVE_LAUNCHER = ["--arch", "gemma2-2b", "--full-config", "--tokens", "16",
                  "--batch", "2"]
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
# test cases (K 400 is the fleet's pool after phase 10e's slot change;
# 20,000 keeps the pool in shared memory, 100,000 puts it in
# device memory) and the rows of the full-size prefix check
CLUSTER_SLOTS = 500
CLUSTER_SWEEP = (250, 500, 1000, 2000, None)
DISPATCH_KS = (1, 5, 37, 300, 400, 500, 512, 513, 20_000, 100_000)
PREFIX_ROWS = 100_000
# the batched launch: segments a launch and pools (both designs); the
# replications of the reps-8 runs and of the stacked clone check
BATCH_PS = (1, 3, 8)
BATCH_KS = (500, 513)
REPS_BIG = 8
# ns a step on clone's pass 2: each K's own design, and the lane-private
# groups forced below the cutover
STEP_KS = (500, 512, 513, 1000, 20_000)
FORCED_KS = (500, 512)
# the sorted design built with 1 and 2 warps, timed at K 512 beside the
# 4 that ship (csrc/dispatch_scan.cu's DISPATCH_SORTED_WARPS)
SORTED_WARP_VARIANTS = (1, 2)
SORTED_WARPS = 4
# the fleet (phase 10c): the paper-hadoop scenario at 100,000 jobs
# streamed in chunks of FLEET_CHUNK jobs, blocks of FLEET_BLOCK, held
# bit for bit against the monolithic fleet run; the paper trace at reps 8
# against run_all within FLEET_SIGMAS standard errors; the capacity
# replay in windows of FLEET_WINDOW jobs (4 windows x 8 replications, 32
# segments a launch)
FLEET_JOBS = 100_000
FLEET_CHUNK = 8192
FLEET_BLOCK = 64
FLEET_SIGMAS = 6.0
FLEET_WINDOW = 675
# the draw kernel (csrc/philox_rows.cu): the check's rows (cells past
# 2^32 and below 0, rows up to 2^24) and column counts, and the
# known-answer vectors of Philox4x32-10 (Salmon et al., SC'11):
# (counter, key, output words)
PHILOX_CHECK_ROWS = 20_000
PHILOX_COLS = (1, 3, 9, 10)
PHILOX_KAT = (
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)))
# chaos at the fleet's scale (phase 10e), on phase 10c's configuration:
# faults that change nothing (two injected failures of chunk 1, a
# corruption of chunk 4's payload, a loss of 2 devices at chunk 2), a
# crash after chunk 6 in a child process, the elastic-recovery scenario
# re-priced against 8 devices, and the windowed capacity fleet with the
# pool 100 slots smaller from window 2 and a crash after window 1
CHAOS_FAULTS = (("chunk_fail", 1, 2), ("corrupt", 4, 1),
                ("device_loss", 2, 2))
CHAOS_CRASH = 6
CHAOS_SCENARIO = "pod-loss-flash-crowd"
CHAOS_BASE_DEVICES = 8
# the scenario by name at its registry size (600 jobs): chunks of 64 jobs
# put its events (chunks 2, 3 and 5) inside the run
CHAOS_SCENARIO_CHUNK = 64
CHAOS_WINDOW_FAULTS = (("slot_change", 2, -100),)
CHAOS_WINDOW_CRASH = 1
# hedged online serving (phase 10d): request-storm at its registry size
# (20,000 requests), all ten strategies, windows of 256; the online regime
# at examples/serve_requests.py's defaults; window 1024 and the slice
# [5000, 7000) served alone against the main run's bits; the first 2048
# requests served on the card and on the CPU with the card's r*
SERVING = dict(scenario="request-storm", window=256, wide=1024,
               refit_every=500, probe_every=10, slice=(5000, 7000),
               check=2048)
# PR 20's final run of the fleet (PERF.md), printed beside this run's:
# warm walls, the host's cell draws (25,008 cells a run, one
# torch.Generator each) and the chunked sresume run's idle share
PR20_FLEET = {"monolithic": {"wall_s": 2.337, "draw_host_s": "1.66-1.68"},
              "chunked": {"wall_s": 2.650, "draw_host_s": "1.66-1.68"},
              "cells": 25008, "idle_share": 0.845}
# (PoCD, utilization, mean wait s) of every strategy at 500 slots, reps 1,
# as PR 18's final run printed them with the first dispatch kernel: a
# redesign that keeps the semantics prints the same digits
PR18_AT_500 = {
    "hadoop_ns": ("0.0222", "0.0250", "84.31"),
    "hadoop_s": ("0.1759", "0.4752", "45.09"),
    "mantri": ("0.2522", "0.4762", "42.30"),
    "clone": ("0.5219", "0.5622", "77.28"),
    "srestart": ("0.6015", "0.3994", "32.91"),
    "sresume": ("0.6204", "0.3909", "31.46"),
    "hedge": ("0.0289", "0.4866", "45.54"),
    "adaptive": ("0.6133", "0.3910", "31.64"),
    "clone_prop": ("0.5233", "0.5623", "77.39"),
    "clone_sjf": ("0.5215", "0.5621", "77.27")}
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


def cuobjdump() -> str:
    """The CUDA toolkit's cuobjdump, else the copy Triton's package
    carries."""
    exe = Path(build.nvcc()).with_name("cuobjdump")
    if exe.exists():
        return str(exe)
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin is not None:
        exe = Path(spec.origin).parent / "backends/nvidia/bin/cuobjdump"
        if exe.exists():
            return str(exe)
    raise AssertionError("cuobjdump not found (CUDA toolkit or triton)")


def sass_step(name: str, marker: str, op: str) -> dict:
    """SASS instructions of one dispatch step of the kernel of
    `csrc/<name>.cu` whose mangled name holds `marker`: every loop (a
    branch back to an earlier address) that holds the instruction `op`,
    which the kernel issues once a step, is counted, instructions over
    steps, and the loop with the fewest a step (the steady state, where
    the compiler unrolled) is reported."""
    import re
    lib = build.compile_sources([name])[name]
    text = subprocess.run([cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    funcs = [f for f in text.split("Function : ")[1:]
             if marker in f.split("\n", 1)[0]]
    if len(funcs) != 1:
        raise AssertionError(f"{len(funcs)} SASS functions hold {marker}")
    addrs, instrs = [], []
    for line in funcs[0].splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addrs.append(int(m[1], 16))
            instrs.append(m[2])
    index = {a: i for i, a in enumerate(addrs)}
    loops = []
    for i, ins in enumerate(instrs):
        m = re.search(r"\bBRA\b[^;]*?(0x[0-9a-f]+)", ins)
        if m and index.get(int(m[1], 16), i + 1) <= i:
            body = instrs[index[int(m[1], 16)]:i + 1]
            codes = [x.split()[1] if x.startswith("@") else x.split()[0]
                     for x in body]
            steps = sum(c.startswith(op) for c in codes)
            if steps:
                loops.append((len(body) / steps, len(body), steps, codes))
    if not loops:
        raise AssertionError(f"no loop of {marker} holds a dispatch step")
    per_step, n, steps, codes = min(loops, key=lambda x: x[0])
    mix = {}
    for c in codes:     # by opcode, without its modifiers
        mix[c.split(".")[0]] = mix.get(c.split(".")[0], 0) + 1 / steps
    return dict(instructions_per_step=per_step, loop_instructions=n,
                steps_per_loop=steps, kernel_instructions=len(instrs),
                mix_per_step=dict(sorted(mix.items(), key=lambda kv: -kv[1])),
                loops=[dict(instructions=b, steps=k) for _, b, k, _ in loops])


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


def kernel_ms(fn, iters: int, name, tries: int = 6) -> float:
    """Mean device time per launch of the kernels whose name holds `name`
    (a string, or a tuple of alternatives), from torch.profiler over
    `iters` calls of fn(). The profiler now and then drops kernel records
    (one session of 20 launches has shown 2; three sessions in a row have
    shown 6, 0 and 6), so a session that does not see all `iters` is run
    again, up to `tries` sessions; after that the
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
    time and the top device ops. It records the device's activity alone:
    every number here is the device's, and with the host's activity too a
    generate's ~100,000 device ops take about a minute to read back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
                      "dispatch_scan", "philox_rows")}
    sort_ms = sum(e.device_time_total for e in rows
                  if "sort" in e.key.lower()) / 1e3
    idle = 1.0 - (busy_us / 1e3) / (wall_s * 1e3)
    print(f"profile {label}: device busy {busy_us / 1e3:.3f} ms in "
          f"{n_ops} device ops; unprofiled warm wall {wall_s * 1e3:.3f} ms; "
          f"device idle share {idle:.3f}; grid_solve kernel "
          f"{ours['grid_solve']:.3f} ms, pocd_mc kernels "
          f"{ours['pocd_mc']:.3f} ms, flash_attention kernels "
          f"{ours['flash_attention']:.3f} ms, dispatch_scan kernel "
          f"{ours['dispatch_scan']:.3f} ms, philox_rows kernel "
          f"{ours['philox_rows']:.3f} ms, sorts {sort_ms:.3f} ms")
    top = sorted(rows, key=lambda e: -e.device_time_total)[:10]
    for e in top[:8]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms "
              f"{100 * e.device_time_total / busy_us:5.1f}% x{e.count:<5d} "
              f"{e.key[:90]}")
    return dict(device_busy_ms=busy_us / 1e3, device_ops=n_ops,
                top=[dict(op=e.key[:90], ms=e.device_time_total / 1e3,
                          count=e.count) for e in top],
                idle_share=idle, grid_solve_ms=ours["grid_solve"],
                pocd_mc_ms=ours["pocd_mc"],
                flash_attention_ms=ours["flash_attention"],
                dispatch_scan_ms=ours["dispatch_scan"],
                philox_rows_ms=ours["philox_rows"],
                dispatch_scan_launches=sum(e.count for e in rows
                                           if "dispatch_scan" in e.key),
                sort_ms=sort_ms)


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


def batched_case(P: int, K: int, n: int = 3000, seed: int = 0):
    """tests/test_torch_cluster.py's batched_inputs on the CPU: P segments
    of rows on coarse grids (ties in release), holds with zeros among
    them, pools with tied free times, counts n and 0 first, then draws."""
    rng = np.random.default_rng(seed)
    release = (rng.integers(0, n // 6, (P, n)) * 0.5).astype(np.float32)
    hold = (rng.integers(0, 12, (P, n)) * 0.25).astype(np.float32)
    free = (rng.integers(0, 4, (P, K)) * 0.5).astype(np.float32)
    count = np.array([n, 0] + list(rng.integers(1, n, max(P - 2, 0))),
                     np.int32)[:P]
    return tuple(map(torch.from_numpy, (release, hold, count, free)))


def batched_vs_plain(P: int, K: int, dev) -> None:
    """One launch for P segments against the batched plain version on the
    CPU: starts and final pools bit-equal."""
    release, hold, count, free = batched_case(P, K, seed=P)
    free_k = free.to(dev)
    got = ds.dispatch_scan_batched_cuda(release.to(dev), hold.to(dev),
                                        count.to(dev), free_k)
    want = ds.dispatch_scan_batched_plain(release, hold, count, free)
    torch.cuda.synchronize()
    if not (torch.equal(got.cpu(), want) and torch.equal(free_k.cpu(),
                                                          free)):
        raise AssertionError(f"dispatch_scan_batched P={P} K={K}: starts or "
                             f"pools differ from the plain version")


def segments_vs_single(cases, slots: int, dev) -> None:
    """The (release, hold, count) cases stacked as segments of one launch
    against one single-segment launch each: starts and final pools
    bit-equal."""
    free = torch.zeros(len(cases), slots, device=dev)
    got = ds.dispatch_scan_batched_cuda(
        torch.stack([c[0] for c in cases]), torch.stack([c[1] for c in cases]),
        torch.stack([c[2].reshape(()) for c in cases]), free)
    for k, (rel, hold, count) in enumerate(cases):
        one = torch.zeros(slots, device=dev)
        want = ds.dispatch_scan_cuda(rel, hold, count, one)
        if not (torch.equal(got[k], want) and torch.equal(free[k], one)):
            raise AssertionError(f"dispatch_scan_batched: segment {k} of "
                                 f"{len(cases)} differs from its own launch")


class RepSource:
    """A uniform source whose replication 0 is replication `rep` of
    `inner`, so build_strategy_table draws that replication's table."""

    def __init__(self, inner, rep: int):
        self.inner, self.rep = inner, rep

    def uniform(self, strategy, rep, name, shape, device):
        return self.inner.uniform(strategy, self.rep, name, shape, device)


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


def queue_digits(o) -> tuple:
    """(PoCD, utilization, mean wait s) as queue_line prints them."""
    return (f"{float(o.result.pocd):.4f}",
            f"{float(o.queue.utilization):.4f}",
            f"{float(o.queue.mean_wait):.2f}")


def queue_line(o) -> str:
    return "pocd {} util {} mean wait {} s".format(*queue_digits(o))


def same_bits(a: dict, b: dict, what: str) -> None:
    for name, o in a.items():
        y = b[name].result
        if not (torch.equal(o.result.job_cost, y.job_cost)
                and torch.equal(o.result.job_met, y.job_met)):
            raise AssertionError(f"{what} {name}: job_cost or job_met "
                                 f"differs between two runs")


def phase_cluster(dev, p: SimParams, budget_B: float):
    """The capacity replay on the card (phase 10b): (its JSON, the state
    `cluster_times` needs)."""
    out = {}
    # 1. the kernel against the plain version on the test cases
    t0 = time.perf_counter()
    err = max(kernel_vs_plain(*sorted_case(disc), K, dev)
              for K in DISPATCH_KS for disc in DISCIPLINES)
    out["designs"] = {str(K): ds.design_of(K) for K in DISPATCH_KS}
    print(f"dispatch_scan: bit-equal to the plain version (starts and final"
          f" pool) at K = {DISPATCH_KS}, FIFO and EDF; designs " + ", ".join(
              f"{K}: {d}" for K, d in out["designs"].items())
          + f" ({time.perf_counter() - t0:.1f} s)")
    for P in BATCH_PS:
        for K in BATCH_KS:
            batched_vs_plain(P, K, dev)
    print(f"dispatch_scan_batched: one launch bit-equal to the batched plain "
          f"version (starts and final pools) for P = {BATCH_PS} segments at "
          f"K = {BATCH_KS}")
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
    want_launches = (len(names("optimized")), 2 * len(names()))
    for k, run in enumerate(runs):
        if run[3] != want_launches:
            raise AssertionError(f"run_cluster {k + 1}: (grid-solve, "
                                 f"dispatch) launches {run[3]}, expected "
                                 f"{want_launches}")
    same_bits(outs, second, "run_cluster")
    for name, o in outs.items():
        if queue_digits(o) != PR18_AT_500[name]:
            raise AssertionError(f"run_cluster {name}: {queue_line(o)}, the "
                                 f"first kernel's digits are "
                                 f"{PR18_AT_500[name]}")
    print(f"run_cluster(Philox(0), generate(2700), slots={CLUSTER_SLOTS}): "
          f"r_min {r_min:.6f}; walls {runs[0][2]:.3f} s, {runs[1][2]:.3f} s;"
          f" launches (grid-solve, dispatch) {runs[0][3]}, {runs[1][3]}; "
          f"job_cost and job_met bit-equal over the two runs; every "
          f"strategy's PoCD, utilization and mean wait PR 18's digits")
    for name, o in outs.items():
        ref = REF_AT_500[name]
        print(f"  {name:10s} {queue_line(o)} (the JAX package, its own "
              f"draws: pocd {ref[0]}, util {ref[1]}, wait {ref[2]} s); "
              f"run_cluster_strategy first {runs[0][4][name]:.1f} ms, warm "
              f"{runs[1][4][name]:.1f} ms")
    many = [cluster_run(dev, jobs, p, slots=CLUSTER_SLOTS, reps=REPS_BIG)
            for _ in range(2)]
    for k, run in enumerate(many):
        if run[3] != want_launches:
            raise AssertionError(f"run_cluster reps={REPS_BIG} run {k + 1}: "
                                 f"(grid-solve, dispatch) launches {run[3]},"
                                 f" expected {want_launches}")
    same_bits(many[0][0], many[1][0], f"run_cluster reps={REPS_BIG}")
    print(f"run_cluster reps={REPS_BIG}: walls {many[0][2]:.3f} s, "
          f"{many[1][2]:.3f} s; launches (grid-solve, dispatch) "
          f"{many[0][3]}, {many[1][3]}; the same bits twice; " + ", ".join(
              f"{n} {float(o.result.pocd):.4f}"
              for n, o in many[0][0].items()))
    out["reps8"] = dict(
        wall_s=[r[2] for r in many], launches=list(many[0][3]),
        pocd={n: float(o.result.pocd) for n, o in many[0][0].items()},
        mean_wait={n: float(o.queue.mean_wait)
                   for n, o in many[0][0].items()})
    del many
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
    passes = []
    for rep in range(REPS_BIG):
        table, race = build_strategy_table(RepSource(Philox(0), rep), jobs,
                                           "clone", p, theta=THETA,
                                           r_min=r_min, device=dev)
        passes.append(pass_inputs(table, race, jobs, CLUSTER_SLOTS))
        del table
    for k in (0, 1):
        segments_vs_single([ps[k] for ps in passes], CLUSTER_SLOTS, dev)
    print(f"  clone, {REPS_BIG} replications: pass 1 ({T} rows) and pass 2 "
          f"({passes[0][1][0].shape[0]} rows) as {REPS_BIG} segments of one "
          f"launch each, bit-equal to {REPS_BIG} single-segment launches")
    del passes

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
    return out, dict(jobs=jobs, outs=outs, warm_wall_s=runs[1][2], big=big,
                     reps8_warm_wall_s=out["reps8"]["wall_s"][1],
                     n_steps=n_steps, steps=steps,
                     n_rows=sum(sum(v) for v in rows.values()))


class TimedCells:
    """A uniform source that passes Philox's counter-keyed draws through,
    counting the calls, the rows drawn and the host seconds spent in them
    (key derivation and the launch; the card runs on)."""

    def __init__(self, inner):
        self.inner, self.calls, self.rows, self.host_s = inner, 0, 0, 0.0

    def uniform_rows(self, strategy, rep, name, cells, rows, rest, device,
                     tag=FLEET_TAG):
        t0 = time.perf_counter()
        u = self.inner.uniform_rows(strategy, rep, name, cells, rows, rest,
                                    device, tag=tag)
        self.host_s += time.perf_counter() - t0
        self.calls += 1
        self.rows += int(u.shape[0])
        return u


def fleet_run(dev, jobs, p, **kw):
    """One fleet run_all on the card: (outs, r_min, wall s, grid-solve
    launches, peak bytes allocated above what was allocated before, the
    TimedCells source, the first grid solve's (spec, JobSpec, r_max),
    philox_rows launches, one a draw); the counts are set to 0 just
    before and read just after."""
    src, first = TimedCells(Philox(0)), []
    inner = gs.grid_solve_cuda

    def keep(spec, job, r_max):
        if not first:
            first.append((spec, job, r_max))
        return inner(spec, job, r_max)

    gs.launches = ph.launches = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gs.grid_solve_cuda = keep
    try:
        (outs, r_min), wall = synced(lambda: run_all(
            src, jobs, p, theta=THETA, block_jobs=FLEET_BLOCK, device=dev,
            **kw))
    finally:
        gs.grid_solve_cuda = inner
    if ph.launches != src.calls:
        raise AssertionError(f"fleet: {src.calls} draws but {ph.launches} "
                             f"philox_rows launches")
    return (outs, r_min, wall, gs.launches,
            torch.cuda.max_memory_allocated() - base, src, first[0],
            ph.launches)


def fleet_same_bits(a: dict, b: dict, what: str) -> None:
    for name, o in a.items():
        x, y = o.result, b[name].result
        for f in ("job_met", "job_cost", "job_completion"):
            if not torch.equal(getattr(x, f), getattr(y, f)):
                bad = int((getattr(x, f) != getattr(y, f)).sum())
                raise AssertionError(f"{what} {name}: {f} differs in {bad} "
                                     f"jobs")
        if not torch.equal(o.r_opt, b[name].r_opt):
            raise AssertionError(f"{what} {name}: r* differs")


class ReplayCheck:
    """Wraps `cluster.engine._replay` while a capacity fleet run calls
    it: every launch's pool (the width of the `free` tensor the kernel
    got) equal to the group's `slots` and at most the caller's `slots`,
    every segment's starts at or after its releases, at most the
    launch's pool in service at once, utilization in [0, 1]; records
    each launch group's segments, its pool and its steps (the largest
    segment's active units, pass 1 and pass 2). In launch group
    `hold_group` it keeps, for the segment of the window with the fewest
    tasks (padded with inactive units to the longest) and the one with
    the most (the first and the last where all have as many, as the
    replications of one window do), each pass's dispatch-ordered inputs,
    pools before and after, and the starts as the path's own launch gave
    them (`held`)."""

    def __init__(self, slots: int, hold_group=None):
        self.slots, self.inner = slots, cluster_engine._replay
        self.groups, self.pools, self.steps = [], [], [0, 0]
        self.max_busy = 0
        self.hold_group, self.held, self.held_rows = hold_group, [], None

    def __call__(self, segments, race, slots, discipline, passes):
        launch = ds.dispatch_scan_batched_cuda
        held = len(self.groups) == self.hold_group
        if held:
            tasks = [j.total_tasks for _, j in segments]
            rows = [int(np.argmin(tasks)), int(np.argmax(tasks))]
            if rows[0] == rows[1]:
                rows = [0, len(segments) - 1]
            self.held_rows = [(r, tasks[r]) for r in rows]
        widths = []

        def keep(release, hold, count, free):
            widths.append(int(free.shape[1]))
            if not held:
                return launch(release, hold, count, free)
            free0 = free.clone()
            start = launch(release, hold, count, free)
            self.held.append(tuple(x[rows] for x in (
                release, hold, count, free0, start, free)))
            return start

        ds.dispatch_scan_batched_cuda = keep
        try:
            out = self.inner(segments, race, slots, discipline, passes)
        finally:
            ds.dispatch_scan_batched_cuda = launch
        if len(widths) != passes or set(widths) != {slots} or \
                slots > self.slots:
            raise AssertionError(f"fleet replay: {passes} passes on {slots} "
                                 f"slots launched with pools {widths} "
                                 f"(caller's {self.slots})")
        self.groups.append(len(segments))
        self.pools.append(widths[0])
        prim = [int(primary_slice(t.active & t.is_primary,
                                  j.total_tasks).sum())
                for t, j in segments]
        self.steps[0] += max(prim)
        self.steps[1] += max(int(t.active.sum()) for t, _ in segments)
        for (t, j), (realized, rel, st) in zip(segments, out):
            act = t.active
            if bool((st[act] < rel[act]).any()):
                raise AssertionError("fleet replay: a unit starts before "
                                     "its release")
            busy = max_in_service(st, predicted_holds(t, race,
                                                      j.total_tasks), act)
            util = float(realized.busy_time / (slots * realized.span))
            if busy > widths[0] or not 0.0 <= util <= 1.0 + 1e-6:
                raise AssertionError(f"fleet replay: {busy} units in "
                                     f"service on {widths[0]} slots, "
                                     f"utilization {util}")
            self.max_busy = max(self.max_busy, busy)
        return out


def held_vs_plain(held) -> dict:
    """Each held launch's rows (ReplayCheck.held, one entry a pass)
    against the batched plain version on the CPU over the same inputs:
    starts over every row and final pools bit-equal. Returns the rows,
    the pool the launch got, steps, the largest |start - plain start|
    (0 where both are equal, inactive rows' +inf included) and the plain
    version's seconds."""
    t0, shape, steps, err = time.perf_counter(), [], [], 0.0
    for k, (rel, hold, count, free0, start, free) in enumerate(held):
        pool = free0.cpu()
        want = ds.dispatch_scan_batched_plain(rel.cpu(), hold.cpu(),
                                              count.cpu(), pool)
        got = start.cpu()
        diff = torch.where(got == want, 0.0, (got - want).abs())
        err = max(err, float(diff.max()))
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"fleet dispatch pass {k + 1}: {bad} "
                                 f"starts differ from the plain version")
        if not torch.equal(free.cpu(), pool):
            raise AssertionError(f"fleet dispatch pass {k + 1}: final "
                                 f"pools differ from the plain version")
        shape.append(int(rel.shape[1]))
        steps.append(count.tolist())
    return dict(rows=shape, pool=int(held[0][3].shape[1]), steps=steps,
                max_abs_err=err, plain_s=time.perf_counter() - t0)


def fleet_cluster_run(dev, jobs, p, cap: int = cluster_engine.MAX_SEGMENTS,
                      check: bool = False, hold_group=None):
    """One windowed run_cluster on the card with at most `cap` segments a
    dispatch launch: (outs, r_min, wall s, (grid-solve, dispatch)
    launches, the ReplayCheck or None)."""
    chk = ReplayCheck(CLUSTER_SLOTS, hold_group) if check else None
    saved = cluster_engine.MAX_SEGMENTS, cluster_engine._replay
    cluster_engine.MAX_SEGMENTS = cap
    if chk is not None:
        cluster_engine._replay = chk
    try:
        gs.launches = ds.launches = 0
        (outs, r_min), wall = synced(lambda: run_cluster(
            Philox(0), jobs, p, theta=THETA, slots=CLUSTER_SLOTS,
            reps=REPS_BIG, chunk_jobs=FLEET_WINDOW, device=dev))
        launches = (gs.launches, ds.launches)
    finally:
        cluster_engine.MAX_SEGMENTS, cluster_engine._replay = saved
    return outs, r_min, wall, launches, chk


def cluster_same_bits(a: dict, b: dict, what: str) -> None:
    fleet_same_bits(a, b, what)
    for name, o in a.items():
        for f in ("mean_wait", "max_wait", "utilization", "preempted"):
            if not torch.equal(getattr(o.queue, f),
                               getattr(b[name].queue, f)):
                raise AssertionError(f"{what} {name}: queue {f} differs")


def pocd_se(met: torch.Tensor, reps: int) -> float:
    """Monte-Carlo standard error of a PoCD from per-job met frequencies:
    sqrt(sum m (1 - m) / (reps - 1)) / J."""
    m = met.double()
    return float(torch.sqrt((m * (1 - m)).sum() / (reps - 1))) / m.numel()


def phase_fleet(dev, p: SimParams):
    """The fleet layer on the card (phase 10c): (its JSON, the runs that
    phases 10e and 10f are held against)."""
    out = {}
    # 1. the flat fleet streamed over 100,000 paper-hadoop jobs
    t_flat = time.perf_counter()
    tr, synth_s = synced(lambda: make_trace("paper-hadoop",
                                            n_jobs=FLEET_JOBS, device=dev))
    T = int(tr.n_tasks.astype(np.int64).sum())
    counts = fleet_blocks.block_task_counts(tr.n_tasks, FLEET_BLOCK)
    Tb = int(counts.max())
    draw_bytes = T * 9 * 4
    print(f"fleet: paper-hadoop at {FLEET_JOBS} jobs, {T} tasks "
          f"(synthesized in {synth_s:.2f} s); blocks of {FLEET_BLOCK}: "
          f"{counts.shape[0]}, Tb {Tb} against {counts.mean():.1f} tasks "
          f"in the mean block; the whole task axis's (T, 9) f32 draw "
          f"{draw_bytes / 2**30:.3f} GiB")
    runs, draws = {}, {}
    for label, kw in (("monolithic", dict(devices=1)),
                      ("chunked", dict(chunk_jobs=FLEET_CHUNK))):
        first = fleet_run(dev, tr, p, **kw)
        warm = fleet_run(dev, tr, p, **kw)
        draws[label] = dict(calls=warm[5].calls, rows=warm[5].rows,
                            host_s=warm[5].host_s, launches=warm[7])
        fleet_same_bits(first[0], warm[0], f"fleet {label} twice")
        runs[label] = (first, warm)
        print(f"  {label}: wall first {first[2]:.3f} s, warm {warm[2]:.3f}"
              f" s (PR 20: {PR20_FLEET[label]['wall_s']} s); peak "
              f"{first[4] / 2**30:.3f} / {warm[4] / 2**30:.3f} GiB"
              f" above the phase's base; grid-solve launches {first[3]}; "
              f"{draws[label]['calls']} uniform_rows draws (warm), "
              f"{draws[label]['launches']} philox_rows launches, "
              f"{draws[label]['rows']} rows, "
              f"{1e3 * draws[label]['host_s']:.1f} ms of host time in them "
              f"(PR 20: {PR20_FLEET['cells']} cells, "
              f"{PR20_FLEET[label]['draw_host_s']} s); r_min "
              f"{first[1]:.6f}; the same bits twice")
    mono, chunked = runs["monolithic"][0], runs["chunked"][0]
    fleet_same_bits(chunked[0], mono[0], "fleet chunked vs monolithic")
    n_chunks = -(-FLEET_JOBS // FLEET_CHUNK)
    want = len(names("optimized"))
    if (mono[3], chunked[3]) != (want, want * n_chunks):
        raise AssertionError(f"fleet grid-solve launches {mono[3]}, "
                             f"{chunked[3]}; expected {want}, "
                             f"{want * n_chunks}")
    peak = max(r[4] for r in runs["chunked"])
    if peak >= draw_bytes:
        raise AssertionError(f"fleet chunked peak {peak} bytes is not below "
                             f"the whole (T, 9) draw's {draw_bytes}")
    print(f"  chunks of {FLEET_CHUNK} jobs ({n_chunks} chunks) give the "
          f"monolithic run's job_met, job_cost, job_completion and r* bits "
          f"for all {len(mono[0])} strategies; chunked peak "
          f"{peak / 2**30:.3f} GiB < {draw_bytes / 2**30:.3f} GiB")
    # the grid-solve kernel on the fleet's own inputs: each run's first
    # solve (its first optimized strategy, the whole trace or chunk 0)
    grid_err = {}
    for label, r in (("monolithic", mono), ("chunked", chunked)):
        spec, job, r_max = r[6]
        J = int(job.t_min.shape[0])
        errs = check_grid(spec, job, r_max, f"fleet {label} J={J}")
        grid_err[label] = dict(strategy=spec.name, J=J, r_max=r_max,
                               max_abs_err=max(errs))
        print(f"  grid_solve[{spec.name}] on the {label} run's first solve "
              f"(J={J}, r_max={r_max}): equal r*/choice/sat to the plain "
              f"version; max abs err u {errs[0]:.3g} pocd {errs[1]:.3g} "
              f"cost {errs[2]:.3g}")
    for name, o in chunked[0].items():
        print(f"    {name:10s} pocd {float(o.result.pocd):.6f} mean_cost "
              f"{float(o.result.mean_cost):.4f} sum_r {int(o.r_opt.sum())}")
    one = lambda: run_fleet_strategy(
        Philox(0), tr, "sresume", p, theta=THETA, r_min=chunked[1],
        block_jobs=FLEET_BLOCK, chunk_jobs=FLEET_CHUNK, device=dev)
    prof = phase_profile(one, "fleet sresume chunked", synced(one)[1])
    print(f"  chunked sresume idle share {prof['idle_share']:.3f} (PR 20: "
          f"{PR20_FLEET['idle_share']})")
    t_flat = time.perf_counter() - t_flat
    print(f"  flat fleet part: {t_flat:.1f} s")
    out["flat"] = dict(
        phase_s=t_flat, jobs=FLEET_JOBS, tasks=T, Tb=Tb,
        chunk_tasks=int(tr.n_tasks[:FLEET_CHUNK].astype(np.int64).sum()),
        mean_block_tasks=float(counts.mean()), chunk_jobs=FLEET_CHUNK,
        n_chunks=n_chunks,
        draw_bytes=draw_bytes,
        wall_s={k: [r[2] for r in v] for k, v in runs.items()},
        peak_bytes={k: [r[4] for r in v] for k, v in runs.items()},
        grid_solve_launches={k: v[0][3] for k, v in runs.items()},
        draws=draws, profile_sresume_chunked=prof,
        grid_solve_vs_plain=grid_err,
        pocd={n: float(o.result.pocd) for n, o in chunked[0].items()})
    # what phases 10e and 10f hold their runs against
    state = dict(trace=tr, chunked=(chunked[0], chunked[1]),
                 n_chunks=n_chunks,
                 chunked_launches=(chunked[3], chunked[7]),
                 chunked_warm_s=runs["chunked"][1][2])
    del runs, mono, chunked

    # 2. the flat fleet against run_all on the paper trace at reps 8
    t_vs = time.perf_counter()
    jobs = generate(2700, seed=0, device=dev)
    legacy, r_leg = run_all(Philox(0), jobs, p, theta=THETA, reps=REPS_BIG,
                            device=dev)
    fleet, r_fl = run_all(Philox(0), jobs, p, theta=THETA, reps=REPS_BIG,
                          devices=1, block_jobs=FLEET_BLOCK, device=dev)
    worst = 0.0
    for name, lg in legacy.items():
        pinned = run_fleet_strategy(Philox(0), jobs, name, p, theta=THETA,
                                    r_min=0.0 if name == "hadoop_ns"
                                    else r_leg, reps=REPS_BIG,
                                    block_jobs=FLEET_BLOCK, device=dev)
        if not torch.equal(pinned.r_opt, lg.r_opt):
            raise AssertionError(f"fleet {name}: r* differs from run_all's "
                                 f"at run_all's R_min")
        fl = fleet[name]
        se = math.hypot(pocd_se(fl.result.job_met, REPS_BIG),
                        pocd_se(lg.result.job_met, REPS_BIG))
        gap = abs(float(fl.result.pocd) - float(lg.result.pocd))
        if gap > FLEET_SIGMAS * se + 1.0 / (jobs.n_jobs * REPS_BIG):
            raise AssertionError(f"fleet {name}: pocd {float(fl.result.pocd)}"
                                 f" vs run_all's {float(lg.result.pocd)}, "
                                 f"{gap / se:.2f} standard errors")
        worst = max(worst, gap / se if se else 0.0)
        print(f"  fleet vs run_all reps {REPS_BIG} {name:10s} pocd "
              f"{float(fl.result.pocd):.6f} vs {float(lg.result.pocd):.6f} "
              f"({gap / se if se else 0.0:.2f} se); r* equal at run_all's "
              f"R_min")
    t_vs = time.perf_counter() - t_vs
    print(f"  fleet against run_all: {t_vs:.1f} s")
    out["vs_run_all"] = dict(r_min=[r_fl, r_leg], worst_se=worst,
                             phase_s=t_vs)
    del legacy, fleet

    # 3. the capacity replay in windows: one launch for every (window,
    # replication) against one launch a window
    windows = -(-jobs.n_jobs // FLEET_WINDOW)
    t_cap = time.perf_counter()
    run_order = ["hadoop_ns"] + [n for n in names() if n != "hadoop_ns"]
    hold = run_order.index("sresume")
    first = fleet_cluster_run(dev, jobs, p, check=True,   # wall: checked
                              hold_group=hold)
    warm = fleet_cluster_run(dev, jobs, p)
    per_window = fleet_cluster_run(dev, jobs, p, cap=REPS_BIG)
    cluster_same_bits(first[0], warm[0], "fleet run_cluster twice")
    cluster_same_bits(first[0], per_window[0],
                      "fleet run_cluster batched vs per window")
    want = (len(names("optimized")) * windows, 2 * len(names()))
    per_w = (want[0], want[1] * windows)
    if first[3] != want or per_window[3] != per_w:
        raise AssertionError(f"fleet run_cluster launches {first[3]}, "
                             f"{per_window[3]}; expected {want}, {per_w}")
    chk = first[4]
    segs = windows * REPS_BIG
    if set(chk.groups) != {segs}:
        raise AssertionError(f"fleet run_cluster segments a launch "
                             f"{chk.groups}, expected {segs}")
    if len(chk.held) != 2:
        raise AssertionError(f"fleet sresume: {len(chk.held)} dispatch "
                             f"launches held, expected 2")
    held = held_vs_plain(chk.held)
    held.update(strategy="sresume", segments=[
        dict(segment=r, window=r // REPS_BIG, rep=r % REPS_BIG, tasks=t)
        for r, t in chk.held_rows])
    print(f"  sresume's two launches ({segs} segments each): segments "
          + " and ".join(f"{v['segment']} (window {v['window']}, "
                         f"{v['tasks']} tasks)" for v in held["segments"])
          + f", rows {held['rows']} a pass (the first padded), steps "
          f"{held['steps']}: starts and final pools as the path's launch "
          f"gave them equal the plain version's on the CPU "
          f"({held['plain_s']:.1f} s)")
    steps = sum(chk.steps)
    cprof, each = profiled_launches(lambda: fleet_cluster_run(dev, jobs, p),
                                    "fleet run_cluster", warm[2], want[1])
    each_w = timed_launches(lambda: fleet_cluster_run(dev, jobs, p,
                                                      cap=REPS_BIG),
                            per_w[1])
    kernel_ms, kernel_ms_w = sum(each), sum(each_w)
    ns_step = 1e6 * kernel_ms / steps
    print(f"  run_cluster(slots={CLUSTER_SLOTS}, reps={REPS_BIG}, "
          f"chunk_jobs={FLEET_WINDOW}): {windows} windows, {segs} segments "
          f"a launch ({segs} of the card's SMs); walls first (with the "
          f"checks) {first[2]:.3f} s, warm {warm[2]:.3f} s, one launch a "
          f"window "
          f"{per_window[2]:.3f} s; launches (grid-solve, dispatch) "
          f"{first[3]}, one a window {per_window[3]}; bit-equal; start >= "
          f"release, at most {chk.max_busy} of {CLUSTER_SLOTS} slots held "
          f"in any window, utilization in [0, 1]; dispatch kernel "
          f"{kernel_ms:.1f} ms a run (one a window {kernel_ms_w:.1f} ms; "
          f"CUDA events) over {steps} steps of the longest segments, "
          f"{ns_step:.1f} ns a step")
    for name, o in first[0].items():
        print(f"    {name:10s} {queue_line(o)}")
    # the windows share their replications' streams (as in the reference)
    j0 = fleet_runner.chunk_jobset(fleet_runner.job_columns(jobs), 0,
                                   FLEET_WINDOW, device=dev)
    j1 = fleet_runner.chunk_jobset(fleet_runner.job_columns(jobs),
                                   FLEET_WINDOW, 2 * FLEET_WINDOW,
                                   device=dev)
    n = min(j0.total_tasks, j1.total_tasks)
    u0, u1 = (Philox(0).uniform_cell("clone", 0, None, "key",
                                     (j.total_tasks, 9), dev)[:n]
              for j in (j0, j1))
    same_rows = int((u0 == u1).all(dim=1).sum())
    print(f"  windows 0 and 1 ({j0.total_tasks} and {j1.total_tasks} "
          f"tasks): {same_rows} of their first {n} rows of clone's draw "
          f"coincide under Philox")
    t_cap = time.perf_counter() - t_cap
    print(f"  capacity fleet part: {t_cap:.1f} s")
    out["capacity"] = dict(
        phase_s=t_cap, windows=windows, window_jobs=FLEET_WINDOW,
        reps=REPS_BIG,
        segments_per_launch=segs,
        wall_s=dict(first=first[2], warm=warm[2], per_window=per_window[2]),
        launches=list(first[3]), launches_per_window=list(per_window[3]),
        kernel_ms=kernel_ms, kernel_ms_per_window_launches=kernel_ms_w,
        each_ms=each, profiler_launches_recorded=cprof[
            "dispatch_scan_launches"],
        steps_longest_segments=steps, ns_per_step=ns_step,
        max_in_service=chk.max_busy, profile=cprof,
        dispatch_vs_plain=held, window_rows_coinciding=[same_rows, n],
        per_strategy={n_: dict(pocd=float(o.result.pocd),
                               utilization=float(o.queue.utilization),
                               mean_wait=float(o.queue.mean_wait))
                      for n_, o in first[0].items()})
    state.update(jobs=jobs, windowed=(first[0], first[1]),
                 windowed_launches=first[3], windowed_kernel_ms=kernel_ms,
                 windowed_kernel_ms_per_window=kernel_ms_w,
                 windowed_warm_s=warm[2])
    return out, state


def phase_philox_check(dev) -> dict:
    """The draw kernel against its plain version run on the CPU, bit for
    bit: cells >= 2^32 and negative, rows up to 2^24, every column count
    of PHILOX_COLS, all three draw names, both tags; and the raw
    generator's known-answer vectors."""
    rng = np.random.default_rng(0)
    n = PHILOX_CHECK_ROWS
    cells = torch.from_numpy(np.concatenate([
        rng.integers(2**32, 2**44, n // 2),
        rng.integers(-2**31, 2**32, n - n // 2)]))
    rows = torch.from_numpy(rng.integers(0, 2**24 + 1, n))
    rows[:2] = torch.tensor([0, 2**24])
    src, cases = Philox(0), 0
    for cols in PHILOX_COLS:
        for tag in (FLEET_TAG, SERVE_TAG):
            for name in DRAW_NAMES:
                want = src.uniform_rows("adaptive", 1, name, cells, rows,
                                        (cols,), "cpu", tag=tag)
                got = src.uniform_rows("adaptive", 1, name, cells.to(dev),
                                       rows.to(dev), (cols,), dev,
                                       tag=tag).cpu()
                if not torch.equal(got, want):
                    bad = int((got != want).sum())
                    raise AssertionError(f"philox_rows: {bad} values differ "
                                         f"from the plain version (cols "
                                         f"{cols}, tag {tag:#x}, {name})")
                cases += 1
    ctr = np.asarray([c for c, _, _ in PHILOX_KAT], np.uint32)
    key = np.asarray([k for _, k, _ in PHILOX_KAT], np.uint32)
    words = ph.philox_raw_cuda(ctr, key)
    got = [tuple(int(x) for x in w) for w in words]
    if got != [w for _, _, w in PHILOX_KAT]:
        raise AssertionError(f"philox: known-answer vectors {got}")
    print(f"philox_rows: bit-equal to the plain version on the CPU in "
          f"{cases} cases ({n} rows each: cells past 2^32 and negative, "
          f"rows up to 2^24; cols {PHILOX_COLS}; three draw names, two "
          f"tags); the raw generator gives the three Philox4x32-10 "
          f"known answers")
    return dict(cases=cases, rows=n, cols=list(PHILOX_COLS),
                max_abs_err=0.0, known_answers=len(PHILOX_KAT))


def event_ms(fn, iters: int) -> float:
    """Median device time of one fn() between CUDA events recorded just
    before and after it, over `iters` back-to-back calls: the kernel's
    time where it is long beside the host's enqueue."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def philox_times(dev, shapes: dict) -> dict:
    """Kernel ms (the profiler at the serving window; CUDA events around
    each launch, `event_ms`, at the fleet's shapes, where the profiler
    drops records of a few long launches), wrapper call ms and plain ms
    (CUDA events),
    the bytes bound (16 bytes of coordinates a row read, 4 a value
    written) and torch.rand of the same shape (a yardstick, not the same
    function) at each {label: (rows, cols)}; the plain version only where
    its int64 temporaries fit, held equal to the kernel there."""
    key = Philox(0).rows_key("sresume", 0, "k2", FLEET_TAG)
    out = {}
    for label, (T, cols) in shapes.items():
        idx = torch.arange(T, device=dev)
        cells, rows = idx // 512, idx % 512
        fn = lambda: ph.philox_rows_cuda(cells, rows, cols, key)
        small = T < 100_000
        iters = 200 if small else 20
        k = kernel_ms(fn, iters, "philox_rows") if small else event_ms(
            fn, iters)
        call = cuda_ms(fn, iters)
        rand = cuda_ms(lambda: torch.rand((T, cols), device=dev), iters)
        plain = None
        if T <= 4_000_000:
            plain_fn = lambda: ph.philox_rows_plain(cells, rows, cols, key)
            if not torch.equal(plain_fn(), fn()):
                raise AssertionError(f"philox_rows at {label}: kernel and "
                                     f"plain version differ")
            plain = cuda_ms(plain_fn, 3)
        nbytes = 4 * T * cols + 16 * T
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        out[label] = dict(rows=T, cols=cols, ms=k, call_ms=call,
                          plain_ms=plain, bound_ms=bound, bytes=nbytes,
                          rand_ms=rand, bound_share=bound / k)
        print(f"  philox_rows at {label} ({T} x {cols}): kernel {k:.5f} ms, "
              f"call {call:.5f} ms, plain "
              + ("not measured" if plain is None else f"{plain:.4f} ms")
              + f"; bound {bound:.5f} ms (bytes, {nbytes} B; "
              f"{100 * bound / k:.1f}% of it); torch.rand of the shape "
              f"{rand:.5f} ms (yardstick)")
    return out


def serve_run(dev, reqs, p, **kw) -> dict:
    """One run_serve on the card with every count set to 0 just before
    and read just after: outputs, wall, grid-solve and philox_rows
    launches, windows served, draws and their host seconds."""
    src, inner, windows = TimedCells(Philox(0)), serve_loop.serve_window, [0]
    window = kw.pop("window", SERVING["window"])

    def counted(*a, **k):
        windows[0] += 1
        return inner(*a, **k)

    gs.launches = ph.launches = 0
    serve_loop.serve_window = counted
    try:
        (outs, r_min), wall = synced(lambda: run_serve(
            src, reqs, p, window=window, device=dev, **kw))
    finally:
        serve_loop.serve_window = inner
    if ph.launches != src.calls:
        raise AssertionError(f"serve: {src.calls} draws but {ph.launches} "
                             f"philox_rows launches")
    return dict(outs=outs, r_min=r_min, wall=wall, grid=gs.launches,
                philox=ph.launches, windows=windows[0], draws=src.calls,
                draw_host_s=src.host_s, rows=src.rows)


def serve_same_bits(a: dict, b: dict, what: str, lo=None, hi=None) -> None:
    for name, o in a.items():
        for f in ("job_met", "job_completion", "job_cost"):
            x = getattr(o.result, f)
            y = getattr(b[name].result, f)
            y = y if lo is None else y[lo:hi]
            if x.shape != y.shape or not torch.equal(x, y):
                raise AssertionError(f"{what} {name}: {f} differs")


def serve_vs_cpu(dev, reqs, p, r_min: float) -> dict:
    """The first SERVING["check"] requests, every strategy: the known-tail
    solve's grid-solve launch against its plain version (check_grid), and
    the windows served on the card against the same windows on the CPU
    (plain versions) with the card's r* and choice: completion and
    machine time within f32 rtol 1e-5 (pow's last bits), met equal but
    deadline ties (counted)."""
    sub = reqs.slice(0, SERVING["check"])
    d, h = sub.to(dev), sub.to("cpu")
    n = sub.n_requests
    D = h.D.numpy()
    ties, worst = {}, 0.0
    for name in names():
        rm = 0.0 if name == "hadoop_ns" else r_min
        if get(name).optimized:
            specs = serve_loop._epoch_jobspecs(d.t_min, d.beta, d, p, 1e-3,
                                               rm, n)
            check_grid(get(name), specs, 9, f"serve {name} J={n}")
            r, ch = serve_loop._solve_epoch(name, d.t_min, d.beta, d, p,
                                            1e-3, rm, 8, n)
        else:
            r = ch = torch.zeros(n, dtype=torch.int32, device=dev)
        kw = dict(strategy=name, p=p, max_r=8, oracle=True,
                  window=SERVING["window"])
        card = serve_loop._serve_chunk(Philox(0), name, d, r, ch, **kw)
        host = serve_loop._serve_chunk(Philox(0), name, h, r.cpu(),
                                       ch.cpu(), **kw)
        for a, b, what in zip(card, host, ("completion", "machine")):
            a = a.cpu().numpy()
            b = b.numpy()
            rel = np.abs(a - b) / np.abs(b)
            if not (rel <= 1e-5).all():
                raise AssertionError(f"serve {name}: {what} on the card "
                                     f"off the CPU's by {rel.max():.3g}")
            worst = max(worst, float(rel.max()))
        cm, hm = card[0].cpu().numpy() <= D, host[0].numpy() <= D
        tie = np.abs(host[0].numpy() - D) <= 1e-5 * D
        if ((cm != hm) & ~tie).any():
            raise AssertionError(f"serve {name}: met differs off a "
                                 f"deadline tie")
        ties[name] = int((cm != hm).sum())
    print(f"  serve on the card vs the CPU ({n} requests, every strategy, "
          f"the card's r*): completion and machine within rtol "
          f"{worst:.3g} (<= 1e-5); met flips at deadline ties {ties}; the "
          f"grid solve equal to its plain version on each known-tail solve")
    return dict(requests=n, max_rel_err=worst, deadline_ties=ties)


def phase_serving(dev, p: SimParams):
    """Hedged online serving on the card (phase 10d): (its JSON, the
    known-tail run that phase 10f is held against)."""
    t_phase = time.perf_counter()
    reqs, synth_s = synced(lambda: make_requests(SERVING["scenario"],
                                                 device=dev))
    n = reqs.n_requests
    if n != get_scenario(SERVING["scenario"]).n_jobs:
        raise AssertionError(f"serve: {n} requests, not the registry's")
    print(f"serving: {SERVING['scenario']} at {n} requests (synthesized in "
          f"{synth_s:.2f} s), {len(names())} strategies, window "
          f"{SERVING['window']}")
    out = {"requests": n}
    regimes = (("known_tail", {}),
               ("online", dict(refit_every=SERVING["refit_every"],
                               probe_every=SERVING["probe_every"])))
    for regime, kw in regimes:
        first = serve_run(dev, reqs, p, **kw)
        warm = serve_run(dev, reqs, p, **kw)
        serve_same_bits(first["outs"], warm["outs"], f"serve {regime} twice")
        wide = serve_run(dev, reqs, p, window=SERVING["wide"], **kw)
        serve_same_bits(wide["outs"], first["outs"],
                        f"serve {regime} window {SERVING['wide']}")
        outs = first["outs"]
        for name, o in outs.items():
            res = o.result
            if (res.job_completion.shape != (n,)
                    or not bool(torch.isfinite(res.job_completion).all())
                    or not bool(torch.isfinite(res.job_cost).all())
                    or not 0.0 <= float(res.pocd) <= 1.0):
                raise AssertionError(f"serve {regime} {name}: columns not "
                                     f"finite or of shape ({n},)")
        base = float(outs["hadoop_ns"].result.pocd)
        for name in ("sresume", "adaptive"):
            if not float(outs[name].result.pocd) > base:
                raise AssertionError(f"serve {regime}: {name} PoCD not above "
                                     f"hadoop_ns's {base}")
        optimized = names("optimized")
        if regime == "known_tail":
            want = len(optimized)
        else:
            want = (len(names("chronos")) * sum(o.n_refits
                                                for o in outs.values())
                    + sum(sum(e != "hadoop_ns" for e in o.epoch_strategies)
                          for s_, o in outs.items() if s_ in optimized))
        if first["grid"] != want or warm["grid"] != want:
            raise AssertionError(f"serve {regime}: grid-solve launches "
                                 f"{first['grid']}, {warm['grid']}; expected "
                                 f"{want}")
        if first["philox"] == 0:
            raise AssertionError(f"serve {regime}: no philox_rows launch")
        if regime == "known_tail":
            state = dict(reqs=reqs, known_tail=outs)
            lo, hi = SERVING["slice"]
            part = {name: serve_trace(
                Philox(0), reqs.slice(lo, hi), p, strategy=name,
                r_min=0.0 if name == "hadoop_ns" else first["r_min"],
                window=SERVING["window"], device=dev) for name in outs}
            serve_same_bits(part, outs, f"serve slice [{lo}, {hi})", lo, hi)
            check = serve_vs_cpu(dev, reqs, p, first["r_min"])
        one = lambda: serve_trace(
            Philox(0), reqs, p, strategy="sresume", r_min=first["r_min"],
            window=SERVING["window"], device=dev, **kw)
        prof = phase_profile(one, f"serve_trace sresume {regime}",
                             synced(one)[1])
        rate = len(outs) * n / warm["wall"]
        print(f"  {regime}: r_min {first['r_min']:.6f}; wall first "
              f"{first['wall']:.3f} s, warm {warm['wall']:.3f} s = "
              f"{rate:.0f} requests/s over {len(outs)} strategies; "
              f"{warm['windows']} windows, {warm['philox']} philox_rows "
              f"launches ({warm['philox'] / warm['windows']:.2f} a window), "
              f"{1e3 * warm['draw_host_s'] / warm['windows']:.4f} ms of "
              f"draw host time a window; grid-solve launches "
              f"{warm['grid']}; window {SERVING['wide']} and two warm runs "
              f"bit-equal"
              + (f"; the slice [{SERVING['slice'][0]}, "
                 f"{SERVING['slice'][1]}) served alone bit-equal to the "
                 f"full run's rows" if regime == "known_tail" else ""))
        for name, o in outs.items():
            lat = o.latency
            print(f"    {name:10s} pocd {float(o.result.pocd):.6f} mean_cost "
                  f"{float(o.result.mean_cost):.5f} utility "
                  f"{o.utility:.6f} p50 {lat['p50']:.4f} p95 "
                  f"{lat['p95']:.4f} p99 {lat['p99']:.4f} mean_r "
                  f"{o.mean_r:.4f} probes {o.n_probes} refits {o.n_refits}")
        out[regime] = dict(
            r_min=first["r_min"], wall_s=dict(first=first["wall"],
                                              warm=warm["wall"],
                                              wide=wide["wall"]),
            requests_per_s=rate, windows=warm["windows"],
            philox_launches=warm["philox"], draws=warm["draws"],
            draw_rows=warm["rows"], draw_host_ms=1e3 * warm["draw_host_s"],
            grid_solve_launches=warm["grid"], profile_sresume=prof,
            per_strategy={name: dict(
                pocd=float(o.result.pocd),
                mean_cost=float(o.result.mean_cost), utility=o.utility,
                latency=o.latency, mean_r=o.mean_r, probes=o.n_probes,
                refits=o.n_refits) for name, o in outs.items()},
            first_launches=dict(grid_solve=first["grid"],
                                philox_rows=first["philox"]))
    out["vs_cpu"] = check
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  serving phase: {out['phase_s']:.1f} s")
    return out, state


class Recorded:
    """Inside the block, every ChaosContext a run builds (one a strategy,
    in run_all_fleet and run_cluster_fleet) is kept in `contexts`, and
    built with backoff 0: the retries' sleeps are a policy, not the
    path's cost."""

    def __enter__(self):
        self.inner, self.contexts = chaos_inject.ChaosContext, []
        outer = self

        class Kept(self.inner):
            def __init__(self, plan, **kw):
                kw.setdefault("backoff_base", 0.0)
                super().__init__(plan, **kw)
                outer.contexts.append(self)

        chaos_inject.ChaosContext = Kept
        return self

    def __exit__(self, *exc):
        chaos_inject.ChaosContext = self.inner


class Counted:
    """Inside the block, calls of `module.name` are counted and timed on
    the host (`calls`, `seconds`), and `found` counts true results."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name

    def __enter__(self):
        self.inner = getattr(self.module, self.name)
        self.calls, self.found, self.seconds = 0, 0, 0.0

        def counted(*a, **k):
            t0 = time.perf_counter()
            out = self.inner(*a, **k)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            self.found += out is True
            return out

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


def chaos_run(dev, jobs, p, runner=run_all, **kw):
    """One run on the card under `Recorded` and the integrity check's
    `Counted`, with the grid-solve, draw and dispatch counts set to 0
    just before and read just after: (outs, r_min, wall s, (grid_solve,
    philox_rows, dispatch_scan) launches, contexts, checks, dispatch
    kernel ms by CUDA events)."""
    gs.launches = ph.launches = ds.launches = 0
    with Recorded() as rec, Counted(chaos_inject, "_has_nan") as chk, \
            LaunchTimes() as lt:
        (outs, r_min), wall = synced(lambda: runner(
            Philox(0), jobs, p, theta=THETA, device=dev, **kw))
    return (outs, r_min, wall, (gs.launches, ph.launches, ds.launches),
            rec.contexts, chk, sum(lt.ms()))


def check_records(contexts, want: list, what: str) -> None:
    """Every strategy's audit log, as (chunk, kind, detail) with the
    detail cut at its first space, equals `want`."""
    for ctx in contexts:
        got = [(c, k, d.split(" ")[0]) for c, k, d in ctx.records]
        if got != want:
            raise AssertionError(f"{what}: records {ctx.records}, expected "
                                 f"{want}")


def resume_until_done(call, limit: int):
    """call() again while it ends in SimulatedCrash, as an operator's
    restart loop: (its result, the chunks of the crashes, host s)."""
    crashes, t0 = [], time.perf_counter()
    while True:
        try:
            out = call()
            break
        except SimulatedCrash as err:
            crashes.append(err.chunk)
        if len(crashes) > limit:
            raise AssertionError(f"{len(crashes)} crashes: no progress")
    torch.cuda.synchronize()
    return out, crashes, time.perf_counter() - t0


CHAOS_CHILD = r"""
import json, sys, time
import torch
from repro_torch import Philox, SimParams, run_all
from repro_torch.chaos import FaultEvent, FaultPlan, SimulatedCrash
from repro_torch.kernels import grid_solve as gs, philox as ph
from repro_torch.workloads import make_trace
a = json.loads(sys.argv[1])
tr = make_trace("paper-hadoop", n_jobs=a["jobs"], device="cuda")
plan = FaultPlan(events=(FaultEvent("crash", a["crash"]),))
gs.launches = ph.launches = 0
torch.cuda.synchronize()
t0 = time.perf_counter()
try:
    run_all(Philox(0), tr, SimParams(), theta=a["theta"],
            block_jobs=a["block"], chunk_jobs=a["chunk"], chaos=plan,
            checkpoint=a["dir"], device="cuda")
    outcome = ["finished", None]
except SimulatedCrash as err:
    outcome = ["crash", err.chunk]
torch.cuda.synchronize()
print(json.dumps(dict(
    outcome=outcome, wall_s=time.perf_counter() - t0, grid=gs.launches,
    philox=ph.launches,
    foreign=sorted({"jax", "repro"} & set(sys.modules)))))
"""


def chaos_child(directory: str) -> dict:
    """The crash run (phase 10e b) in a fresh Python process that imports
    repro_torch only: its JSON line, plus the process's wall."""
    args = json.dumps(dict(jobs=FLEET_JOBS, crash=CHAOS_CRASH, theta=THETA,
                           block=FLEET_BLOCK, chunk=FLEET_CHUNK,
                           dir=directory))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c", CHAOS_CHILD, args], capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    if res.returncode != 0:
        raise AssertionError(f"chaos child exited {res.returncode}: "
                             f"{res.stderr[-2000:]}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    out["process_s"] = time.perf_counter() - t0
    return out


def dir_bytes(directory) -> int:
    return sum(f.stat().st_size for f in Path(directory).rglob("*")
               if f.is_file())


def phase_chaos(dev, p: SimParams, st: dict) -> dict:
    """Fault injection, checkpoints and resume on the card (phase 10e);
    the JSON keeps (a)'s outputs under "faulted" for phase 10f."""
    t_phase = time.perf_counter()
    tr, (want, r_want) = st["trace"], st["chunked"]
    n_chunks = st["n_chunks"]
    g_want, d_want = st["chunked_launches"]
    kw = dict(block_jobs=FLEET_BLOCK, chunk_jobs=FLEET_CHUNK)
    out = {}

    # (a) faults that change nothing
    plan = FaultPlan(events=tuple(FaultEvent(*e) for e in CHAOS_FAULTS))
    per_chunk = d_want // n_chunks
    predicted = (g_want, d_want + per_chunk)
    faulted = chaos_run(dev, tr, p, chaos=plan, **kw)
    fleet_same_bits(faulted[0], want, "chaos (a) vs phase 10c chunked")
    if faulted[1] != r_want:
        raise AssertionError(f"chaos (a): r_min {faulted[1]} != {r_want}")
    if faulted[3][:2] != predicted:
        raise AssertionError(f"chaos (a): (grid_solve, philox_rows) "
                             f"launches {faulted[3][:2]}, predicted "
                             f"{predicted}")
    check_records(faulted[4], [
        (1, "retry", "attempt=1"), (1, "retry", "attempt=2"),
        (2, "device_loss", "ignored:"), (4, "corrupt", "attempt=0"),
        (4, "retry", "attempt=1")], "chaos (a)")
    n_s = len(faulted[4])
    chk = faulted[5]
    if (chk.calls, chk.found) != ((n_chunks + 1) * n_s, n_s):
        raise AssertionError(f"chaos (a): {chk.calls} integrity checks, "
                             f"{chk.found} with NaN")
    empty = chaos_run(dev, tr, p, chaos=EMPTY_PLAN, **kw)
    fleet_same_bits(empty[0], want, "chaos EMPTY_PLAN vs phase 10c chunked")
    echk = empty[5]
    if (echk.calls, echk.found) != (n_chunks * n_s, 0) or any(
            c.records for c in empty[4]) or empty[3][:2] != (g_want,
                                                             d_want):
        raise AssertionError(f"chaos EMPTY_PLAN: {echk.calls} checks, "
                             f"{echk.found} NaN, launches {empty[3]}")
    walls = {"plain": [], "empty_plan": []}
    for label in ("plain", "empty_plan", "empty_plan", "plain"):
        extra = dict(chaos=EMPTY_PLAN) if label == "empty_plan" else {}
        walls[label].append(chaos_run(dev, tr, p, **extra, **kw)[2])
    print(f"chaos (a): run_all(chunk_jobs={FLEET_CHUNK}) over {FLEET_JOBS} "
          f"paper-hadoop jobs, {n_s} strategies, plan {plan.fingerprint()}:"
          f" phase 10c's chunked bits for every strategy, r_min equal; "
          f"(grid_solve, philox_rows) launches {faulted[3][:2]}, predicted "
          f"{predicted} (10c's {g_want}, {d_want} plus chunk 4's "
          f"{per_chunk} draws again); each strategy's records: 2 retries "
          f"at chunk 1, 'ignored: single-device run' at 2, corrupt and 1 "
          f"retry at 4; {chk.calls} integrity checks, {chk.found} found "
          f"the poison. EMPTY_PLAN: the same bits, {echk.calls} checks, "
          f"none found NaN, {1e3 * echk.seconds / echk.calls:.3f} ms a "
          f"check on the host; warm walls plain {walls['plain']} s, "
          f"EMPTY_PLAN {walls['empty_plan']} s; faulted run "
          f"{faulted[2]:.3f} s (backoff 0)")
    out["faults"] = dict(
        plan=plan.fingerprint(), launches=list(faulted[3][:2]),
        predicted=list(predicted), chunked_launches=[g_want, d_want],
        records=[list(r) for r in faulted[4][0].records],
        checks=chk.calls, poison_found=chk.found,
        empty_plan_checks=echk.calls,
        check_ms=1e3 * echk.seconds / echk.calls,
        walls_s=dict(walls, faulted=faulted[2], empty_first=empty[2]))

    # (b) a crash in a child process, resumed here
    put = Counted(chaos_recovery.ChunkCheckpointer, "save")
    crash_plan = FaultPlan(events=(FaultEvent("crash", CHAOS_CRASH),))
    with tempfile.TemporaryDirectory() as d:
        child = chaos_child(d)
        step = ckpt.latest_step(Path(d) / "hadoop_ns")
        if child["outcome"] != ["crash", CHAOS_CRASH] or \
                step != CHAOS_CRASH + 1 or child["foreign"]:
            raise AssertionError(f"chaos child: {child}, committed step "
                                 f"{step}")
        gs.launches = ph.launches = 0
        with Counted(fleet_runner, "resume_point") as rp, Counted(
                chaos_recovery.ChunkCheckpointer, "load") as ld, put:
            (res, r_res), crashes, resume_s = resume_until_done(
                lambda: run_all(Philox(0), tr, p, theta=THETA,
                                chaos=crash_plan, checkpoint=d, resume=True,
                                device=dev, **kw), len(names()))
        parent = (gs.launches, ph.launches)
        written = dir_bytes(d)
    fleet_same_bits(res, want, "chaos resumed vs phase 10c chunked")
    total = (child["grid"] + parent[0], child["philox"] + parent[1])
    if r_res != r_want or total != (g_want, d_want) or \
            crashes != [CHAOS_CRASH] * (len(names()) - 1):
        raise AssertionError(f"chaos resume: r_min {r_res}, launches child "
                             f"{child['grid'], child['philox']} + parent "
                             f"{parent} = {total}, crashes {crashes}")
    ck_walls = []
    for _ in range(2):
        with tempfile.TemporaryDirectory() as d, \
                Counted(chaos_recovery.ChunkCheckpointer, "save") as sv:
            r = chaos_run(dev, tr, p, checkpoint=d, **kw)
            ck_walls.append(r[2])
            ck_bytes = dir_bytes(d)
        fleet_same_bits(r[0], want, "checkpointed vs phase 10c chunked")
    print(f"chaos (b): a child process (repro_torch only, "
          f"{child['process_s']:.1f} s) ended in SimulatedCrash("
          f"{CHAOS_CRASH}) after {child['wall_s']:.3f} s of run, step "
          f"{step} committed; resumed here through {len(crashes)} more "
          f"crashes (one a strategy) in {resume_s:.3f} s: phase 10c's "
          f"bits, launches child {child['grid'], child['philox']} + parent "
          f"{parent} = {total}, one run's; {put.calls} saves in the parent "
          f"at {1e3 * put.seconds / put.calls:.3f} ms a chunk on the "
          f"caller's thread, {ld.calls} resumes from a step at "
          f"{1e3 * rp.seconds / ld.calls:.3f} ms each (load, unpack, "
          f"fingerprint; {rp.calls} resume points); {written} bytes left on "
          f"disk; a checkpointed run keeps {ck_bytes} bytes, "
          f"{1e3 * sv.seconds / sv.calls:.3f} ms a save; warm walls with "
          f"the checkpointer {ck_walls} s, without {walls['plain']} s")
    out["crash_resume"] = dict(
        child=child, committed_step=step, parent_launches=list(parent),
        crashes=crashes, resume_s=resume_s, saves=put.calls,
        save_ms=1e3 * put.seconds / put.calls, resume_points=rp.calls,
        resumes_from_a_step=ld.calls,
        resume_ms=1e3 * rp.seconds / ld.calls, bytes_left=written,
        checkpointed_run_bytes=ck_bytes,
        checkpointed_save_ms=1e3 * sv.seconds / sv.calls,
        checkpointed_walls_s=ck_walls)

    # (c) re-pricing: the elastic-recovery scenario against 8 devices
    ptr = make_trace(CHAOS_SCENARIO, n_jobs=FLEET_JOBS, device=dev)
    splan = from_faults(get_scenario(CHAOS_SCENARIO).faults)
    cols = fleet_runner.job_columns(ptr)
    gov = ElasticGovernor(base_devices=CHAOS_BASE_DEVICES)
    scales = gov.schedule(splan, n_chunks, CHAOS_BASE_DEVICES)
    reprice = {}
    for name in names("optimized"):
        ctx = ChaosContext(splan, governor=ElasticGovernor(
            base_devices=CHAOS_BASE_DEVICES), backoff_base=0.0)
        gs.launches = 0
        o = run_fleet_strategy(Philox(0), ptr, name, p, theta=THETA,
                               block_jobs=FLEET_BLOCK,
                               chunk_jobs=FLEET_CHUNK, chaos=ctx,
                               device=dev)
        launches = gs.launches
        check_records([ctx], [(2, "device_loss", "ignored:"),
                              (3, "retry", "attempt=1"),
                              (5, "device_loss", "ignored:")],
                      f"chaos (c) {name}")
        if not np.array_equal(ctx.cost_scales, scales) or \
                launches != n_chunks:
            raise AssertionError(f"chaos (c) {name}: scales "
                                 f"{ctx.cost_scales}, {launches} launches")
        ties = moved = 0
        for ci in range(n_chunks):
            lo, hi = ci * FLEET_CHUNK, min((ci + 1) * FLEET_CHUNK, FLEET_JOBS)
            specs = jobspecs_of(cols.slice(lo, hi).to(dev), p, THETA, 0.0)
            priced = fleet_runner.scale_cost(specs, float(scales[ci]))
            plain = gs.grid_solve_plain(get(name), priced, 9)[0]
            moved += int((gs.grid_solve_plain(get(name), specs, 9)[0]
                          != plain).sum())
            diff = torch.nonzero(o.r_opt[lo:hi] != plain)[:, 0]
            if len(diff):
                U = utility_cost_grids(get(name), priced, 9)[0][diff]
                ua = torch.gather(U, 1, o.r_opt[lo:hi][diff, None].long())
                ub = torch.gather(U, 1, plain[diff, None].long())
                rtol, atol = TOL["u"]
                if not bool(torch.isclose(ua, ub, rtol=rtol,
                                          atol=atol).all()):
                    raise AssertionError(f"chaos (c) {name} chunk {ci}: r* "
                                         f"differs from the plain grids' "
                                         f"away from a near-tie")
                ties += len(diff)
        reprice[name] = dict(near_ties=ties, moved_by_price=moved,
                             sum_r=int(o.r_opt.sum()))
    with Recorded() as rec:
        outs_s, _ = run_all(Philox(0), CHAOS_SCENARIO, p, theta=THETA,
                            chunk_jobs=CHAOS_SCENARIO_CHUNK, device=dev)
    if len(rec.contexts) != len(outs_s) or any(
            c.plan != splan for c in rec.contexts):
        raise AssertionError("chaos (c): run_all by name did not take the "
                             "scenario's plan")
    check_records(rec.contexts, [(2, "device_loss", "ignored:"),
                                 (3, "retry", "attempt=1"),
                                 (5, "device_loss", "ignored:")],
                  f"chaos (c) run_all({CHAOS_SCENARIO!r})")
    print(f"chaos (c): {CHAOS_SCENARIO} at {FLEET_JOBS} jobs, plan "
          f"{splan.fingerprint()}, ElasticGovernor(base_devices="
          f"{CHAOS_BASE_DEVICES}): cost scales {scales.tolist()}; r* of "
          f"every chunk equals the plain grids' argmax at the scaled C "
          f"(near-ties within the U tolerance, jobs whose r* the price "
          f"moved): " + ", ".join(f"{k} {v['near_ties']}/{v['moved_by_price']}"
                                  for k, v in reprice.items())
          + f"; run_all(Philox(0), {CHAOS_SCENARIO!r}, chunk_jobs="
          f"{CHAOS_SCENARIO_CHUNK}) gave all {len(rec.contexts)} strategies"
          f" the scenario's plan, records {rec.contexts[0].records}")
    out["reprice"] = dict(scenario=CHAOS_SCENARIO, plan=splan.fingerprint(),
                          scales=scales.tolist(), per_strategy=reprice,
                          by_name_records=[list(r) for r in
                                           rec.contexts[0].records])

    # (d) the capacity fleet: EMPTY_PLAN, a slot change, a crash
    jobs, (wwant, wr) = st["jobs"], st["windowed"]
    ckw = dict(slots=CLUSTER_SLOTS, reps=REPS_BIG, chunk_jobs=FLEET_WINDOW,
               runner=run_cluster)
    windows = -(-jobs.n_jobs // FLEET_WINDOW)
    wempty = chaos_run(dev, jobs, p, chaos=EMPTY_PLAN, **ckw)
    cluster_same_bits(wempty[0], wwant, "chaos windowed EMPTY_PLAN vs 10c")
    g_w, d_w = st["windowed_launches"]
    if wempty[1] != wr or wempty[3][0] != g_w or \
            wempty[3][2] != d_w * windows:
        raise AssertionError(f"chaos windowed EMPTY_PLAN: launches "
                             f"{wempty[3]}, r_min {wempty[1]}")
    wplan = FaultPlan(events=tuple(FaultEvent(*e)
                                   for e in CHAOS_WINDOW_FAULTS))
    wcrash = FaultPlan(events=wplan.events + (
        FaultEvent("crash", CHAOS_WINDOW_CRASH),))
    # the faulted run checked launch by launch: every launch's pool read
    # from the `free` tensor it got, starts >= releases, at most the pool
    # in service; sresume's first window on the smaller pool held against
    # the plain version
    run_order = ["hadoop_ns"] + [n for n in names() if n != "hadoop_ns"]
    small = CHAOS_WINDOW_FAULTS[0][1]
    wchk = ReplayCheck(CLUSTER_SLOTS,
                       run_order.index("sresume") * windows + small)
    cluster_engine._replay = wchk
    try:
        wfault = chaos_run(dev, jobs, p, chaos=wplan, **ckw)
    finally:
        cluster_engine._replay = wchk.inner
    pools = [wfault[4][0].slots_at(ci, CLUSTER_SLOTS)
             for ci in range(windows)]
    if (wchk.pools != pools * len(names())
            or set(wchk.groups) != {REPS_BIG} or len(wchk.held) != 2):
        raise AssertionError(f"chaos windowed slot_change: pools the "
                             f"launches got {wchk.pools}, schedule {pools}, "
                             f"segments a launch {set(wchk.groups)}, "
                             f"{len(wchk.held)} launches held")
    wheld = held_vs_plain(wchk.held)
    if wheld["pool"] != pools[small]:
        raise AssertionError(f"chaos windowed: held launch on "
                             f"{wheld['pool']} slots, not {pools[small]}")
    wwarm = chaos_run(dev, jobs, p, chaos=wplan, **ckw)
    cluster_same_bits(wwarm[0], wfault[0], "chaos windowed slot_change "
                      "twice")
    print(f"chaos (d): slot_change -100 at window {small}: the dispatch "
          f"launches got pools {wchk.pools[:windows]} (each strategy's "
          f"windows, read from the kernel's free tensor; the plan's "
          f"schedule {pools}); start >= release and at most "
          f"{wchk.max_busy} units in service in any window; sresume's "
          f"window {small} ({REPS_BIG} segments, rows "
          f"{[r for r, _ in wchk.held_rows]}, {wheld['rows']} units a "
          f"pass, steps {wheld['steps']}) on {wheld['pool']} slots: starts "
          f"and final pools equal the plain version's on the CPU "
          f"(max |err| {wheld['max_abs_err']}, {wheld['plain_s']:.1f} s)")
    gs.launches = ds.launches = 0
    with tempfile.TemporaryDirectory() as d:
        (wres, wr_res), wcrashes, wresume_s = resume_until_done(
            lambda: run_cluster(
                Philox(0), jobs, p, theta=THETA, slots=CLUSTER_SLOTS,
                reps=REPS_BIG, chunk_jobs=FLEET_WINDOW, chaos=wcrash,
                checkpoint=d, resume=True, device=dev), len(names()))
        slots_kept = {n_: chaos_recovery.unpack_state(ckpt.load_leaves(
            Path(d) / n_, windows))[1]["acc_queue_slots"].tolist()
            for n_ in names()}
    wlaunch = (gs.launches, ds.launches)
    cluster_same_bits(wres, wfault[0], "chaos windowed resumed vs faulted")
    bad = {n_: v for n_, v in slots_kept.items() if v != pools}
    if (wr_res != wfault[1] or bad or wlaunch != wfault[3][::2]
            or wcrashes != [CHAOS_WINDOW_CRASH] * len(names())):
        raise AssertionError(f"chaos windowed resume: r_min {wr_res}, "
                             f"pools {bad}, launches {wlaunch}, crashes "
                             f"{wcrashes}")
    moved = [n_ for n_, o in wfault[0].items() if not torch.equal(
        o.queue.utilization, wwant[n_].queue.utilization)]
    print(f"chaos (d): run_cluster(slots={CLUSTER_SLOTS}, reps={REPS_BIG}, "
          f"chunk_jobs={FLEET_WINDOW}) under EMPTY_PLAN: phase 10c's bits, "
          f"queue metrics included; (grid_solve, dispatch_scan) launches "
          f"{wempty[3][0], wempty[3][2]} (10c: {g_w, d_w}, one launch a "
          f"window under chaos), dispatch {wempty[6]:.1f} ms (10c: "
          f"{st['windowed_kernel_ms']:.1f} ms batched, "
          f"{st['windowed_kernel_ms_per_window']:.1f} ms one a window); "
          f"walls EMPTY_PLAN {wempty[2]:.3f} s (10c warm "
          f"{st['windowed_warm_s']:.3f} s), slot_change {wwarm[2]:.3f} s "
          f"({wfault[2]:.3f} s checked); "
          f"pools {pools}: utilization moved for {len(moved)} strategies; "
          f"crash after window {CHAOS_WINDOW_CRASH} in each of "
          f"{len(wcrashes)} strategies, resumed in {wresume_s:.3f} s to "
          f"the uninterrupted faulted run's bits, queue metrics and the "
          f"per-window slots {pools} included")
    for name, o in wfault[0].items():
        print(f"    {name:10s} {queue_line(o)}")
    out["capacity"] = dict(
        windows=windows, pools=pools,
        launches_empty_plan=[wempty[3][0], wempty[3][2]],
        launches_batched=list(st["windowed_launches"]),
        dispatch_ms_empty_plan=wempty[6],
        dispatch_ms_batched=st["windowed_kernel_ms"],
        dispatch_ms_one_a_window=st["windowed_kernel_ms_per_window"],
        walls_s=dict(empty_plan=wempty[2], slot_change=wwarm[2],
                     slot_change_checked=wfault[2],
                     batched_warm=st["windowed_warm_s"],
                     crash_resume=wresume_s),
        crashes=len(wcrashes), utilization_moved=moved,
        launch_pools=wchk.pools[:windows], max_in_service=wchk.max_busy,
        dispatch_vs_plain=dict(wheld, strategy="sresume", window=small,
                               segments=[r for r, _ in wchk.held_rows]))
    out["launches"] = dict(grid_solve=faulted[3][0], philox_rows=faulted[3][1],
                           dispatch_scan=wfault[3][2])
    out["phase_s"] = time.perf_counter() - t_phase
    out["faulted"] = faulted[0]
    print(f"  chaos phase: {out['phase_s']:.1f} s")
    return out


def phase_facade(dev, p: SimParams, st: dict) -> dict:
    """`simulate` against the direct calls on the card (phase 10f), every
    route held against an earlier phase's own run, bit for bit."""
    t0 = time.perf_counter()
    fleet = st["fleet"]
    routes = (
        ("flat", st["flat"][0], RunConfig(reps=REPS_BIG), st["flat"][1],
         fleet_same_bits),
        ("flat_fleet", fleet["trace"],
         RunConfig(chunk_jobs=FLEET_CHUNK, block_jobs=FLEET_BLOCK),
         fleet["chunked"][0], fleet_same_bits),
        ("capacity", st["capacity"]["jobs"],
         RunConfig(slots=CLUSTER_SLOTS), st["capacity"]["outs"],
         cluster_same_bits),
        ("serve", st["serving"]["reqs"],
         RunConfig(serve=True, theta=1e-3, window=SERVING["window"]),
         st["serving"]["known_tail"], serve_same_bits),
        ("chaos", fleet["trace"],
         RunConfig(chunk_jobs=FLEET_CHUNK, block_jobs=FLEET_BLOCK,
                   chaos=FaultPlan(events=tuple(
                       FaultEvent(*e) for e in CHAOS_FAULTS))),
         st["chaos"], fleet_same_bits))
    out = {}
    for route, jobs, cfg, want, same in routes:
        if cfg.resolve_path() != ("serve" if route == "serve" else
                                  "capacity" if route == "capacity"
                                  else "flat"):
            raise AssertionError(f"facade {route}: routed to "
                                 f"{cfg.resolve_path()}")
        (got, _), wall = synced(lambda: simulate(Philox(0), jobs, p, cfg=cfg,
                                                 device=dev))
        same(got, want, f"facade {route}")
        out[route] = dict(path=cfg.resolve_path(), wall_s=wall)
    print(f"facade (phase 10f): simulate(Philox(0), jobs, p, cfg=RunConfig("
          f"...), device={dev}) equals the direct call bit for bit on every "
          f"route: " + ", ".join(f"{k} ({v['path']}, {v['wall_s']:.3f} s)"
                                for k, v in out.items()))
    out["phase_s"] = time.perf_counter() - t0
    return out


class LaunchTimes:
    """Inside the block, every dispatch kernel launch is timed by CUDA
    events recorded on its stream just before and just after the
    kernel's C entry: each launch's device ms, in launch order, complete
    by construction (torch.profiler can drop kernel records)."""

    def __enter__(self):
        self.lib = ds._library()
        self.inner, self.events = self.lib.dispatch_scan_launch_as, []

        def timed(*args):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            err = self.inner(*args)
            ev[1].record()
            self.events.append(ev)
            return err

        self.lib.dispatch_scan_launch_as = timed
        return self

    def __exit__(self, *exc):
        self.lib.dispatch_scan_launch_as = self.inner

    def ms(self) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def timed_launches(fn, want: int) -> list:
    """fn() under `LaunchTimes`: each dispatch launch's ms; there must be
    `want` of them."""
    with LaunchTimes() as lt:
        fn()
    each = lt.ms()
    if len(each) != want:
        raise AssertionError(f"{len(each)} dispatch_scan launches timed, "
                             f"expected {want}")
    return each


def profiled_launches(fn, label: str, wall_s: float, want: int):
    """fn() in one profiler session (phase_profile), its dispatch
    launches timed by `LaunchTimes`: (profile, each launch's ms in run
    order)."""
    out = {}
    each = timed_launches(lambda: out.update(
        prof=phase_profile(fn, label, wall_s)), want)
    return out["prof"], each


def profiled_cluster(dev, jobs, p, reps: int, wall_s: float):
    """A profiled warm run_cluster at `reps`: (profile, each of its 20
    dispatch launches' ms)."""
    return profiled_launches(
        lambda: run_cluster(Philox(0), jobs, p, slots=CLUSTER_SLOTS,
                            theta=THETA, reps=reps, device=dev),
        f"run_cluster slots={CLUSTER_SLOTS} reps={reps}", wall_s,
        2 * len(names()))


def sm_clock_while(fn) -> dict:
    """nvidia-smi's SM clock, its maximum and the power draw, sampled while
    the launches fn() enqueues run (about a second of kernel time)."""
    torch.cuda.synchronize()
    fn()
    time.sleep(0.1)
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    sm, sm_max, watts = (float(x) for x in line.split(","))
    return dict(sm_mhz=sm, max_sm_mhz=sm_max, power_w=watts)


def sorted_warp_variants(rel, hold, count, want, dev) -> dict:
    """The sorted design built with each of SORTED_WARP_VARIANTS warps
    (DISPATCH_SORTED_WARPS; one nvcc a variant, all started together),
    held against the shipped kernel's starts `want` at K 512 and timed
    there (CUDA events, one launch after a warm one): {warps: ns a
    step}."""
    import ctypes
    src = build.CSRC / "dispatch_scan.cu"
    procs = {}
    for w in SORTED_WARP_VARIANTS:
        so = build.BUILD / f"dispatch_scan-sorted{w}.so"
        procs[w] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, f"-DDISPATCH_SORTED_WARPS={w}",
             "-o", str(so), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out, K, n = {}, 512, rel.shape[0]
    for w, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"nvcc, sorted design with {w} warps:\n{log}")
        lib = ctypes.CDLL(str(so))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.dispatch_scan_launch_as.argtypes = [i, i, vp, vp, vp, i, i, vp,
                                                i, vp, vp]
        got = torch.empty_like(rel)

        def launch():
            free = torch.zeros(K, device=dev)
            err = lib.dispatch_scan_launch_as(
                0, dev.index or 0, rel.data_ptr(), hold.data_ptr(),
                count.reshape(1).data_ptr(), 1, n, free.data_ptr(), K,
                got.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise AssertionError(f"sorted design, {w} warps: CUDA "
                                     f"error {err}")
        ms = cuda_ms(launch, 1)
        if not torch.equal(got, want):
            raise AssertionError(f"sorted design with {w} warps: starts "
                                 f"differ from the shipped kernel's")
        out[w] = 1e6 * ms / int(count)
    return out


def cluster_times(dev, p: SimParams, state: dict) -> dict:
    """The dispatch kernel's times (phase 10b, run at the end): one
    profiled warm run_cluster at reps 1 (busy, idle share, top ops; the
    kernel's device time per run, per pass and per step, the sorts') and
    one at reps 8; the wrapper's call on clone's pass 2; ns a step on
    clone's pass 2 at STEP_KS with each K's design and at FORCED_KS with
    the lane-private groups (CUDA events, one launch after a warm one);
    the SM clock while the kernel runs; the small case's kernel and plain
    times."""
    jobs, n_steps, n_rows = state["jobs"], state["n_steps"], state["n_rows"]
    want = 2 * len(names())
    prof, each = profiled_cluster(dev, jobs, p, 1, state["warm_wall_s"])
    kernel_ms = sum(each)
    per_pass = {}
    for k, s in enumerate(names()):   # run order: two passes a strategy
        per_pass[s] = [dict(ms=each[2 * k + i], steps=state["steps"][s][i],
                            ns_per_step=1e6 * each[2 * k + i]
                            / state["steps"][s][i]) for i in (0, 1)]
        print(f"  dispatch_scan {s:10s}: " + "; ".join(
            f"pass {i + 1} {v['ms']:.2f} ms over {v['steps']} steps "
            f"({v['ns_per_step']:.1f} ns a step)"
            for i, v in enumerate(per_pass[s])))
    prof8, each8 = profiled_cluster(dev, jobs, p, REPS_BIG,
                                    state["reps8_warm_wall_s"])
    kernel_ms8 = sum(each8)
    bytes_ms = 1e3 * (12 * n_steps + 8 * (n_rows - n_steps)) \
        / HBM_BYTES_PER_S
    rel, hold, count = state["big"]
    steps = int(count)
    call_ms = cuda_ms(lambda: ds.dispatch_scan_cuda(
        rel, hold, count, torch.zeros(CLUSTER_SLOTS, device=dev)), 2)
    per_k = {}
    for K, design in ([(K, None) for K in STEP_KS]
                      + [(K, "groups_shared") for K in FORCED_KS]):
        ms = cuda_ms(lambda: ds._launch(*ds._one_segment(
            rel, hold, count, torch.zeros(K, device=dev)), design), 1)
        d = design or ds.design_of(K)
        per_k[f"{K} {d}"] = dict(K=K, design=d, ms=ms,
                                 ns_per_step=1e6 * ms / steps)
    variants = sorted_warp_variants(
        rel, hold, count, ds.dispatch_scan_cuda(
            rel, hold, count, torch.zeros(512, device=dev)), dev)
    variants[SORTED_WARPS] = per_k["512 sorted"]["ns_per_step"]
    clock = sm_clock_while(lambda: [ds.dispatch_scan_cuda(
        rel, hold, count, torch.zeros(CLUSTER_SLOTS, device=dev))
        for _ in range(5)])
    small = [x.to(dev) for x in sorted_case("fifo")]
    small_ms = cuda_ms(lambda: ds.dispatch_scan_cuda(
        *small, torch.zeros(CLUSTER_SLOTS, device=dev)), 20)
    t0 = time.perf_counter()
    for _ in range(3):
        ds.dispatch_scan_plain(*small, torch.zeros(CLUSTER_SLOTS,
                                                   device=dev))
    plain_ms = 1e3 * (time.perf_counter() - t0) / 3
    times = dict(
        kernel_ms_per_run=kernel_ms,
        profiler_launches_recorded=prof["dispatch_scan_launches"],
        per_pass=per_pass,
        kernel_ms_per_launch=kernel_ms / want,
        ns_per_step=1e6 * kernel_ms / n_steps,
        steps_per_run=n_steps, rows_per_run=n_rows,
        sort_ms_per_run=prof["sort_ms"], bytes_ms=bytes_ms,
        call_ms_clone_pass2=call_ms, clone_pass2_steps=steps,
        ns_per_step_by_K=per_k, clock=clock,
        sorted_ns_per_step_by_warps=variants,
        reps8=dict(kernel_ms_per_run=kernel_ms8, each_ms=each8,
                   profiler_launches_recorded=prof8[
                       "dispatch_scan_launches"],
                   over_reps1=kernel_ms8 / kernel_ms, profile=prof8),
        small_case=dict(rows=int(small[0].shape[0]),
                        steps=int(small[2]), slots=CLUSTER_SLOTS,
                        kernel_ms=small_ms, plain_ms=plain_ms),
        profile=prof)
    print(f"dispatch_scan: {kernel_ms:.2f} ms of device time per "
          f"run_cluster in {want} launches (CUDA events) over {n_steps} "
          f"steps ({times['ns_per_step']:.1f} ns a step); at reps "
          f"{REPS_BIG} {kernel_ms8:.2f} ms in {want} launches, "
          f"{kernel_ms8 / kernel_ms:.3f} x reps 1; sorts "
          f"{prof['sort_ms']:.2f} ms; bound {bytes_ms:.5f} ms (bytes); "
          f"wrapper call on clone's pass 2 ({steps} steps) {call_ms:.2f} ms;"
          f" small case ({small[0].shape[0]} rows, K {CLUSTER_SLOTS}) kernel "
          f"{small_ms:.4f} ms, plain {plain_ms:.2f} ms")
    print(f"dispatch_scan ns a step on clone's pass 2 ({steps} steps): "
          + ", ".join(f"K {v['K']} {v['design']} {v['ns_per_step']:.1f}"
                      for v in per_k.values())
          + "; the sorted design at K 512 with " + ", ".join(
              f"{w} warps {v:.1f}" for w, v in sorted(variants.items()))
          + f"; SM clock {clock['sm_mhz']:.0f} MHz (max "
          f"{clock['max_sm_mhz']:.0f}), {clock['power_w']:.1f} W")
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


def fa_pairs(S, causal, window, prefix) -> int:
    """The (query, key) pairs the mask allows at Sq = Sk = S."""
    allowed = fa.allowed_mask(S, S, causal, window, prefix, "cuda")
    return S * S if allowed is None else int(allowed.sum())


def fa_bound(B, H, K, S, D, dtype, causal, window=None, prefix=0):
    """(bytes ms, operations ms): q, k, v and out moved once; the two
    products' multiply-adds over the (query, key) pairs the mask allows
    (the softmax's few operations a pair are not counted), at the tensor
    rate for bf16 and the f32 rate for f32."""
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * D * S * (2 * B * H + 2 * B * K)
    ops = 4 * B * H * fa_pairs(S, causal, window, prefix) * D
    rate = BF16_TENSOR_OPS_PER_S if dtype == "bfloat16" else F32_OPS_PER_S
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / rate


def reset_counts():
    gs.launches = pm.launches = pm.launches_all = 0
    fa.launches = fa.launches_sm90 = fa.launches_simt = 0
    fa.launches_backward = 0


def fa_counts() -> dict:
    return dict(flash_attention=fa.launches,
                flash_attention_sm90=fa.launches_sm90,
                flash_attention_simt=fa.launches_simt,
                flash_attention_backward=fa.launches_backward)


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


def step_compare(cfg, card, host, batch, max_seq, n_tokens, tol):
    """Prefill `batch` (CPU tensors), then n_tokens greedy decode steps of
    the same weights on the card and on the CPU, the host's choice fed to
    both: logits within `tol` at every step, and the choices equal
    wherever the host's top-2 margin exceeds 2 tol. Returns (max |logit
    error|, clear choices)."""
    dev = card.params["embed"].device
    out = [eng.model.prefill(eng.params, {
        k: x.to(eng.params["embed"].device) for k, x in batch.items()},
        max_seq) for eng in (card, host)]
    worst, clear = 0.0, 0
    for step in range(n_tokens + 1):
        (lg, cg), (lc, cc) = out
        err, sure, tok_c = held_step(cfg, step, lg, lc, tol, "serve check")
        worst, clear = max(worst, err), clear + sure
        if step == n_tokens:
            break
        out = [card.model.decode_step(card.params, tok_c.to(dev), cg),
               host.model.decode_step(host.params, tok_c, cc)]
    return worst, clear


def held_step(cfg, step, lg, lc, tol, what):
    """One step of a card-vs-CPU comparison: the card's logits lg finite
    and within `tol` of the CPU's lc, and the greedy choices equal
    wherever the CPU's top-2 margin exceeds 2 tol. Returns (max |logit
    error|, clear choices, the CPU's choice)."""
    V = cfg.vocab_size
    lg = lg.cpu()
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"{what} step {step}: logits not finite")
    err = float((lg - lc).abs().max())
    if not torch.allclose(lg, lc, rtol=tol, atol=tol):
        raise AssertionError(f"{what} step {step}: card logits {err:.3g} "
                             f"off the CPU's (tol {tol})")
    top = torch.topk(lc[:, -1, :V], 2).values
    sure = (top[:, 0] - top[:, 1]) > 2 * tol
    tok_c = torch.argmax(lc[:, -1:, :V], dim=-1).to(torch.int32)
    tok_g = torch.argmax(lg[:, -1:, :V], dim=-1).to(torch.int32)
    if not torch.equal(tok_g[sure], tok_c[sure]):
        raise AssertionError(f"{what} step {step}: greedy choices differ "
                             f"from the CPU's")
    return err, int(sure.sum()), tok_c


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
    reset_counts()
    batch = make_batch(cfg, CHECK_SERVE["batch"], CHECK_SERVE["prompt"],
                       "prefill", seed=1, device="cpu")
    err, clear = step_compare(cfg, card, host, batch, max_seq,
                              CHECK_SERVE["tokens"], CHECK_SERVE["tol"])
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
    reset_counts()
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


def device_ms_per_call(fn, iters: int, sessions: int = 3) -> float:
    """Device time of one fn() call: every CUDA kernel's time in a profiler
    session of `iters` calls, summed, over `iters`; the largest of
    `sessions` sessions (a session that drops kernel records reads low).
    Unlike CUDA events around the calls, it leaves out the host's time
    where the host launches slower than the card runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = 0.0
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        best = max(best, total / iters / 1e3)
    return best


def fa_grad_compare(what, got, want, dt, floor=0.0, exact=None) -> tuple:
    """Raise unless the gradient `got` is finite, of want's type, nonzero
    wherever |want| exceeds `floor` x max |want|, and within FA_GRAD_F32
    of max |want| (f32) or, for bf16, within FA_MEAN_REL / FA_MAX_REL of
    want's own size. A zero where want is not may be excused, element by
    element, by `exact` (a callable giving `grad_f64`'s gradient, its
    terms' sizes M and the plain version's f32 gradient): only where the
    f64 gradient is within r M of 0, r being the plain f32 version's own
    worst error in units of M over the tensor (`excused_zeros`). Returns
    (mean |err| / mean |want|, max |err| / max |want|, the excused zeros'
    record)."""
    if got.dtype != want.dtype or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"attention gradient {what}: {got.dtype}, not "
                             f"all finite")
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if not bool(w.any()):
        # a query that may see only itself (window 1) has dq = 0 and adds
        # 0 to dk: exactly, in both
        if bool(g.any()):
            raise AssertionError(f"attention gradient {what}: nonzero where "
                                 f"autograd through the plain version's is "
                                 f"all zero")
        return 0.0, 0.0, None
    mean_rel = float(err.mean() / w.abs().mean())
    max_rel = float(err.max() / w.abs().max())
    zeros = (g == 0) & (w.abs() > floor * w.abs().max())
    excused = None
    if exact is not None and bool(zeros.any()):
        excused = excused_zeros(zeros, *exact())
        zeros &= ~excused.pop("mask")
    lost = int(zeros.sum())
    ok = (max_rel <= FA_GRAD_F32 if dt == "float32"
          else mean_rel <= FA_MEAN_REL and max_rel <= FA_MAX_REL)
    if not ok or lost:
        raise AssertionError(
            f"attention gradient {what}: mean |err| / mean |want| "
            f"{mean_rel:.3g}, max |err| / max |want| {max_rel:.3g}, {lost} "
            f"elements zero where autograd through the plain version's are "
            f"not (excused: {excused})")
    return mean_rel, max_rel, excused


def grad_f64(q, k, v, dout, causal=True, softcap=None, window=None,
             prefix_len=0) -> tuple:
    """((dq, dk, dv), (Mq, Mk, Mv)) in f64: the attention gradient by
    `attention_backward_plain`'s formulas, and beside each element the
    sum of its terms' sizes, the same formulas on magnitudes with no
    cancellation: |dO| |V|^T for dP, P (|dP| + rowsum(P |dP|)) (1 - t^2)
    scale for dS, then |dS| |K|, |dS|^T |Q| and P^T |dO|. A sum computed
    in floating point is off its exact value by a small multiple of its
    unit roundoff times M."""
    f = torch.float64
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    scale = D ** -0.5
    qg = q.reshape(B, K, H // K, Sq, D).to(f)
    kf, vf = k.to(f), v.to(f)
    do = dout.reshape(B, K, H // K, Sq, D).to(f)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, kf) * scale
    c = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s, c = softcap * t, 1.0 - t * t
        del t
    allowed = fa.allowed_mask(Sq, Sk, causal, window, prefix_len, q.device)
    if allowed is not None:
        s = torch.where(allowed, s, -1e30)
    p = torch.softmax(s, dim=-1)
    del s
    dv = torch.einsum("bkgst,bkgsd->bktd", p, do)
    mv = torch.einsum("bkgst,bkgsd->bktd", p, do.abs())
    dp = torch.einsum("bkgsd,bktd->bkgst", do, vf)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dp = torch.einsum("bkgsd,bktd->bkgst", do.abs(), vf.abs())
    a = p * (dp + (p * dp).sum(-1, keepdim=True))
    del p, dp
    if c is not None:
        ds, a = ds * c, a * c
        del c
    ds, a = ds * scale, a * scale
    grads = (torch.einsum("bkgst,bktd->bkgsd", ds, kf).reshape(B, H, Sq, D),
             torch.einsum("bkgst,bkgsd->bktd", ds, qg), dv)
    sizes = (torch.einsum("bkgst,bktd->bkgsd", a, kf.abs()).reshape(
        B, H, Sq, D), torch.einsum("bkgst,bkgsd->bktd", a, qg.abs()), mv)
    return grads, sizes


def rounding_reference(q, k, v, dout, mask):
    """name -> (f64 gradient, its terms' sizes, the plain version's f32
    gradient) of d`name` ('q', 'k' or 'v') for fa_grad_compare's `exact`,
    the three computed together on first use."""
    memo = {}

    def get(name):
        if not memo:
            grads, sizes = grad_f64(q, k, v, dout, **mask)
            plain = fa.attention_backward_plain(
                *(x.float() for x in (q, k, v, dout)), **mask)
            memo.update(zip("qkv", zip(grads, sizes, plain)))
        return memo[name]
    return get


def excused_zeros(zeros, exact, sizes, plain) -> dict:
    """Of `zeros` (the kernel's 0 where the plain version's value is not),
    those within rounding of 0: |f64 gradient| <= r M, where M is the sum
    of the element's terms' sizes and r the plain f32 version's largest
    |error| / M over the tensor, the rounding its own f32 sums show. "mask"
    is those elements; "n" their count, "worst" the largest |exact| / M
    among them, "r" the plain version's."""
    m = sizes.clamp_min(torch.finfo(torch.float64).tiny)
    r = float(torch.where(sizes > 0, (plain.double() - exact).abs() / m,
                          0.0).max())
    ratio = exact.abs() / m
    mask = zeros & (ratio <= r)
    worst = float(ratio[mask].max()) if bool(mask.any()) else 0.0
    return dict(mask=mask, n=int(mask.sum()), of=int(zeros.sum()),
                worst=worst, r=r)


def fa_backward_bound(B, H, K, S, D, causal):
    """(bytes ms, operations ms) of the gradient: q, k, v and dO read, dq,
    dk and dv written once, bf16; five products (the scores again, dV,
    dP, dQ, dK) over the (query, key) pairs the mask allows, at the bf16
    tensor-core rate."""
    nbytes = 2 * D * S * (2 * B * H + 4 * B * K)
    pairs = S * (S + 1) // 2 if causal else S * S
    return (1e3 * nbytes / HBM_BYTES_PER_S,
            1e3 * 10 * B * H * pairs * D / BF16_TENSOR_OPS_PER_S)


def phase_train_attention(dev) -> dict:
    """(a) The differentiable flash-attention call on the card: forward
    (the kernel, one launch on its route) and gradients
    (`attention_backward`) against autograd through `attention_plain` on
    the same card, at phase 14's shapes, the training path's and the hot
    softcap cases; then the backward's time at the path's shape."""
    cases = ([(x, 1.0) for x in FA_SHAPES + (FA_TRAIN + (True,),)]
             + [(x, FA_HOT_SCALE) for x in FA_HOT_SHAPES])
    checked = check_grad_cases(
        [((B, H, K, S, D, dt, causal, None, 0, cap, views), q_scale)
         for (B, H, K, S, D, dt, causal, cap, views), q_scale in cases],
        200, dev, dout_seed0=400)
    worst, excused = checked["worst_rel"], checked["excused_zeros"]
    print(f"train attention: {len(cases)} cases, dq, dk, dv equal autograd "
          f"through the plain version (nonzero where it is, "
          f"{sum(e['n'] for e in excused)} zeros within rounding of 0 "
          f"excused); worst (mean |err| / mean |want|, max |err| / max "
          f"|want|) f32 {worst['float32']}, bf16 {worst['bfloat16']}")

    B, H, K, S, D, dt, causal, cap = FA_TRAIN
    q, k, v = fa_inputs(B, H, K, S, D, dt, 9, dev, views=True)
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    dout = torch.randn((B, H, S, D), generator=g, device=dev).to(q.dtype)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    backward = lambda: fa.attention_backward(q, k, v, dout, causal, cap)
    both = lambda: torch.autograd.grad(
        fa.attention(*leaves, causal=causal, softcap=cap), leaves, dout)
    plain = lambda: torch.autograd.grad(
        fa.attention_plain(*leaves, causal=causal, softcap=cap), leaves,
        dout)
    library = lambda: torch.autograd.grad(
        torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=causal, enable_gqa=True), leaves, dout)
    bytes_ms, ops_ms = fa_backward_bound(B, H, K, S, D, causal)
    bound_ms, bound_by = bound_of(bytes_ms, ops_ms)
    out = dict(backward_ms=cuda_ms(backward, 10),
               forward_backward_ms=cuda_ms(both, 10),
               plain_forward_backward_ms=cuda_ms(plain, 5),
               library_forward_backward_ms=cuda_ms(library, 10),
               bound_ms=bound_ms, bound_by=bound_by, bytes_ms=bytes_ms,
               ops_ms=ops_ms, cases=len(cases), worst_rel=worst,
               excused_zeros=excused,
               library="torch.nn.functional.scaled_dot_product_attention("
                       "is_causal=True, enable_gqa=True) forward and "
                       "backward, without the softcap",
               shape=dict(zip(("B", "H", "K", "S", "D", "dtype", "causal",
                               "softcap"), FA_TRAIN)))
    out["bound_share"] = bound_ms / out["backward_ms"]
    print(f"attention_backward at {FA_TRAIN}: {out['backward_ms']:.4f} ms "
          f"(bound {bound_ms:.5f} ms, {bound_by}; {out['bound_share']:.3f} of "
          f"it); kernel forward + backward {out['forward_backward_ms']:.4f} "
          f"ms, autograd through the plain version "
          f"{out['plain_forward_backward_ms']:.4f} ms, SDPA forward + "
          f"backward without softcap (yardstick) "
          f"{out['library_forward_backward_ms']:.4f} ms")
    return out


class GradRecorder:
    """An optimizer that keeps the gradients it is given (a copy on their
    device; the gradients themselves on the host, where the optimizers do
    not write them), then updates as the optimizer it wraps."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, lr_scale=1.0):
        on_host = all(g.device.type == "cpu"
                      for g in ckpt.checkpoint.tree_leaves(grads))
        self.grads = grads if on_host else ckpt.checkpoint.tree_map(
            torch.clone, grads)
        return self.opt.update(grads, state, params, lr_scale=lr_scale)


@contextlib.contextmanager
def host_heap_reuse():
    """While open, glibc's malloc serves every allocation from its heap
    and keeps what is freed there (no mmap, no trim), so the CPU's
    full-width steps and comparisons reuse host memory instead of
    faulting fresh pages for each gigabyte-sized temporary; on exit the
    defaults come back and the heap is trimmed."""
    import ctypes
    libc = ctypes.CDLL("libc.so.6")
    m_trim_threshold, m_mmap_max = -1, -4
    if not (libc.mallopt(m_mmap_max, 0)
            and libc.mallopt(m_trim_threshold, 2 ** 31 - 1)):
        raise RuntimeError("host_heap_reuse: mallopt refused")
    try:
        yield
    finally:
        libc.mallopt(m_mmap_max, 65536)
        libc.mallopt(m_trim_threshold, 128 * 1024)
        libc.malloc_trim(0)


def cpu_reference_tasks() -> list:
    """The CPU's sides of phases 16 (b), 19 (b) and 24 (e), in the order the
    phases take them: ("train_check",), or ("family", arch, opts, cut)."""
    fam = CHECK_TRAIN_FAMILIES
    cut = lambda d: tuple(sorted(d.items()))
    return ([("train_check",)]
            + [("family", a, tuple(o), cut(fam["cuts"][a]))
               for a in fam["cuts"] for o in fam["paths"].get(a, ((),))]
            + [("family", a, (), cut(CONFIG_TRAIN_CHECK[a]))
               for a in CONFIG_DENSE])


def cpu_reference(task) -> dict:
    """One train check's CPU side, on the CPU alone: its weights drawn from
    seed 1 by the CPU's generator (the check copies these same values to
    the card), then one step on the CPU (the plain path): the weights
    (`init`), loss, grad_norm, gradients, the updated parameters (phase 16
    (b) only) and the step's seconds."""
    if task[0] == "train_check":
        _, model, batch = train_check_setup()
        lr, opts = CHECK_TRAIN["lr"], ()
    else:
        _, arch, opts, cut = task
        _, model, batch = family_check_setup(arch, dict(cut))
        lr = CHECK_TRAIN_FAMILIES["lr"]
    params = model.init(seed=1, device="cpu")
    init = to_host(params)
    t0 = time.perf_counter()
    with host_heap_reuse():
        loss, norm, grads, new = check_step(model, params, batch, "cpu", lr,
                                            opts)
    return dict(init=init, loss=loss, norm=norm, grads=grads,
                params=new if task[0] == "train_check" else None,
                seconds=time.perf_counter() - t0)


#: CPU references computed or waiting at once: the one a check takes and
#: the next two (host memory: three checks' weights and gradients; with two
#: the checks of phase 19 (b) waited 10-13 s for mamba2's and zamba2's)
CPU_REFS_AHEAD = 3


def start_cpu_refs() -> dict:
    """One worker process, started at the beginning of the script at a
    lower priority than this one, that works through
    `cpu_reference_tasks()` in order beside the card's phases, at most
    CPU_REFS_AHEAD at a time; the checks take its results with
    `take_cpu_reference`. Its tensors come back through shared memory
    (torch's multiprocessing reductions): nothing is written to disk. It
    never touches the card: a second process's kernels beside the
    profiler's sessions cost them their records."""
    import concurrent.futures
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"),
        initializer=os.nice, initargs=(10,))
    refs = dict(pool=pool, futures={}, waiting=cpu_reference_tasks())
    for _ in range(CPU_REFS_AHEAD):
        submit_cpu_reference(refs)
    return refs


def submit_cpu_reference(refs) -> None:
    """The next waiting task to the worker, if any."""
    if refs["waiting"]:
        task = refs["waiting"].pop(0)
        refs["futures"][task] = refs["pool"].submit(cpu_reference, task)


def stop_cpu_refs(refs) -> None:
    """The worker stopped (again: a no-op)."""
    if refs is not None:
        refs["pool"].shutdown(wait=True, cancel_futures=True)


def take_cpu_reference(refs, task) -> dict:
    """`cpu_reference(task)`: the worker's where `refs` has it (then the
    next task goes to the worker), else computed here; "where" says which,
    "wait_s" how long this process waited for it."""
    t0 = time.perf_counter()
    if refs is None:
        return dict(cpu_reference(task), where="this process", wait_s=0.0)
    if task not in refs["futures"]:
        refs["waiting"].remove(task)
        refs["futures"][task] = refs["pool"].submit(cpu_reference, task)
    out = refs["futures"].pop(task).result()
    wait_s = time.perf_counter() - t0
    submit_cpu_reference(refs)
    for key in ("init", "grads", "params"):
        if out[key] is not None:
            out[key] = ckpt.checkpoint.tree_map(private_copy, out[key])
    return dict(out, where="the worker process", wait_s=wait_s)


def private_copy(x):
    """A tensor that came from the worker (a shared-memory mapping) copied
    into ordinary memory. The mapping's pages fault in slowly on first
    touch: a copy of 2.8 GB to the card took 6.8 s, a clone 2.3 s a GB;
    page-locking the mapping first (cudaHostRegister) faults them in
    in 0.85 s, after which the clone is a plain memcpy."""
    if not torch.is_tensor(x) or x.numel() == 0:
        return x
    cudart = torch.cuda.cudart()
    storage = x.untyped_storage()
    ptr = storage.data_ptr()
    if cudart.cudaHostRegister(ptr, storage.nbytes(), 0) != \
            cudart.cudaError.success:
        raise RuntimeError(f"cudaHostRegister of a {storage.nbytes()}-byte "
                           f"tensor from the CPU-reference worker failed")
    try:
        return x.clone()
    finally:
        cudart.cudaHostUnregister(ptr)


def cpu_adamw(lr, grads, params) -> None:
    """The CPU's AdamW step (no schedule) on `grads` (any device) applied
    to the host tree `params` in place, one leaf at a time: AdamW updates
    leaf by leaf, so the bits are the whole tree's, for one leaf's
    memory."""
    opt = AdamW(lr=lr)
    leaves = ckpt.checkpoint.tree_leaves
    for g, p in zip(leaves(grads), leaves(params), strict=True):
        one = {"w": p}
        opt.update({"w": g.detach().to("cpu")}, opt.init(one), one)


def tree_worst(got, want, tol: float, what: str, fail: bool = True,
               count_past=None):
    """(the largest |got - want| over each tensor's max |want|, the
    elements beyond `count_past` (default tol) of it) over two trees of
    host tensors; raises past tol if `fail`. Each pair of leaves is
    compared on the card, one pair at a time: subtraction, abs, max and
    the comparisons give the host's bits there, in a fraction of its
    time."""
    rel, off = 0.0, 0
    past = tol if count_past is None else count_past
    leaves = ckpt.checkpoint.tree_leaves_with_paths
    for (path, a), (_, b) in zip(leaves(got), leaves(want), strict=True):
        a, b = a.detach().to("cuda"), b.detach().to("cuda")
        scale = max(float(b.abs().max()), 1e-30)
        err = (a - b).abs()
        worst = float(err.max())
        rel = max(rel, worst / scale)
        off += int((err > past * scale).sum())
        if fail and worst > tol * scale:
            raise AssertionError(f"{what} {path} "
                                 f"{worst / scale:.3g} of its max "
                                 f"off (tol {tol})")
    return rel, off


def train_check_setup():
    """Phase 16 (b)'s config, model and host batch."""
    c = CHECK_TRAIN
    cfg = dataclasses.replace(get_config(TRAIN["arch"]),
                              n_layers=c["layers"], compute_dtype="float32")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (c["batch"], c["seq"] + 1),
                        dtype=np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    return cfg, model_lib.build(cfg), batch


def check_step(model, params, batch, device, lr, opts=()):
    """One make_train_step (AdamW at lr, one microbatch) from `params` on
    `device`: (loss, grad_norm, the gradients and the updated parameters,
    on `device`)."""
    opt = GradRecorder(AdamW(lr=lr))
    step = make_train_step(model, opt, n_micro=1, opts=frozenset(opts))
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=device))
    state, m = step(state, {k: v.to(device) for k, v in batch.items()},
                    torch.ones((1,), device=device))
    return float(m["loss"]), float(m["grad_norm"]), opt.grads, state.params


def phase_train_check(dev, refs=None) -> dict:
    """(b) gemma2-2b cut to CHECK_TRAIN["layers"] layers at full width, f32
    compute: one train_step (AdamW, no schedule) on one batch from the
    same seeded weights on the card (the SIMT flash-attention route) and
    on the CPU (the plain version, which the CPU tests hold against the
    JAX package; `cpu_reference`, from the worker of `refs`). The loss
    within loss_rtol, each gradient within `tol` of its tensor's max |CPU
    value|. AdamW's first step moves a weight by lr g / (|g| + eps), about
    lr sign(g), so a gradient difference within the tolerance moves a
    small gradient's weight by up to 2 lr: the card's updated parameters
    are held within `tol` of each tensor's max against the CPU's AdamW
    applied to the card's gradients, and the elements off the CPU's own
    step by more than that are counted."""
    c = CHECK_TRAIN
    cfg, model, batch = train_check_setup()
    t0 = time.perf_counter()
    cpu = take_cpu_reference(refs, ("train_check",))
    t1 = time.perf_counter()
    start = cpu["init"]
    reset_counts()
    card_loss, _, card_grads, card_params = check_step(
        model, tree_to(start, dev), batch, dev, c["lr"])
    counts = (fa.launches_simt, fa.launches_sm90, fa.launches_backward)
    if counts != (2 * cfg.n_layers, 0, cfg.n_layers):
        raise AssertionError(f"train check: flash-attention launches (simt, "
                             f"sm90, backward) {counts}, expected "
                             f"({2 * cfg.n_layers}, 0, {cfg.n_layers}): the "
                             f"forward and its recompute, f32 route, and the "
                             f"backward kernel once a layer")
    t2 = time.perf_counter()
    cpu_loss = cpu["loss"]
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    if not math.isfinite(card_loss) or loss_rel > c["loss_rtol"]:
        raise AssertionError(f"train check: loss {card_loss} on the card, "
                             f"{cpu_loss} on the CPU (rel {loss_rel:.3g})")
    # the CPU's AdamW step on the card's gradients
    cpu_adamw(c["lr"], card_grads, start)

    worst = lambda got, want, what, fail=True: tree_worst(
        got, want, c["tol"], f"train check: {what}", fail)
    grad_rel, _ = worst(card_grads, cpu["grads"], "gradient")
    param_rel, _ = worst(card_params, start, "updated parameter (against "
                         "the CPU's AdamW on the card's gradients)")
    step_rel, step_off = worst(card_params, cpu["params"], "", fail=False)
    secs = time.perf_counter() - t0
    print(f"train check (gemma2-2b, {cfg.n_layers} layers, full width, f32, "
          f"B {c['batch']} x {c['seq']}): {counts[0]} simt launches; loss "
          f"{card_loss:.6f} card, {cpu_loss:.6f} CPU (rel {loss_rel:.3g}); "
          f"gradients within {grad_rel:.3g} of each tensor's max; updated "
          f"parameters within {param_rel:.3g} of the CPU's AdamW on the "
          f"card's gradients; against the CPU's own step {step_off} elements "
          f"beyond {c['tol']} of their tensor's max (worst {step_rel:.3g}); "
          f"{secs:.1f} s (the CPU's side {t1 - t0:.1f}, of it waiting for "
          f"its step {cpu['wait_s']:.1f} (the step {cpu['seconds']:.1f} s in "
          f"{cpu['where']}); card and copies {t2 - t1:.1f}, checks "
          f"{time.perf_counter() - t2:.1f})")
    return dict(loss_card=card_loss, loss_cpu=cpu_loss, loss_rel=loss_rel,
                grad_rel=grad_rel, param_rel=param_rel,
                params_off_cpu_step=step_off, param_rel_cpu_step=step_rel,
                simt_launches=counts[0], seconds=secs, card_s=t2 - t1,
                cpu_wait_s=cpu["wait_s"], cpu_side_s=t1 - t0,
                cpu_step_s=cpu["seconds"],
                cpu_step_where=cpu["where"],
                checks_s=time.perf_counter() - t2)


def model_flops_per_step(cfg, tokens: int, seqs: int, seq: int) -> float:
    """6 x (matmul parameters) x tokens, plus 3 x the causal attention
    products (forward and backward); the remat recompute not counted."""
    per_layer = (cfg.d_model * cfg.head_dim * (2 * cfg.n_heads
                                               + 2 * cfg.n_kv_heads)
                 + 3 * cfg.d_model * cfg.d_ff)
    matmul = cfg.n_layers * per_layer + cfg.d_model * padded_vocab(cfg)
    attn = cfg.n_layers * seqs * 4 * cfg.n_heads * cfg.head_dim * (
        seq * (seq + 1) // 2)
    return 6 * matmul * tokens + 3 * attn


def profile_train_step(fn, wall_s: float) -> dict:
    """One torch.profiler pass over a warm train step: device busy, idle
    share over the unprofiled wall, the flash-attention kernel's device
    time and `attention_backward`'s (its kernels, inside a
    record_function range), and the top device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    inner = fa.attention_backward

    def annotated(*a, **kw):
        with record_function("attention_backward"):
            return inner(*a, **kw)

    fa.attention_backward = annotated
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        fa.attention_backward = inner
    events = prof.key_averages()
    # the range's own device row is its span on the device's timeline,
    # not kernel time: kept out of the busy sum
    rows = [e for e in events if e.device_type == DeviceType.CUDA
            and e.key != "attention_backward"]
    busy_us = sum(e.device_time_total for e in rows)
    if busy_us <= 0:
        raise AssertionError("profiler recorded no device time")
    fa_us = sum(e.device_time_total for e in rows
                if "flash_attention" in e.key)
    # the kernels launched inside the range
    bwd_us = sum(e.device_time_total for e in events
                 if e.key == "attention_backward"
                 and e.device_type == DeviceType.CPU)
    top = [(e.key[:90], e.device_time_total / 1e3, e.count)
           for e in sorted(rows, key=lambda e: -e.device_time_total)[:10]]
    out = dict(device_busy_ms=busy_us / 1e3,
               device_ops=sum(e.count for e in rows),
               idle_share=1.0 - busy_us / 1e6 / wall_s,
               flash_attention_ms=fa_us / 1e3,
               attention_backward_ms=bwd_us / 1e3,
               top=[dict(op=k, ms=ms, count=n) for k, ms, n in top])
    print(f"profile train step: device busy {out['device_busy_ms']:.1f} ms in"
          f" {out['device_ops']} device ops; unprofiled warm wall "
          f"{wall_s * 1e3:.1f} ms; idle share {out['idle_share']:.3f}; flash "
          f"attention {out['flash_attention_ms']:.1f} ms, attention_backward "
          f"{out['attention_backward_ms']:.1f} ms")
    for k, ms, n in top:
        print(f"  {ms:9.3f} ms {100 * ms * 1e3 / busy_us:5.1f}% x{n:<6d} {k}")
    return out


def head_ce_ms(params, cfg, dev) -> float:
    """The lm-head and cross-entropy of one microbatch (1 x seq_len),
    forward and backward, alone (CUDA events)."""
    V, S = cfg.vocab_size, TRAIN["seq_len"]
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    x = torch.randn((1, S, cfg.d_model), generator=g, device=dev).to(
        torch.bfloat16).requires_grad_(True)
    labels = torch.randint(0, V, (1, S), generator=g, device=dev)
    w = params["lm_head"]

    def fn():
        logits = model_layers.logits_head(w, x, cfg.final_softcap)
        loss = model_layers.cross_entropy(logits[:, :-1, :V], labels[:, 1:])
        return torch.autograd.grad(loss, (x, w))

    return cuda_ms(fn, 5)


def train_batch(tcfg: TrainerConfig, cfg, dev) -> dict:
    """Step 0's batch of the trainer's pipeline, as tensors on the card."""
    pcfg = PipelineConfig(vocab_size=cfg.vocab_size, seq_len=tcfg.seq_len,
                          global_batch=tcfg.global_batch,
                          n_shards=tcfg.n_data_shards, cycle=tcfg.data_cycle)
    b = assemble(pcfg, [make_shard(pcfg, 0, s)
                        for s in range(tcfg.n_data_shards)])
    return {k: torch.from_numpy(b[k]).to(dev) for k in ("tokens", "labels")}


def trainer_run(cfg, tcfg, dev) -> tuple:
    """A Trainer's run with the counts set to 0 just before the trainer is
    built: its input pipeline's producer thread starts deciding (and so
    launching the grid solve) as soon as it exists, up to
    `prefetch_depth` steps ahead of the training steps, and a reset
    after that could fall inside a decision. Returns (trainer, history,
    counts, peak bytes, build s, the warm decisions' host ms)."""
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t, build_s = synced(lambda: Trainer(cfg, tcfg, seed=0, device=dev))
    decide_ms, specs = [], []
    gov, tel = t.governor, t.telemetry
    inner = gov.decide

    def timed():
        before = tel.counters.get(WARM_DECISIONS, 0)
        t0 = time.perf_counter()
        sol = inner()
        if tel.counters.get(WARM_DECISIONS, 0) != before:   # it solved
            decide_ms.append(1e3 * (time.perf_counter() - t0))
            specs.append(gov.last_spec)
        return sol

    gov.decide = timed
    hist, _ = synced(t.run)
    del gov.decide                                    # the class's again
    counts = dict(fa_counts(), grid_solve=gs.launches,
                  warm_decisions=t.telemetry.counters.get(WARM_DECISIONS, 0))
    return (t, hist, counts, torch.cuda.max_memory_allocated(), build_s,
            decide_ms, specs)


def check_governor(gov, specs) -> float:
    """Each warm decision's JobSpec (J = 1, fitted from the run's shard
    telemetry) through the kernel and the plain version, for every
    strategy the governor sweeps, at its r_max. Returns the max |error|
    of U, PoCD and cost."""
    errs = [0.0]
    for i, spec in enumerate(specs):
        job = JobSpec(*(x.reshape(1) for x in spec))
        for s in gov.cfg.strategies or names(kind="chronos"):
            errs += check_grid(get(s), job, gov.cfg.max_r + 1,
                               f"train governor decision {i}")
    return max(errs)


def phase_train(dev) -> dict:
    """(c) the training path at full width: Trainer(gemma2-2b, TRAIN) for
    4 steps, counted; a warm step timed and profiled; the lm-head with
    cross-entropy and the AdamW update timed alone; a second run from
    the same seed, loss for loss."""
    cfg = get_config(TRAIN["arch"])
    tcfg = TrainerConfig(n_steps=TRAIN["n_steps"],
                         global_batch=TRAIN["global_batch"],
                         seq_len=TRAIN["seq_len"], n_micro=TRAIN["n_micro"],
                         n_data_shards=TRAIN["n_data_shards"],
                         data_cycle=TRAIN["data_cycle"],
                         speculative_input=True, log_every=1000)
    n_chronos = len(names(kind="chronos"))
    t, hist, counts, peak, build_s, decide_ms, specs = trainer_run(cfg, tcfg,
                                                                   dev)
    losses = [h["loss"] for h in hist]
    want_fa = 2 * cfg.n_layers * tcfg.n_micro * tcfg.n_steps
    if (counts["flash_attention"], counts["flash_attention_sm90"],
            counts["flash_attention_backward"]) != (
            want_fa, want_fa, want_fa // 2) or counts["flash_attention_simt"]:
        raise AssertionError(f"train: flash-attention launches {counts}, "
                             f"expected {want_fa} (forward and recompute of "
                             f"{cfg.n_layers} layers x {tcfg.n_micro} "
                             f"microbatches x {tcfg.n_steps} steps), all "
                             f"sm90, and {want_fa // 2} of the backward "
                             f"kernel")
    if counts["grid_solve"] != n_chronos * counts["warm_decisions"] or \
            not counts["warm_decisions"]:
        raise AssertionError(f"train: grid-solve launches {counts}, expected "
                             f"{n_chronos} per warm governor decision")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses {losses} (finite, and lower at "
                             f"the last step than at the first)")
    times = [h["time"] for h in hist]
    warm_s = sorted(times[1:])[len(times[1:]) // 2]
    tokens = tcfg.global_batch * tcfg.seq_len
    flops = model_flops_per_step(cfg, tokens, tcfg.global_batch,
                                 tcfg.seq_len)

    # a warm step alone, timed then profiled (the trainer's state moves on)
    batch = train_batch(tcfg, cfg, dev)
    mask = torch.ones((tcfg.n_micro,), device=dev)
    step = make_train_step(t.model, t.optimizer, tcfg.n_micro)

    def one_step():
        t.state, m = step(t.state, batch, mask)
        return m

    walls = [synced(one_step)[1] for _ in range(2)]
    prof = profile_train_step(one_step, min(walls))
    head_ms = head_ce_ms(t.state.params, cfg, dev)
    adamw_ms = cuda_ms(lambda: t.optimizer.update(
        t.state.opt_state.m, t.state.opt_state, t.state.params, 1.0), 3)
    idle_decide_ms = [1e3 * synced(t.governor.decide)[1] for _ in range(3)]
    params = sum(x.numel() for x in ckpt.checkpoint.tree_leaves(
        t.state.params))
    del t, batch, step
    torch.cuda.empty_cache()

    t2, hist2, counts2, _, _, _, specs2 = trainer_run(cfg, tcfg, dev)
    governor_err = check_governor(t2.governor, specs + specs2)
    losses2 = [h["loss"] for h in hist2]
    del t2
    torch.cuda.empty_cache()
    if losses2 != losses:
        raise AssertionError(f"train: a second run from the same seed gave "
                             f"losses {losses2} against {losses}")
    if counts2["grid_solve"] != n_chronos * counts2["warm_decisions"] or \
            counts2["flash_attention_sm90"] != want_fa or \
            counts2["flash_attention_backward"] != want_fa // 2:
        raise AssertionError(f"train: second run's launches {counts2}")
    busy = prof["device_busy_ms"]
    out = dict(
        arch=TRAIN["arch"], params=params, trainer=dataclasses.asdict(tcfg),
        build_s=build_s, losses=losses, step_s=times,
        first_step_s=times[0], warm_step_s=warm_s,
        warm_step_alone_s=min(walls), tokens_per_s=tokens / warm_s,
        peak_memory_bytes=peak, counts=counts, counts_second_run=counts2,
        step_s_second_run=[h["time"] for h in hist2],
        same_losses_twice=True, model_flops_per_step=flops,
        mfu=flops / warm_s / BF16_TENSOR_OPS_PER_S, profile=prof,
        shares=dict(
            flash_attention=prof["flash_attention_ms"] / busy,
            attention_backward=prof["attention_backward_ms"] / busy,
            lm_head_cross_entropy_alone=tcfg.n_micro * head_ms / busy,
            adamw_update_alone=adamw_ms / busy),
        lm_head_cross_entropy_ms=head_ms, adamw_update_ms=adamw_ms,
        decide_ms_during_run=decide_ms, decide_ms_idle=idle_decide_ms,
        governor_decisions_checked=len(specs) + len(specs2),
        governor_grid_max_abs_err=governor_err)
    print(f"train {TRAIN['arch']} ({params:,} parameters, f32; bf16 compute; "
          f"{tcfg.n_steps} steps of {tcfg.n_micro} x 1 x {tcfg.seq_len}): "
          f"build {build_s:.2f} s; losses {losses}; step s {times} (first "
          f"{times[0]:.3f}, warm {warm_s:.3f}, alone {min(walls):.3f}); "
          f"{out['tokens_per_s']:.0f} tokens/s; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {counts}; model FLOPs a step "
          f"{flops:.4g}, {out['mfu']:.3f} of the dense bf16 peak; shares "
          f"of device busy {out['shares']}; lm-head + CE {head_ms:.2f} ms a "
          f"microbatch, AdamW {adamw_ms:.2f} ms; governor decide ms during "
          f"the run {[round(x, 2) for x in decide_ms]}, idle "
          f"{[round(x, 2) for x in idle_decide_ms]}; the governor's "
          f"{len(specs) + len(specs2)} warm decisions of both runs against "
          f"the plain grid solve, max |err| {governor_err:.3g}; second run: "
          f"the same "
          f"losses, launches {counts2}, step s "
          f"{out['step_s_second_run']}")
    return out


def phase_train_restart(dev) -> dict:
    """(d) a narrow 2-layer gemma2 (RESTART; head dim 64, the tensor-core
    route): run(fail_at=2) with checkpoints, restore into a fresh trainer
    from another seed, continue; the continued losses must equal an
    uninterrupted run's."""
    cfg = dataclasses.replace(get_config(TRAIN["arch"]),
                              name="gemma2-2b-narrow", **RESTART)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        def trainer(seed, ckpt_dir):
            return Trainer(cfg, TrainerConfig(**RESTART_RUN,
                                              ckpt_dir=ckpt_dir),
                           seed=seed, device=dev)

        want = [h["loss"] for h in trainer(3, None).run()]
        try:
            trainer(3, d).run(fail_at=2)
        except RuntimeError as err:
            if "injected failure" not in str(err):
                raise
        else:
            raise AssertionError("train restart: run(fail_at=2) did not fail")
        t2 = trainer(4, d)
        resumed = t2.maybe_restore()
        tail = t2.run()
        got = [h["loss"] for h in tail]
        ckpt_bytes = dir_bytes(d)
    if resumed != 2 or [h["step"] for h in tail] != [2, 3] or \
            got != want[2:]:
        raise AssertionError(f"train restart: resumed at {resumed}, steps "
                             f"{[h['step'] for h in tail]}, losses {got} "
                             f"against the uninterrupted {want[2:]}")
    secs = time.perf_counter() - t0
    print(f"train restart ({cfg.name}: d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, vocab "
          f"{cfg.vocab_size}): failed after step 2, restored at {resumed}, "
          f"losses {got} equal the uninterrupted run's; checkpoints "
          f"{ckpt_bytes:,} bytes kept; {secs:.1f} s")
    return dict(resumed_at=resumed, losses=want, continued=got,
                ckpt_bytes=ckpt_bytes, seconds=secs)


def check_fa_cases(cases, seed0: int, dev) -> dict:
    """Each (case, q scale) of `cases`, (B, H, K, S, D, dtype, causal,
    window, prefix, softcap, views), through `attention` against the
    plain version: it moves its route's count by one and holds FA_TOL
    (and, bf16, FA_MEAN_REL / FA_MAX_REL). Returns the cases by route,
    max |error| by type and the largest bf16 relative readings."""
    err = {"float32": 0.0, "bfloat16": 0.0}
    rel = {"mean_rel": 0.0, "max_rel": 0.0}
    n = {"sm90": 0, "simt": 0}
    for i, (case, q_scale) in enumerate(cases):
        B, H, K, S, D, dt, causal, window, prefix, cap, views = case
        q, k, v = fa_inputs(B, H, K, S, D, dt, seed0 + i, dev, views=views,
                            q_scale=q_scale)
        mask = dict(causal=causal, softcap=cap, window=window,
                    prefix_len=prefix)
        before = (fa.launches_sm90, fa.launches_simt)
        got = fa.attention(q, k, v, **mask)
        torch.cuda.synchronize()
        route = "sm90" if dt == "bfloat16" else "simt"
        moved = (fa.launches_sm90 - before[0], fa.launches_simt - before[1])
        if moved != ((1, 0) if route == "sm90" else (0, 1)):
            raise AssertionError(f"flash_attention mask {case}: route counts "
                                 f"moved {moved}, expected one {route}")
        e, mean_rel, max_rel = fa_compare(f"mask {case} q x{q_scale:g}", got,
                                          fa.attention_plain(q, k, v, **mask),
                                          dt)
        n[route] += 1
        err[dt] = max(err[dt], e)
        if dt == "bfloat16":
            rel = {"mean_rel": max(rel["mean_rel"], mean_rel),
                   "max_rel": max(rel["max_rel"], max_rel)}
    return dict(cases=n, max_abs_err=err, bf16_relative_err=rel)


def phase_fa_masks(dev) -> dict:
    """Both kernels against the plain version on every mask of
    FA_MASK_CASES, and on FA_HOT_SHAPES with a window and a prefix (q
    scaled by FA_HOT_SCALE)."""
    cases = [(c, 1.0) for c in FA_MASK_CASES]
    for B, H, K, S, D, dt, causal, cap, views in FA_HOT_SHAPES:
        cases += [((B, H, K, S, D, dt, causal, S // 3, 0, cap, views),
                   FA_HOT_SCALE),
                  ((B, H, K, S, D, dt, causal, None, S // 4, cap, views),
                   FA_HOT_SCALE)]
    out = check_fa_cases(cases, 500, dev)
    n, err, rel = out["cases"], out["max_abs_err"], out["bf16_relative_err"]
    print(f"flash_attention masks: {n['sm90']} bf16 cases (sm90) and "
          f"{n['simt']} f32 cases (simt) equal the plain version (D 64, 80,"
          f" 128, 256; windows 1-4096, prefixes 64-4096, bidirectional with "
          f"and without a window, hot softcaps); max abs err {err}, bf16 "
          f"mean |err| / mean |want| <= {rel['mean_rel']:.3g}, max |err| / "
          f"max |want| <= {rel['max_rel']:.3g}")
    return out


def fa_mask_times(dev) -> dict:
    """Per launch on the paths' own shapes: the tensor-core kernel (ms by
    the profiler, call ms), the plain version, the bound over the allowed
    pairs, and SDPA with a boolean attn_mask and no softcap (a yardstick,
    never on the path): gemma2-2b's local (window 4096) and global layers
    at S 8192, paligemma-3b's prefix layer, hubert-xlarge's D = 80."""
    shapes = {
        "gemma2_local_8192": (1, 8, 4, 8192, 256, True, 4096, 0, 50.0),
        "gemma2_global_8192": (1, 8, 4, 8192, 256, True, None, 0, 50.0),
        "paligemma_prefix_2048": (4, 8, 1, 2048, 256, True, None, 256, None),
        "hubert_d80_1024": (8, 16, 16, 1024, 80, False, None, 0, None)}
    out = {}
    for name, (B, H, K, S, D, causal, window, prefix, cap) in shapes.items():
        q, k, v = fa_inputs(B, H, K, S, D, "bfloat16", 9, dev, views=True)
        mask = dict(causal=causal, softcap=cap, window=window,
                    prefix_len=prefix)
        allowed = fa.allowed_mask(S, S, causal, window, prefix, dev)
        launch = lambda: fa.attention_cuda(q, k, v, **mask)
        plain = lambda: fa.attention_plain(q, k, v, **mask)
        library = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=allowed, enable_gqa=True)
        bytes_ms, ops_ms = fa_bound(B, H, K, S, D, "bfloat16", causal,
                                    window, prefix)
        bound_ms, bound_by = bound_of(bytes_ms, ops_ms)
        t = dict(shape=dict(B=B, H=H, K=K, S=S, D=D, causal=causal,
                            window=window, prefix_len=prefix, softcap=cap),
                 pairs=fa_pairs(S, causal, window, prefix),
                 ms=kernel_ms(launch, 20, "flash_attention_sm90_kernel"),
                 call_ms=cuda_ms(launch, 10), plain_ms=cuda_ms(plain, 2),
                 library_ms=cuda_ms(library, 10), bytes_ms=bytes_ms,
                 ops_ms=ops_ms, bound_ms=bound_ms, bound_by=bound_by)
        t["bound_share"] = bound_ms / t["ms"]
        out[name] = t
        print(f"flash_attention {name} {t['shape']}: {t['pairs']:,} allowed "
              f"pairs a head; tensor-core kernel {t['ms']:.4f} ms (call "
              f"{t['call_ms']:.4f}; {t['bound_share']:.3f} of the bound "
              f"{bound_ms:.5f} ms, {bound_by}), plain {t['plain_ms']:.3f} ms,"
              f" SDPA with the boolean mask, no softcap (yardstick) "
              f"{t['library_ms']:.4f} ms")
    return out


class CapturedLaunches:
    """Wraps `flash_attention._launch` while a path runs: records every
    launch's (route, window, prefix_len) and keeps q, k, v and the output
    of the first launch with a window and the first without one, as the
    path's own launches gave them."""

    def __init__(self):
        self.inner, self.masks, self.held = fa._launch, [], {}

    def __enter__(self):
        def keep(route, q, k, v, causal, softcap, window=None,
                 prefix_len=0):
            out = self.inner(route, q, k, v, causal, softcap, window,
                             prefix_len)
            self.masks.append((route, window, prefix_len))
            kind = "local" if window is not None else "global"
            if kind not in self.held:
                self.held[kind] = (q.clone(), k.clone(), v.clone(),
                                   out.clone(), dict(
                                       causal=causal, softcap=softcap,
                                       window=window, prefix_len=prefix_len))
            return out

        fa._launch = keep
        return self

    def __exit__(self, *exc):
        fa._launch = self.inner
        return False

    def check(self, what) -> dict:
        """Each held launch against the plain version on its own
        tensors."""
        out = {}
        for kind, (q, k, v, got, mask) in self.held.items():
            want = fa.attention_plain(q, k, v, **mask)
            e, mean_rel, max_rel = fa_compare(f"{what} {kind} launch", got,
                                              want, "bfloat16")
            out[kind] = dict(max_abs_err=e, mean_rel=mean_rel,
                             max_rel=max_rel, window=mask["window"],
                             prefix_len=mask["prefix_len"])
            del want
        self.held.clear()
        torch.cuda.empty_cache()
        return out


def engine_path(spec, dev) -> dict:
    """One Engine path at full width (gemma2-2b past its window, olmoe,
    paligemma; phase 24's configs, cut in depth where the spec gives
    `n_layers`): build (its peak memory), the counted first generate
    (every count set to 0 just before, read just after; each launch's
    mask recorded, the first launch with a window and the first without
    one held against the plain version on their own tensors), a warm
    prefill, a warm generate (the same tokens; its time past the prefill
    gives decode ms a token), one profiled generate (of the spec's
    `profile_tokens` only, if it gives them, against that generate's own
    unprofiled warm wall), peak memory."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    base = get_config(spec["arch"])
    cfg = dataclasses.replace(base, n_layers=spec.get("n_layers",
                                                      base.n_layers))
    B, P, T = spec["batch"], spec["prompt"], spec["tokens"]
    torch.cuda.reset_peak_memory_stats()
    eng, build_s = synced(lambda: Engine.build(cfg, max_seq=P + T, seed=0,
                                               device=dev))
    build_peak = torch.cuda.max_memory_allocated()
    batch = make_batch(cfg, B, P, "prefill", seed=0, device=dev)
    n_params = n_elements(eng.params)
    torch.cuda.reset_peak_memory_stats()
    cap = CapturedLaunches()
    reset_counts()
    with cap:
        toks, first_s = synced(lambda: eng.generate(batch, T))
    counts = fa_counts()
    peak = torch.cuda.max_memory_allocated()
    if (counts["flash_attention"], counts["flash_attention_sm90"]) != (
            cfg.n_layers, cfg.n_layers):
        raise AssertionError(f"{cfg.name}: flash-attention launches {counts},"
                             f" expected {cfg.n_layers}, all sm90")
    want = [("sm90", s.window, s.prefix_len) for s in layer_specs(
        cfg, cfg.vision.n_patches if cfg.vision else 0)]
    if cap.masks != want:
        raise AssertionError(f"{cfg.name}: launch masks {cap.masks}, "
                             f"expected {want}")
    if toks.shape != (B, T) or toks.min() < 0 or toks.max() >= \
            cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: tokens {toks.shape} outside the "
                             f"vocabulary")
    held = cap.check(cfg.name)
    (logits, cache), prefill_s = synced(
        lambda: eng.model.prefill(eng.params, batch, P + T))
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: prefill logits not all finite")
    del logits, cache
    toks2, warm_s = synced(lambda: eng.generate(batch, T))
    if not (toks2 == toks).all():
        raise AssertionError(f"{cfg.name}: the warm generate's tokens "
                             f"differ from the first's")
    T_prof = spec.get("profile_tokens", T)
    prof_s = warm_s if T_prof == T else \
        synced(lambda: eng.generate(batch, T_prof))[1]
    prof = phase_profile(lambda: eng.generate(batch, T_prof),
                         f"{cfg.name} generate (B {B}, prompt {P}, {T_prof} "
                         f"tokens)", prof_s)
    out = dict(layers=cfg.n_layers, full_layers=base.n_layers,
               params=n_params, build_s=build_s,
               build_peak_memory_bytes=build_peak, generate_first_s=first_s,
               generate_warm_s=warm_s, prefill_ms=1e3 * prefill_s,
               decode_ms_per_token=1e3 * (warm_s - prefill_s) / T,
               tokens_per_s=B * T / warm_s,
               prompt_tokens_per_s=B * P / warm_s, peak_memory_bytes=peak,
               counts=counts, launch_masks=list(dict.fromkeys(cap.masks)),
               held_launches=held, profile_tokens=T_prof, profile=prof,
               idle_share=prof["idle_share"],
               kernel_share=prof["flash_attention_ms"]
               / prof["device_busy_ms"], tokens_head=toks[:, :8].tolist(),
               seconds=time.perf_counter() - t0)
    print(f"{cfg.name} ({cfg.n_layers} of {base.n_layers} layers, "
          f"{n_params:,} parameters; B {B}, prompt {P}, {T} tokens): build "
          f"{build_s:.2f} s (peak {build_peak / 2**30:.2f} GiB); generate "
          f"first {first_s:.3f} s, warm {warm_s:.3f} s = "
          f"{out['tokens_per_s']:.1f} tokens/s; prefill "
          f"{out['prefill_ms']:.2f} ms; decode "
          f"{out['decode_ms_per_token']:.3f} ms a token; peak device memory "
          f"{peak / 2**30:.2f} GiB; idle share {prof['idle_share']:.3f} "
          f"(prompt and {T_prof} tokens); launches {counts}, masks "
          f"{out['launch_masks']}; held launches {held}; "
          f"{out['seconds']:.1f} s")
    del eng, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def encoder_path(dev) -> dict:
    """hubert-xlarge's Model.forward at full width (ENCODER), bf16
    weights: the counted first forward (48 launches at D = 80, causal off;
    the first held against the plain version), a warm forward, one
    profiled, frames/s and peak memory."""
    cfg = get_config(ENCODER["arch"])
    B, S = ENCODER["batch"], ENCODER["frames"]
    model = model_lib.build(cfg)
    params, build_s = synced(lambda: cast_weights(
        model.init(seed=0, device=dev), getattr(torch, cfg.compute_dtype)))
    batch = make_batch(cfg, B, S, "prefill", seed=0, device=dev)
    torch.cuda.reset_peak_memory_stats()
    cap = CapturedLaunches()
    fwd = lambda: model.forward(params, batch)[0]
    reset_counts()
    with torch.no_grad(), cap:
        logits, first_s = synced(fwd)
    counts = fa_counts()
    peak = torch.cuda.max_memory_allocated()
    if (counts["flash_attention"], counts["flash_attention_sm90"]) != (
            cfg.n_layers, cfg.n_layers) or set(cap.masks) != {
                ("sm90", None, 0)}:
        raise AssertionError(f"{cfg.name}: launches {counts}, masks "
                             f"{set(cap.masks)}")
    if tuple(logits.shape) != (B, S, padded_vocab(cfg)) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: logits {tuple(logits.shape)}, "
                             f"not all finite")
    held = cap.check(cfg.name)
    with torch.no_grad():
        logits2, warm_s = synced(fwd)
        if not torch.equal(logits2, logits):
            raise AssertionError(f"{cfg.name}: the warm forward differs")
        del logits2
        prof = phase_profile(fwd, f"{cfg.name} forward (B {B}, {S} "
                             f"frames)", warm_s)
    out = dict(params=n_elements(params), build_s=build_s,
               forward_first_s=first_s, forward_warm_s=warm_s,
               frames_per_s=B * S / warm_s, peak_memory_bytes=peak,
               counts=counts, held_launches=held, profile=prof,
               kernel_share=prof["flash_attention_ms"]
               / prof["device_busy_ms"])
    print(f"{cfg.name} ({out['params']:,} parameters; B {B} x {S} frames): "
          f"forward first {first_s:.3f} s, warm {warm_s:.4f} s = "
          f"{out['frames_per_s']:.0f} frames/s; peak device memory "
          f"{peak / 2**30:.2f} GiB; idle share {prof['idle_share']:.3f}; "
          f"launches {counts}; held launch {held}")
    del params, batch, logits
    torch.cuda.empty_cache()
    return out


def phase_family_check(dev) -> dict:
    """Each new family cut to CHECK_FAMILY["layers"] layers at full width,
    f32 compute, the same seeded weights on the card (SIMT route) and on
    the CPU (plain path): olmoe and paligemma through step_compare,
    hubert's forward logits."""
    c = CHECK_FAMILY
    out = {}
    for arch in ("olmoe-1b-7b", "paligemma-3b", "hubert-xlarge"):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=c["layers"],
                                  compute_dtype="float32")
        params = model_lib.build(cfg).init(seed=1, device=dev)
        reset_counts()
        if cfg.has_decode:
            P = c["prompt"] + (cfg.vision.n_patches if cfg.vision else 0)
            batch = make_batch(cfg, c["batch"], P, "prefill", seed=1,
                               device="cpu")
            max_seq = P + c["tokens"]
            card = Engine.build(cfg, max_seq=max_seq, params=params,
                                device=dev)
            host = Engine.build(cfg, max_seq=max_seq, params=params,
                                device="cpu")
            del params
            err, clear = step_compare(cfg, card, host, batch, max_seq,
                                      c["tokens"], c["tol"])
            del card, host
        else:
            batch = make_batch(cfg, c["batch"], c["frames"], "prefill",
                               seed=1, device="cpu")
            host = to_host(params)
            with torch.no_grad():
                lg = model_lib.build(cfg).forward(
                    params, {k: v.to(dev) for k, v in batch.items()})[0]
                lc = model_lib.build(cfg).forward(host, batch)[0]
            err = float((lg.cpu() - lc).abs().max())
            if not torch.allclose(lg.cpu(), lc, rtol=c["tol"],
                                  atol=c["tol"]):
                raise AssertionError(f"family check {arch}: card logits "
                                     f"{err:.3g} off the CPU's")
            clear = None
            del params, host, lg, lc
        counts = fa_counts()
        if (counts["flash_attention"], counts["flash_attention_simt"]) != (
                cfg.n_layers, cfg.n_layers):
            raise AssertionError(f"family check {arch}: launches {counts}, "
                                 f"expected {cfg.n_layers} on the simt "
                                 f"route")
        torch.cuda.empty_cache()
        out[arch] = dict(max_logit_err=err, clear_choices=clear,
                         seconds=time.perf_counter() - t0,
                         simt_launches=counts["flash_attention_simt"])
        print(f"family check {arch} ({c['layers']} layers, full width, f32):"
              f" card equals the CPU's plain path, max logit err {err:.3g} "
              f"(tol {c['tol']}); clear greedy choices {clear}; "
              f"{out[arch]['seconds']:.1f} s")
    return out


def phase_masks_families(dev) -> dict:
    """Phase 17: the masks and head dim 80 in both kernels, the paths'
    own launches held, the four full-width paths, the 2-layer checks."""
    t0 = time.perf_counter()
    out = dict(masks=phase_fa_masks(dev), times=fa_mask_times(dev),
               check=phase_family_check(dev))
    out["window_serve"] = engine_path(WINDOW_SERVE, dev)
    for spec in FAMILY_SERVE:
        out[spec["arch"]] = engine_path(spec, dev)
    out[ENCODER["arch"]] = encoder_path(dev)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 17: {out['seconds']:.1f} s")
    return out


def fa_path_times(dev, shape, seed, label) -> dict:
    """A path's causal launch `shape` (B, H, K, S, D), bf16, the model's
    strided views: the first launch through `attention` moves the sm90
    count by one and is held against the plain version (the bf16
    criteria); the tensor-core kernel (ms by the profiler, call ms), the
    plain version, the bound over the causal pairs, and the yardstick
    SDPA(is_causal=True, enable_gqa=True), which the port never calls."""
    B, H, K, S, D = shape
    q, k, v = fa_inputs(B, H, K, S, D, "bfloat16", seed, dev, views=True)
    launch = lambda: fa.attention_cuda(q, k, v, causal=True)
    plain = lambda: fa.attention_plain(q, k, v, causal=True)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)
    before = (fa.launches_sm90, fa.launches_simt)
    got = fa.attention(q, k, v, causal=True)
    moved = (fa.launches_sm90 - before[0], fa.launches_simt - before[1])
    if moved != (1, 0):
        raise AssertionError(f"flash_attention {label} {shape}: route counts "
                             f"moved {moved}, expected one sm90 launch")
    e, mean_rel, max_rel = fa_compare(f"{label} {shape}", got, plain(),
                                      "bfloat16")
    del got
    bytes_ms, ops_ms = fa_bound(B, H, K, S, D, "bfloat16", True)
    bound_ms, bound_by = bound_of(bytes_ms, ops_ms)
    out = dict(shape=dict(B=B, H=H, K=K, S=S, D=D, group=H // K,
                          causal=True, softcap=None),
               pairs=fa_pairs(S, True, None, 0),
               ms=kernel_ms(launch, 20, "flash_attention_sm90_kernel"),
               call_ms=cuda_ms(launch, 20), plain_ms=cuda_ms(plain, 3),
               library_ms=cuda_ms(library, 20), bytes_ms=bytes_ms,
               ops_ms=ops_ms, bound_ms=bound_ms, bound_by=bound_by,
               max_abs_err=e, mean_rel=mean_rel, max_rel=max_rel)
    out["bound_share"] = bound_ms / out["ms"]
    out["tflops"] = ops_ms * BF16_TENSOR_OPS_PER_S / 1e12 / out["ms"]
    print(f"flash_attention {label} at {shape} (group {H // K}), causal: "
          f"sm90 kernel equals the plain version, max abs err {e:.3g}, "
          f"mean |err| / mean |want| {mean_rel:.3g}, max |err| / max |want| "
          f"{max_rel:.3g}; kernel {out['ms']:.4f} ms (call "
          f"{out['call_ms']:.4f}; {out['tflops']:.1f} TFLOP/s, "
          f"{out['bound_share']:.3f} of the bound {bound_ms:.5f} ms, "
          f"{bound_by}; bytes {bytes_ms:.5f}), plain {out['plain_ms']:.3f} "
          f"ms, SDPA is_causal enable_gqa (yardstick) "
          f"{out['library_ms']:.4f} ms")
    del q, k, v
    torch.cuda.empty_cache()
    return out


def tree_leaves_named(tree, name=""):
    """(path, tensor) of every tensor of a cache (dicts, lists, tuples)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_named(v, f"{name}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_named(v, f"{name}/{i}")
    else:
        yield name, tree


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, dev) for v in tree)
    return tree.to(dev)


def compare_caches(got, want, tol: float, what: str) -> dict:
    """The card's cache (got) against the CPU's: f32 leaves within tol of
    each tensor's largest value; bf16 leaves elementwise within that and
    one bf16 ulp of the value (the f32 values before the cast may differ
    by tol, and one near a rounding boundary then rounds the other way);
    integer leaves equal. Returns the worst f32 error (relative to its
    tensor's max) and the bf16 elements that differ."""
    worst, flips = 0.0, 0
    for (name, g), (_, w) in zip(tree_leaves_named(got),
                                 tree_leaves_named(want), strict=True):
        g = g.cpu()
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{what} cache {name}: {g.dtype} "
                                 f"{tuple(g.shape)} against {w.dtype} "
                                 f"{tuple(w.shape)}")
        if g.dtype == torch.float32:
            err = float((g - w).abs().max() / max(float(w.abs().max()),
                                                  1e-30))
            if err > tol:
                raise AssertionError(f"{what} cache {name}: f32 error "
                                     f"{err:.3g} of its max (tol {tol})")
            worst = max(worst, err)
        elif g.dtype == torch.bfloat16:
            gf, wf = g.float(), w.float()
            mag = torch.maximum(gf.abs(), wf.abs()).clamp_min(
                torch.finfo(torch.float32).tiny)
            ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
            if not bool(((gf - wf).abs() <= ulp + tol * float(
                    wf.abs().max())).all()):
                raise AssertionError(f"{what} cache {name}: a bf16 element "
                                     f"more than one ulp and tol off the "
                                     f"CPU's")
            flips += int((gf != wf).sum())
        elif not torch.equal(g, w):
            raise AssertionError(f"{what} cache {name}: differs")
    return dict(f32_rel_err=worst, bf16_ulp_flips=flips)


def ssm_step_compare(cfg, card, host, batch, max_seq, n_tokens, tol):
    """Prefill `batch` (CPU tensors), then n_tokens decode steps fed the
    host's greedy choice, on the card and on the CPU. At every step the
    logits within `tol` and the caches by `compare_caches`; each card
    decode step starts from the CPU's cache, so that a bf16 state element
    rounded the other way in an earlier step does not count against the
    card's arithmetic. The card's run from its own caches is recorded
    beside it (its max logit error, not held). Returns (max logit error,
    clear choices, free-running max logit error, worst cache readings)."""
    dev = card.params["embed"].device
    on_card = {k: x.to(dev) for k, x in batch.items()}
    lg, cg = card.model.prefill(card.params, on_card, max_seq)
    lc, cc = host.model.prefill(host.params, batch, max_seq)
    free, cfree = lg, tree_to(cg, dev)
    worst, clear, free_err = 0.0, 0, 0.0
    caches = dict(f32_rel_err=0.0, bf16_ulp_flips=0)
    for step in range(n_tokens + 1):
        err, sure, tok_c = held_step(cfg, step, lg, lc, tol, "ssm check")
        worst, clear = max(worst, err), clear + sure
        free_err = max(free_err, float((free.cpu() - lc).abs().max()))
        got = compare_caches(cg, cc, tol, f"ssm check step {step}")
        caches = {k: max(v, got[k]) for k, v in caches.items()}
        if step == n_tokens:
            break
        free, cfree = card.model.decode_step(card.params, tok_c.to(dev),
                                             cfree)
        lg, cg = card.model.decode_step(card.params, tok_c.to(dev),
                                        tree_to(cc, dev))
        lc, cc = host.model.decode_step(host.params, tok_c, cc)
    return worst, clear, free_err, caches


def cut_config(arch: str, cut: dict):
    """`arch`'s full-width config in f32 compute at the depth of `cut`
    (n_layers, and for the hybrid its shared_attn_every)."""
    base = get_config(arch)
    kw = dict(n_layers=cut["n_layers"], compute_dtype="float32")
    if "shared_attn_every" in cut:
        kw["hybrid"] = dataclasses.replace(
            base.hybrid, shared_attn_every=cut["shared_attn_every"])
    return dataclasses.replace(base, **kw)


def phase_ssm_check(dev) -> dict:
    """mamba2-2.7b and zamba2-7b cut in depth (CHECK_SSM["cuts"]) at full
    width, f32 compute, the same seeded weights on the card and on the
    CPU (plain path): prefill and 3 decode steps through
    ssm_step_compare. mamba2 launches no flash attention; zamba2's one
    launch a prefill takes the f32 (simt) route."""
    c = CHECK_SSM
    out = {}
    for arch, cut in c["cuts"].items():
        t0 = time.perf_counter()
        cfg = cut_config(arch, cut)
        params = model_lib.build(cfg).init(seed=1, device=dev)
        max_seq = c["prompt"] + c["tokens"]
        card = Engine.build(cfg, max_seq=max_seq, params=params, device=dev)
        host = Engine.build(cfg, max_seq=max_seq, params=params,
                            device="cpu")
        del params
        reset_counts()
        batch = make_batch(cfg, c["batch"], c["prompt"], "prefill", seed=1,
                           device="cpu")
        err, clear, free_err, caches = ssm_step_compare(
            cfg, card, host, batch, max_seq, c["tokens"], c["tol"])
        counts = fa_counts()
        want = 0 if cfg.hybrid is None else \
            cfg.n_layers // cfg.hybrid.shared_attn_every
        if (counts["flash_attention"], counts["flash_attention_simt"]) != (
                want, want):
            raise AssertionError(f"ssm check {arch}: launches {counts}, "
                                 f"expected {want} on the simt route")
        del card, host
        torch.cuda.empty_cache()
        out[arch] = dict(layers=cfg.n_layers, max_logit_err=err,
                         clear_choices=clear, simt_launches=want,
                         free_running_max_logit_err=free_err, caches=caches,
                         seconds=time.perf_counter() - t0)
        print(f"ssm check {arch} ({cfg.n_layers} layers, full width, f32, "
              f"B {c['batch']}, prompt {c['prompt']}, {c['tokens']} decode "
              f"steps): card equals the CPU's plain path, max logit err "
              f"{err:.3g} (tol {c['tol']}); caches: f32 within "
              f"{caches['f32_rel_err']:.3g} of their max, up to "
              f"{caches['bf16_ulp_flips']} bf16 elements one ulp off; from "
              f"its own caches the card's logits are {free_err:.3g} off; "
              f"{clear} clear greedy choices equal; {want} simt launches; "
              f"{out[arch]['seconds']:.1f} s")
    return out


@contextlib.contextmanager
def ssm_ranges():
    """Each function of SSM_RANGES runs inside a profiler range named
    `ssm:<range>` while the context is open."""
    saved = []
    for label, mod, name in SSM_RANGES:
        inner = getattr(mod, name)

        def ranged(*args, _inner=inner, _label=label, **kw):
            with torch.profiler.record_function(f"ssm:{_label}"):
                return _inner(*args, **kw)

        saved.append((mod, name, inner))
        setattr(mod, name, ranged)
    try:
        yield
    finally:
        for mod, name, inner in saved:
            setattr(mod, name, inner)


def ssm_op_split(fn, label: str) -> dict:
    """Device ms of one fn() by op: the Mamba2 projections, the SSD
    intra-chunk work, the chunk states and recurrence, the shared
    attention block (its flash-attention kernel also apart), and the
    rest; from one torch.profiler pass with the host's activity, each
    range's device time being that of the kernels launched inside it (the
    host range's children)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with ssm_ranges(), profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    # the device's kernels; each range also shows as a user annotation on
    # the device's timeline, which spans its kernels and is left out
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("ssm:")]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    out = {lab: sum(e.device_time_total for e in rows
                    if e.key == f"ssm:{lab}"
                    and e.device_type == DeviceType.CPU) / 1e3
           for lab in dict.fromkeys(r[0] for r in SSM_RANGES)}
    out["flash_attention"] = sum(e.device_time_total for e in kernels
                                 if "flash_attention" in e.key) / 1e3
    ranged = sum(out[lab] for lab in dict.fromkeys(r[0] for r in SSM_RANGES))
    if busy <= 0 or ranged <= 0 or ranged > 1.001 * busy:
        raise AssertionError(f"ssm op split {label}: busy {busy} ms, ranges "
                             f"{out}: the ranges' device time is not a part "
                             f"of the busy time")
    out["other"] = busy - ranged
    out["device_busy_ms"] = busy
    print(f"ssm op split {label}: device busy {busy:.3f} ms: " + ", ".join(
        f"{k} {v:.3f} ms ({v / busy:.3f})" for k, v in out.items()
        if k != "device_busy_ms"))
    return out


def ssm_engine_path(spec, dev) -> dict:
    """One full-width Engine path of phase 18 (c): build, the counted first
    generate (every count set to 0 just before, read just after: 0 flash
    launches for mamba2, one sm90 launch a group for zamba2, the first
    held against the plain version on its own tensors), a warm generate
    (the same tokens), warm prefill and decode ms, one profiled generate
    (idle share), and the busy time of a prefill and of one decode step
    by op."""
    base = get_config(spec["arch"])
    cfg = dataclasses.replace(base, n_layers=spec.get("n_layers",
                                                      base.n_layers))
    B, P, T = spec["batch"], spec["prompt"], spec["tokens"]
    eng, build_s = synced(lambda: Engine.build(cfg, max_seq=P + T, seed=0,
                                               device=dev))
    batch = make_batch(cfg, B, P, "prefill", seed=0, device=dev)
    n_params = n_elements(eng.params)
    want = 0 if cfg.hybrid is None else \
        cfg.n_layers // cfg.hybrid.shared_attn_every
    torch.cuda.reset_peak_memory_stats()
    cap = CapturedLaunches()
    reset_counts()
    with cap:
        toks, first_s = synced(lambda: eng.generate(batch, T))
    counts = fa_counts()
    peak = torch.cuda.max_memory_allocated()
    if (counts["flash_attention"], counts["flash_attention_sm90"]) != (
            want, want) or cap.masks != [("sm90", None, 0)] * want:
        raise AssertionError(f"{cfg.name}: flash-attention launches {counts},"
                             f" masks {cap.masks}; expected {want} causal "
                             f"sm90 launches")
    if toks.shape != (B, T) or toks.min() < 0 or toks.max() >= \
            cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: tokens {toks.shape} outside the "
                             f"vocabulary")
    held = cap.check(cfg.name)
    toks2, warm_s = synced(lambda: eng.generate(batch, T))
    if not (toks2 == toks).all():
        raise AssertionError(f"{cfg.name}: the warm generate's tokens "
                             f"differ from the first's")
    prefill = lambda: eng.model.prefill(eng.params, batch, P + T)
    warm = sorted(synced(prefill)[1] for _ in range(3))
    (logits, cache), _ = synced(prefill)

    def decode_all():
        nonlocal logits, cache
        for _ in range(T):
            tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1).to(
                torch.int32)
            logits, cache = eng.model.decode_step(eng.params, tok, cache)

    _, decode_s = synced(decode_all)
    del logits, cache
    prof = phase_profile(lambda: eng.generate(batch, T),
                         f"{cfg.name} generate (B {B}, prompt {P}, {T} "
                         f"tokens)", warm_s)
    split_prefill = ssm_op_split(prefill, f"{cfg.name} prefill")
    logits, cache = prefill()
    tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1).to(
        torch.int32)
    split_decode = ssm_op_split(
        lambda: eng.model.decode_step(eng.params, tok, cache),
        f"{cfg.name} one decode step")
    del logits, cache
    out = dict(layers=cfg.n_layers, full_layers=base.n_layers,
               params=n_params, build_s=build_s, generate_first_s=first_s,
               generate_warm_s=warm_s, tokens_per_s=B * T / warm_s,
               prefill_warm_ms=1e3 * warm[1],
               prompt_tokens_per_s=B * P / warm[1],
               decode_ms_per_token=1e3 * decode_s / T,
               peak_memory_bytes=peak, counts=counts, held_launches=held,
               profile=prof, op_split_prefill=split_prefill,
               op_split_decode_step=split_decode,
               tokens_head=toks[:, :8].tolist())
    print(f"{cfg.name} ({cfg.n_layers} of {base.n_layers} layers, "
          f"{n_params:,} parameters; B {B}, prompt {P}, {T} tokens): build "
          f"{build_s:.2f} s; generate first {first_s:.3f} s, "
          f"warm {warm_s:.3f} s = {out['tokens_per_s']:.1f} tokens/s; "
          f"prefill warm {out['prefill_warm_ms']:.1f} ms; decode "
          f"{out['decode_ms_per_token']:.2f} ms a token; peak device memory "
          f"{peak / 2**30:.2f} GiB; idle share {prof['idle_share']:.3f}; "
          f"launches {counts}; held launches {held}")
    del eng, batch
    torch.cuda.empty_cache()
    return out


def phase_ssm(dev) -> dict:
    """Phase 18: head dim 112 in both kernels (every mask, the hot cases,
    ptxas's report, zamba2-7b's launch timed), the two families cut in
    depth card against the CPU, and both at full width through the
    Engine."""
    t0 = time.perf_counter()
    regs = {r: ptxas_report(src, marker) for r, (src, marker) in {
        "sm90": ("flash_attention_sm90", "Li112E"),
        "simt_bf16": ("flash_attention", "I13__nv_bfloat16Li112E"),
        "simt_f32": ("flash_attention", "IfLi112E")}.items()}
    print(f"  ptxas at D 112: {regs}; tensor-core dynamic shared memory "
          f"{fa.SM90_SMEM_BYTES[112]} bytes")
    cases = [(c, 1.0) for c in FA_D112_CASES] + [
        (c, FA_HOT_SCALE) for c in FA_D112_HOT]
    masks = check_fa_cases(cases, 800, dev)
    n, rel = masks["cases"], masks["bf16_relative_err"]
    print(f"flash_attention D 112: {n['sm90']} bf16 cases (sm90) and "
          f"{n['simt']} f32 cases (simt) equal the plain version (every "
          f"mask, 1-32 kv heads, views, hot softcaps); max abs err "
          f"{masks['max_abs_err']}, bf16 mean |err| / mean |want| <= "
          f"{rel['mean_rel']:.3g}, max |err| / max |want| <= "
          f"{rel['max_rel']:.3g}")
    out = dict(registers=regs, smem_bytes=fa.SM90_SMEM_BYTES[112],
               masks=masks,
               times=fa_path_times(dev, FA_D112_PATH, 11, "D 112"),
               check=phase_ssm_check(dev))
    for spec in SSM_SERVE:
        out[spec["arch"]] = ssm_engine_path(spec, dev)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 18: {out['seconds']:.1f} s")
    return out


def check_grad_cases(cases, seed0: int, dev, dout_seed0=None) -> dict:
    """Each (case, q scale) of `cases` (check_fa_cases' tuples) through the
    differentiable `attention` on the card: the forward moves its route's
    count by one and holds fa_compare; dq, dk and dv hold fa_grad_compare
    against autograd through `attention_plain` on the same card (a zero
    where the plain version's value is not counts as lost unless the f64
    gradient is within rounding of 0 there: `excused_zeros`). Case i's
    inputs are seeded seed0 + i, its output gradient dout_seed0 + i
    (default seed0 + 10,000 + i). Returns the cases by route, the worst
    (mean, max) relative readings by type and the excused zeros."""
    dout_seed0 = seed0 + 10_000 if dout_seed0 is None else dout_seed0
    worst = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    n = {"sm90": 0, "simt": 0}
    excused = []
    for i, (case, q_scale) in enumerate(cases):
        B, H, K, S, D, dt, causal, window, prefix, cap, views = case
        q, k, v = fa_inputs(B, H, K, S, D, dt, seed0 + i, dev, views=views,
                            q_scale=q_scale)
        g = torch.Generator(device=dev)
        g.manual_seed(dout_seed0 + i)
        dout = torch.randn((B, H, S, D), generator=g, device=dev).to(q.dtype)
        mask = dict(causal=causal, softcap=cap, window=window,
                    prefix_len=prefix)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        before = (fa.launches_sm90, fa.launches_simt)
        out = fa.attention(*leaves, **mask)
        grads = torch.autograd.grad(out, leaves, dout)
        torch.cuda.synchronize()
        route = "sm90" if dt == "bfloat16" else "simt"
        moved = (fa.launches_sm90 - before[0], fa.launches_simt - before[1])
        if moved != ((1, 0) if route == "sm90" else (0, 1)):
            raise AssertionError(f"attention grad {case}: route counts moved "
                                 f"(sm90, simt) = {moved}, expected one "
                                 f"{route} launch (the forward)")
        plain = [x.detach().requires_grad_(True) for x in (q, k, v)]
        want_out = fa.attention_plain(*plain, **mask)
        want = torch.autograd.grad(want_out, plain, dout)
        fa_compare(f"{case} (forward under autograd)", out.detach(),
                   want_out.detach(), dt)
        ref = rounding_reference(q, k, v, dout, mask)
        for name, a, b in zip("qkv", grads, want):
            rel = fa_grad_compare(f"d{name} {case} q x{q_scale:g}", a, b, dt,
                                  exact=functools.partial(ref, name))
            worst[dt] = [max(worst[dt][0], rel[0]), max(worst[dt][1], rel[1])]
            if rel[2] is not None:
                excused.append(dict(rel[2], case=list(case), grad=f"d{name}"))
        n[route] += 1
        del q, k, v, dout, leaves, out, grads, plain, want_out, want, ref
    return dict(cases=n, worst_rel=worst, excused_zeros=excused)


def attention_layers(cfg) -> int:
    """The layers that call flash attention: every block of a transformer
    family, each group's application of the hybrid's shared block, none
    in ssm."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid.shared_attn_every
    return cfg.n_layers


def family_check_setup(arch: str, cut: dict):
    """A family check's config (`arch` at the depth of `cut`), model and
    host batch."""
    c = CHECK_TRAIN_FAMILIES
    cfg = cut_config(arch, cut)
    S = c["seq"] if cfg.vision is None else cfg.vision.n_patches + c["text"]
    batch = make_batch(cfg, c["batch"], S, "train", seed=5, device="cpu")
    return cfg, model_lib.build(cfg), batch


def train_family_check(arch: str, opts, dev, cuts=None, refs=None) -> dict:
    """(b) for one family and gradient path: one make_train_step on the
    card (the SIMT route: the forward and the remat recompute of each
    attention layer) and on the CPU from the same seeded weights
    (`cpu_reference`, from the worker of `refs`), held to
    CHECK_TRAIN_FAMILIES' limits; a leaf the loss does not use gets an
    all-zero gradient on both. `cuts` (default CHECK_TRAIN_FAMILIES')
    gives each arch's depth."""
    c = CHECK_TRAIN_FAMILIES
    cut = (cuts or c["cuts"])[arch]
    cfg, model, batch = family_check_setup(arch, cut)
    t0 = time.perf_counter()
    cpu = take_cpu_reference(refs, ("family", arch, tuple(opts),
                                    tuple(sorted(cut.items()))))
    t1 = time.perf_counter()
    start = cpu["init"]
    reset_counts()
    card_loss, card_norm, card_grads, card_params = check_step(
        model, tree_to(start, dev), batch, dev, c["lr"], opts)
    counts = fa_counts()
    want = 2 * attention_layers(cfg)
    if (counts["flash_attention_simt"], counts["flash_attention_sm90"]) != (
            want, 0):
        raise AssertionError(f"train check {arch} {sorted(opts)}: launches "
                             f"{counts}, expected {want} on the simt route "
                             f"(forward and recompute)")
    t2 = time.perf_counter()
    cpu_loss, cpu_norm, cpu_grads = cpu["loss"], cpu["norm"], cpu["grads"]
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    if not math.isfinite(card_loss) or loss_rel > c["loss_rtol"]:
        raise AssertionError(f"train check {arch}: loss {card_loss} on the "
                             f"card, {cpu_loss} on the CPU (rel "
                             f"{loss_rel:.3g})")
    bf16 = "bf16_grads" in opts
    norm_rel = abs(card_norm - cpu_norm) / cpu_norm
    if not math.isfinite(card_norm) or norm_rel > (c["bf16_tol"] if bf16
                                                   else c["tol"]):
        raise AssertionError(f"train check {arch}: grad_norm {card_norm} on "
                             f"the card, {cpu_norm} on the CPU")
    gtol = c["bf16_tol"] if bf16 else c["grad_tol"]
    grad_rel, grad_off = tree_worst(card_grads, cpu_grads, gtol,
                                    f"train check {arch}: gradient",
                                    count_past=c["tol"])
    zero = [".".join(map(str, path)) for path, g in
            ckpt.checkpoint.tree_leaves_with_paths(card_grads)
            if not bool(g.any())]
    cpu_zero = [".".join(map(str, path)) for path, g in
                ckpt.checkpoint.tree_leaves_with_paths(cpu_grads)
                if not bool(g.any())]
    if zero != cpu_zero or (cfg.audio is not None) != (zero == ["embed"]):
        raise AssertionError(f"train check {arch}: all-zero gradients {zero} "
                             f"on the card, {cpu_zero} on the CPU")
    cpu_adamw(c["lr"], card_grads, start)
    param_rel, _ = tree_worst(card_params, start, c["tol"],
                              f"train check {arch}: updated parameter "
                              f"(against the CPU's AdamW on the card's "
                              f"gradients)")
    out = dict(layers=cfg.n_layers, opts=sorted(opts), loss_card=card_loss,
               loss_cpu=cpu_loss, loss_rel=loss_rel, grad_norm_rel=norm_rel,
               grad_rel=grad_rel, grad_elements_past_tol=grad_off,
               param_rel=param_rel, zero_grads=zero,
               simt_launches=counts["flash_attention_simt"],
               seconds=time.perf_counter() - t0, card_s=t2 - t1,
               cpu_side_s=t1 - t0, cpu_wait_s=cpu["wait_s"],
               cpu_step_s=cpu["seconds"], cpu_step_where=cpu["where"],
               checks_s=time.perf_counter() - t2)
    print(f"train check {arch} ({cfg.n_layers} layers, full width, f32, "
          f"{sorted(opts) or 'in place'}): loss {card_loss:.6f} card, "
          f"{cpu_loss:.6f} CPU (rel {loss_rel:.3g}); grad_norm rel "
          f"{norm_rel:.3g}; gradients within {grad_rel:.3g} of each "
          f"tensor's max (tol {gtol:.3g}; {grad_off} elements past "
          f"{c['tol']}); all-zero gradients {zero}; "
          f"updated parameters within {param_rel:.3g} of the CPU's AdamW "
          f"on the card's gradients; {out['simt_launches']} simt launches; "
          f"{out['seconds']:.1f} s (the CPU's side {out['cpu_side_s']:.1f}, "
          f"of it waiting for its step {out['cpu_wait_s']:.1f} (the step "
          f"{out['cpu_step_s']:.1f} s in {out['cpu_step_where']}); card and "
          f"copies {out['card_s']:.1f}, checks {out['checks_s']:.1f})")
    return out


def matmul_params(cfg, params) -> float:
    """Parameters a token multiplies once in the forward: every weight of
    two or more dims but the embedding table, a moe expert's at top_k /
    n_experts (the active parameters), the hybrid's shared block once a
    group."""
    total = 0.0
    for path, x in ckpt.checkpoint.tree_leaves_with_paths(params):
        if x.dim() < 2 or path[0] == "embed":
            continue
        n = float(x.numel())
        if "moe" in path and path[-1] != "router":
            n *= cfg.moe.top_k / cfg.moe.n_experts
        if path[0] == "shared_attn":
            n *= attention_layers(cfg)
        total += n
    return total


def train_flops_per_step(cfg, params, seqs: int, seq: int) -> float:
    """Phase 16's formula for any family: 6 x matmul_params x tokens, plus
    3 x the attention products over the (query, key) pairs each
    attention layer's mask allows (forward and backward); the remat
    recompute and the SSD's own products not counted."""
    prefix = cfg.vision.n_patches if cfg.vision is not None else 0
    pairs = fa_pairs(seq, cfg.causal, cfg.sliding_window, prefix) \
        if attention_layers(cfg) else 0
    attn = attention_layers(cfg) * seqs * 4 * cfg.n_heads * cfg.head_dim * \
        pairs
    return 6 * matmul_params(cfg, params) * seqs * seq + 3 * attn


def depth_cut(spec, dev):
    """(config, its depth record): the family's full config, or for a
    `cut` spec the most layers (or hybrid groups, the tail kept) whose
    f32 parameters, gradients and AdamW moments (16 bytes a parameter,
    counted from models built on the card at depths 1 and 2) leave the
    spec's `headroom` bytes of the card, and at most its `units`."""
    cfg = get_config(spec["arch"])
    if "cut" not in spec:
        return cfg, None
    if spec["cut"] == "layers":
        full, layers_of = cfg.n_layers, lambda n: n
    else:
        per = cfg.hybrid.shared_attn_every
        full = cfg.n_layers // per
        tail = cfg.n_layers - full * per
        layers_of = lambda n: n * per + tail

    def count(n):
        p = model_lib.build(dataclasses.replace(
            cfg, n_layers=layers_of(n))).init(seed=0, device=dev)
        return n_elements(p)

    one, two = count(1), count(2)
    torch.cuda.empty_cache()
    unit, base = two - one, 2 * one - two
    total = torch.cuda.get_device_properties(dev).total_memory
    n = min(full, spec.get("units", full),
            (total - spec["headroom"] - 16 * base) // (16 * unit))
    cut = dataclasses.replace(cfg, n_layers=layers_of(n))
    return cut, dict(unit=spec["cut"], kept=int(n), full=full,
                     layers=cut.n_layers, full_layers=cfg.n_layers,
                     params_per_unit=unit, params_outside=base,
                     state_bytes=16 * (base + n * unit), card_bytes=total,
                     headroom_bytes=spec["headroom"])


def train_family(spec, dev) -> dict:
    """(c) for one family: FAMILY_STEPS steps at full width (depth cut
    where `spec` says), every count set to 0 just before (the Trainer's
    producer thread decides as soon as it exists) and read after the
    last:
    flash-attention launches 2 a layer, microbatch and step, all sm90;
    grid solve 5 a warm governor decision (Trainer) or none; losses
    finite and lower at the last step than at the first. First and warm
    step s,
    tokens (frames) a second, peak memory, MFU; one microbatch's warm
    step profiled (the device's activity only: idle share against its
    own unprofiled wall, top ops), and the attention gradient's call
    timed alone at the path's shape (its share of that step)."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg, cut = depth_cut(spec, dev)
    n_steps, n_micro = FAMILY_STEPS, TRAIN["n_micro"]
    decide_ms, governor_err = [], None
    if spec["via"] == "trainer":
        seqs, seq = TRAIN["global_batch"], TRAIN["seq_len"]
        tcfg = TrainerConfig(n_steps=n_steps, global_batch=seqs,
                             seq_len=seq, n_micro=n_micro,
                             n_data_shards=TRAIN["n_data_shards"],
                             data_cycle=TRAIN["data_cycle"],
                             speculative_input=True, log_every=1000)
        t, hist, counts, peak, build_s, decide_ms, specs = trainer_run(
            cfg, tcfg, dev)
        losses = [h["loss"] for h in hist]
        times = [h["time"] for h in hist]
        governor_err = check_governor(t.governor, specs)
        model, optimizer, state = t.model, t.optimizer, t.state
        batch = train_batch(tcfg, cfg, dev)
        step = make_train_step(model, optimizer, n_micro)
        del t
    else:
        seqs, seq = spec["batch"], spec["seq"]
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        model = model_lib.build(cfg)
        params, build_s = synced(lambda: model.init(seed=0, device=dev))
        optimizer = make_optimizer(cfg, lr=spec["lr"])
        state = TrainState(params, optimizer.init(params),
                           torch.zeros((), dtype=torch.int32, device=dev))
        del params
        step = make_train_step(model, optimizer, n_micro, cosine_schedule(
            base=1.0, warmup=10, total=n_steps))
        batch = make_batch(cfg, seqs, seq, "train", seed=0, device=dev)
        mask = torch.ones((n_micro,), device=dev)
        losses, times = [], []
        for _ in range(n_steps):
            (state, m), dt = synced(lambda: step(state, batch, mask))
            losses.append(float(m["loss"]))
            times.append(dt)
        counts = dict(fa_counts(), grid_solve=gs.launches, warm_decisions=0)
        peak = torch.cuda.max_memory_allocated()
    want_fa = 2 * attention_layers(cfg) * n_micro * n_steps
    n_chronos = len(names(kind="chronos"))
    want_gs = n_chronos * counts["warm_decisions"]
    if (counts["flash_attention"], counts["flash_attention_sm90"],
            counts["flash_attention_simt"]) != (want_fa, want_fa, 0) or \
            counts["grid_solve"] != want_gs or (
                spec["via"] == "trainer") != bool(counts["warm_decisions"]):
        raise AssertionError(f"train {cfg.name}: launches {counts}, expected "
                             f"{want_fa} sm90 flash-attention launches "
                             f"(forward and recompute of "
                             f"{attention_layers(cfg)} attention layers x "
                             f"{n_micro} microbatches x {n_steps} steps) and "
                             f"{n_chronos} grid solves a warm governor "
                             f"decision")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train {cfg.name}: losses {losses} (finite, "
                             f"and lower at the last step than at the "
                             f"first)")
    warm_s = sorted(times[1:])[len(times[1:]) // 2]
    # one microbatch's step (its forward, backward and one AdamW update),
    # timed warm, then profiled: a quarter of a step's device ops (a
    # whole mamba2 step has ~180,000, slow for the profiler to read back)
    t_prof = time.perf_counter()
    one = make_train_step(model, optimizer, 1)
    micro = {k: x[:seqs // n_micro] for k, x in batch.items()}
    mask = torch.ones((1,), device=dev)
    micro_s = min(synced(lambda: one(state, micro, mask))[1]
                  for _ in range(2))
    prof = phase_profile(lambda: one(state, micro, mask),
                         f"train {cfg.name} one microbatch's warm step",
                         micro_s)
    t_prof = time.perf_counter() - t_prof
    n_params = n_elements(state.params)
    flops = train_flops_per_step(cfg, state.params, seqs, seq)
    busy = prof["device_busy_ms"]
    out = dict(
        arch=spec["arch"], via=spec["via"], layers=cfg.n_layers,
        depth_cut=cut, params=n_params, batch=dict(seqs=seqs, seq=seq,
                                                   n_micro=n_micro),
        build_s=build_s, losses=losses, step_s=times, first_step_s=times[0],
        warm_step_s=warm_s, tokens_per_s=seqs * seq / warm_s,
        peak_memory_bytes=peak, counts=counts,
        flash_attention_predicted=want_fa, model_flops_per_step=flops,
        matmul_params=matmul_params(cfg, state.params),
        mfu=flops / warm_s / BF16_TENSOR_OPS_PER_S, profile=prof,
        top_shares=[dict(op=r["op"], share=r["ms"] / busy)
                    for r in prof["top"]],
        lr=spec.get("lr", TrainerConfig.lr), decide_ms_during_run=decide_ms,
        governor_grid_max_abs_err=governor_err, micro_step_s=micro_s,
        profile_s=t_prof)
    unit = "frames" if cfg.audio is not None else "tokens"
    print(f"train {cfg.name} via {spec['via']} ({cfg.n_layers} layers"
          f"{'' if cut is None else ' of ' + str(cut['full_layers'])}, "
          f"{n_params:,} parameters, f32; bf16 compute; {n_steps} steps of "
          f"{n_micro} x {seqs // n_micro} x {seq}): build {build_s:.2f} s; "
          f"losses {losses}; step s {times} (first {times[0]:.3f}, warm "
          f"{warm_s:.3f}); {out['tokens_per_s']:.0f} {unit}/s; peak device "
          f"memory {peak / 2**30:.2f} GiB; launches {counts} (flash "
          f"predicted {want_fa}); model FLOPs a step {flops:.4g}, MFU "
          f"{out['mfu']:.3f}; idle share {prof['idle_share']:.3f}; depth "
          f"{cut}")
    del state, batch, micro, step, one, model, optimizer, prof
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the gradient of one microbatch's attention call alone, at the
    # path's shape and mask (the model's strided views), and its share of
    # a step's busy time over every attention layer and microbatch
    if attention_layers(cfg):
        B = seqs // n_micro
        prefix = cfg.vision.n_patches if cfg.vision is not None else 0
        q, k, v = fa_inputs(B, cfg.n_heads, cfg.n_kv_heads, seq,
                            cfg.head_dim, "bfloat16", 17, dev, views=True)
        dout = torch.randn_like(q)
        bwd_ms = cuda_ms(lambda: fa.attention_backward(
            q, k, v, dout, cfg.causal, cfg.attn_softcap, cfg.sliding_window,
            prefix), 3)
        out["attention_backward_ms_alone"] = bwd_ms
        out["attention_backward_share_alone"] = (
            bwd_ms * attention_layers(cfg) / busy)
        del q, k, v, dout
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"  {cfg.name}: attention_backward alone "
          f"{out.get('attention_backward_ms_alone', 0.0):.2f} ms a "
          f"microbatch's call, "
          f"{out.get('attention_backward_share_alone', 0.0):.3f} of a "
          f"microbatch step's busy time; {out['seconds']:.1f} s (profile "
          f"{t_prof:.1f})")
    return out


def phase_serve_launcher(dev) -> dict:
    """(d) `repro_torch.launch.serve.main(SERVE_LAUNCHER)` on the card,
    every count set to 0 just before: its two lines, flash attention 26
    sm90 launches (one prefill of gemma2-2b's 26 layers), and the hedged
    half's grid-solve and Philox launches equal to those of the same
    HedgedScheduler run alone on the same requests, which must print the
    same attainment and machine time."""
    from repro_torch.launch import serve as launch_serve
    reset_counts()
    ph.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, wall = synced(lambda: launch_serve.main(SERVE_LAUNCHER))
    lines = buf.getvalue().splitlines()
    counts = dict(fa_counts(), grid_solve=gs.launches,
                  philox_rows=ph.launches)
    gs.launches = ph.launches = 0
    sched = HedgedScheduler(ReplicaPool(n_replicas=4, beta=1.4), theta=1e-2,
                            device=dev)
    alone = sched.run_workload([Request(deadline=0.6, rid=i, n_tokens=64)
                                for i in range(100)])
    want = dict(grid_solve=gs.launches, philox_rows=ph.launches)
    cfg = get_config(SERVE_LAUNCHER[1])
    tokens, batch = int(SERVE_LAUNCHER[4]), int(SERVE_LAUNCHER[6])
    want_lines = [f"decoded ({batch}, {tokens}) tokens on {cfg.name}",
                  f"hedged SLA attainment: {alone['pocd']:.3f} (mean "
                  f"machine-time {alone['mean_machine_time']:.3f}s)"]
    if lines != want_lines:
        raise AssertionError(f"serve launcher: printed {lines}, expected "
                             f"{want_lines}")
    if (counts["flash_attention"], counts["flash_attention_sm90"]) != (
            cfg.n_layers, cfg.n_layers) or want["grid_solve"] != 1 or \
            not want["philox_rows"] or \
            {k: counts[k] for k in want} != want:
        raise AssertionError(f"serve launcher: launches {counts}, expected "
                             f"{cfg.n_layers} sm90 flash-attention launches "
                             f"and the hedged run's {want}")
    print(f"serve launcher {' '.join(SERVE_LAUNCHER)}: {lines}; launches "
          f"{counts}; {wall:.2f} s")
    return dict(argv=SERVE_LAUNCHER, lines=lines, counts=counts,
                wall_s=wall)


def phase_train_families(dev, refs=None) -> dict:
    """Phase 19: training of the moe, vlm, audio, ssm and hybrid families:
    (a) the attention gradient at D 80 and 112 on every mask, (b) each
    family cut in depth card against the CPU, (c) each at full width
    (olmoe and zamba2 cut in depth), (d) the serving launcher."""
    t0 = time.perf_counter()
    free, total = torch.cuda.mem_get_info(dev)
    print(f"phase 19: device memory free {free / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    cases = [(c, 1.0) for c in FA_GRAD_CASES] + [
        (c, FA_HOT_SCALE) for c in FA_GRAD_HOT]
    ta = time.perf_counter()
    grads = check_grad_cases(cases, 900, dev)
    grads["seconds"] = time.perf_counter() - ta
    print(f"train attention D 80 and 112: {grads['cases']['sm90']} bf16 "
          f"cases (sm90) and {grads['cases']['simt']} f32 cases (simt): dq, "
          f"dk, dv equal autograd through the plain version (every mask, "
          f"softcaps, hot cases; "
          f"{sum(e['n'] for e in grads['excused_zeros'])} zeros within "
          f"rounding of 0 excused); worst (mean |err| / mean |want|, max "
          f"|err| / max |want|) {grads['worst_rel']}")
    check = {}
    with host_heap_reuse():
        for arch in CHECK_TRAIN_FAMILIES["cuts"]:
            for opts in CHECK_TRAIN_FAMILIES["paths"].get(arch, ((),)):
                key = arch if not opts else f"{arch} {'+'.join(opts)}"
                check[key] = train_family_check(arch, opts, dev,
                                                refs=refs)
    out = dict(attention_grad=grads, check=check)
    for spec in TRAIN_FAMILIES:
        out[spec["arch"]] = train_family(spec, dev)
    out["serve_launcher"] = phase_serve_launcher(dev)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 19: {out['seconds']:.1f} s")
    return out



# ---------------------------------------------------------------------------
# phase 20: the sharding planner, the dry run and the roofline
# ---------------------------------------------------------------------------

# (a) the dry run's cells on the card's fake tensors, one process a group
# of cells, started before phase 18 (they need no card); every 16x16 cell
# is a trace of its own (rank 0 of a sharded step), so the longest ones
# (zamba2-7b's train and prefill on each mesh) run apart (a mesh of None:
# every mesh of DRYRUN_MESHES)
DRYRUN_MESHES = ("h100", "16x16")
DRYRUN_GROUPS = (
    (("zamba2-7b", "train_4k", "16x16"), ("gemma2-2b", "long_500k", None)),
    (("zamba2-7b", "train_4k", "h100"), ("zamba2-7b", "prefill_32k",
                                         "16x16")),
    (("arctic-480b", "train_4k", None), ("zamba2-7b", "decode_32k", None)),
    (("zamba2-7b", "prefill_32k", "h100"), ("gemma2-2b", "train_4k", None),
     ("gemma2-2b", "prefill_32k", None), ("gemma2-2b", "decode_32k", None),
     ("zamba2-7b", "long_500k", None)))
# (b) gemma2-2b at full width traced fake and run on the card: one
# microbatch's train step (train_4k's 4 x 4096 cut to the 1 x 4096 that
# fits beside the f32 parameters, AdamW's moments and the gradients) and
# one decode step at decode_32k's context with its batch of 128 cut to 8
# (the f32 parameters and 8 x 3.49 GB of cache)
TRACE_TRAIN = dict(batch=1, seq=4096, cut_from=(256, 4096))
TRACE_DECODE = dict(batch=8, seq=32768, cut_from=(128, 32768))


def dryrun_group(cells) -> list:
    """The records of one worker's cells, (arch, shape, mesh[, options]) (a
    mesh of None: every mesh of DRYRUN_MESHES), traced on fake CUDA
    tensors; a sharded trace's
    record also gets its largest collectives (`top_collectives`), and a
    sharded decode's the collectives that would hold a gathered cache
    (`dryrun.cache_gathers`, to be empty)."""
    from repro_torch.launch import dryrun
    out = []
    for arch, shape, mesh, *opts in cells:
        opts = frozenset(opts[0] if opts else ())
        for m in (DRYRUN_MESHES if mesh is None else (mesh,)):
            with contextlib.redirect_stdout(io.StringIO()):
                rec, log = dryrun.cell(arch, shape, m, device="cuda",
                                       opts=opts)
            rec["opts"] = sorted(opts)
            if rec["n_devices"] > 1:
                rec["top_collectives"] = top_collectives(log)
                if rec["kind"] == "decode":
                    rec["cache_gathers"] = dryrun.cache_gathers(
                        arch, shape, m, log)
            out.append(rec)
    return out


def top_collectives(log, n: int = 8) -> list:
    """The `n` collectives of an op log that move the most wire bytes,
    by signature: kind, count, wire bytes, operand and result shapes and
    type, group size."""
    from repro_torch.launch.op_analyzer import cost, records_of
    rows = []
    for sig, count in records_of(log):
        c = cost(sig)
        if c["collective"]:
            shapes = lambda ds: [list(d[1]) for d in ds if d[0] == "t"]
            rows.append(dict(kind=c["collective"], count=count,
                             wire_bytes=count * c["wire"],
                             operands=shapes(sig[2]), results=shapes(sig[3]),
                             dtype=next(d[3] for d in sig[2] if d[0] == "t"),
                             group=sig[4]))
    return sorted(rows, key=lambda r: -r["wire_bytes"])[:n]


#: the logical axes `models.layers.weight` keeps sharded when it gathers
#: a weight before its product (its tensor-parallel dims)
TP_AXES = ("heads", "kv_heads", "ffn", "experts", "e_ffn", "vocab",
           "ssm_in", "ssm_heads")


def fsdp_reckoning(arch, mesh_kind="16x16", shape="train_4k") -> dict:
    """A card's parameter all-gathers and gradient reduce-scatters of one
    step, by hand from the plan: each leaf's bf16 shard gathered over the
    mesh extents of its dims outside TP_AXES (a ring: its local bytes
    times extents - 1), twice a microbatch in the checkpointed blocks
    (the forward and remat's recompute; the hybrid's groups and tail, and
    its shared block twice in each group), once outside them; its
    gradient reduce-scattered back once a microbatch."""
    from repro_torch.ckpt.checkpoint import tree_leaves_with_paths
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.models.param import abstract_params, param_axes
    from repro_torch.sharding import make_plan, mesh_sizes, spec_div
    cfg = get_config(arch)
    mesh = dryrun.MESHES[mesh_kind]
    plan = make_plan(cfg, mesh)
    sizes = mesh_sizes(mesh)
    params = abstract_params(cfg)
    axes = dict(tree_leaves_with_paths(param_axes(cfg, params)))
    seq, batch, _ = SHAPES[shape]
    n_micro = dryrun.micro_count(arch, batch, plan._batch_div(), ())
    uses = {"blocks": 2, "groups": 2, "tail": 2,
            "shared_attn": 2 * (cfg.n_layers // cfg.hybrid.shared_attn_every
                                if cfg.hybrid else 0)}
    gathers = scatters = 0.0
    for path, p in tree_leaves_with_paths(params):
        leaf = axes[path]
        spec = plan.spec_for(p.shape, leaf)
        g = math.prod(sizes[a] for ax, e in zip(leaf.axes, spec)
                      if ax not in TP_AXES and e is not None
                      for a in (e if isinstance(e, tuple) else (e,)))
        wire = 2 * p.numel() / spec_div(spec, mesh) * (g - 1)
        gathers += n_micro * uses.get(path[0], 1) * wire
        scatters += n_micro * wire
    return dict(all_gather_bytes=gathers, reduce_scatter_bytes=scatters,
                total_bytes=gathers + scatters, n_micro=n_micro)


def start_dryrun(groups=DRYRUN_GROUPS):
    """The dry run's processes started, one a group of cells (they need
    no card): (pool, futures, applicable cells of each group, start
    time). Phase 20 (a)'s and phase 22 (c)'s start before phase 18, so
    that their traces run beside phases 18 and 19 on the host's other
    cores; `main` shuts both pools down."""
    import concurrent.futures
    import multiprocessing
    from repro_torch.configs import shape_applicable
    groups = [[c for c in g if shape_applicable(c[0], c[1])[0]]
              for g in groups]
    # at a lower priority than this process: the traces have slack, the
    # phases beside them run host-bound steps and CPU checks
    pool = concurrent.futures.ProcessPoolExecutor(
        len(groups), mp_context=multiprocessing.get_context("spawn"),
        initializer=os.nice, initargs=(10,))
    return pool, [pool.submit(dryrun_group, g) for g in groups], groups, \
        time.perf_counter()


def phase_dryrun(futures, groups, t0) -> dict:
    """(a): every applicable shape of gemma2-2b and zamba2-7b and
    arctic-480b's train_4k on `h100` and `16x16` (every spec checked
    against its leaf's shape in the cell: no mesh axis twice, every
    sharded dim divisible), each record's roofline row; every record a
    trace with wire bytes, and no sharded decode with a gathered cache."""
    t_wait = time.perf_counter()
    recs = [r for f in futures for r in f.result()]
    seconds = time.perf_counter() - t0
    wait_s = time.perf_counter() - t_wait
    rows = {}
    for rec in recs:
        key = f"{rec['arch']}/{rec['shape']}/{rec['mesh']}"
        row = rows[key] = dryrun_row(rec)
        print(f"  {key}: flops/dev {rec['flops_per_device']:.4e}, bytes/dev "
              f"{rec['hbm_bytes_per_device']:.4e}, args/dev "
              f"{rec['memory']['argument_bytes'] / 2**30:.3f} GiB, fits "
              f"{rec['fits']}, dominant {row['dominant']}, per device "
              f"{rec['per_device']}, wire bytes/dev "
              f"{rec['collective_wire_bytes']:.4e} (trace "
              f"{rec['trace_s']:.1f} s)")
    want = {f"{a}/{s}/{m}" for g in groups for a, s, mesh in g
            for m in (DRYRUN_MESHES if mesh is None else (mesh,))}
    if set(rows) != want:
        raise AssertionError(f"dry run: cells {sorted(want ^ set(rows))}")
    for key, row in rows.items():
        if row["per_device"] != "trace" or row[
                "collective_wire_bytes"] is None:
            raise AssertionError(f"dry run {key}: not traced: {row}")
        if row.get("cache_gathers"):
            raise AssertionError(f"dry run {key}: a collective holds a whole "
                                 f"cache leaf on a sharded dim: "
                                 f"{row['cache_gathers'][:4]}")
    if rows["arctic-480b/train_4k/h100"]["fits"]:
        raise AssertionError("dry run: arctic-480b fits one card")
    print(f"phase 20 (a): {len(rows)} cells in {seconds:.1f} s from their "
          f"processes' start ({len(groups)} processes, beside phases 18, 19 "
          f"and 20 (b) and (c)); phase 20 waited {wait_s:.1f} s for them")
    return dict(cells=rows, seconds=seconds, wait_s=wait_s,
                processes=len(groups))


def op_diff(fake: dict, real: dict) -> dict:
    """{op: (fake count, real count)} where the two traces differ."""
    a, b = fake["op_counts"], real["op_counts"]
    return {k: (a.get(k, 0), b.get(k, 0)) for k in sorted(set(a) | set(b))
            if a.get(k, 0) != b.get(k, 0)}


def device_ms(fn, reps: int = 2) -> float:
    """The least of `reps` CUDA-event timings of fn() on the current
    stream (a warm call first)."""
    fn()
    best = None
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        best = ms if best is None else min(best, ms)
    return best


def traced_against_card(what, fake, real, ms, launches) -> dict:
    """(b)'s checks of one step: FLOPs equal, bytes within 1%, the flash
    entries equal to the sm90 launches, the roofline share <= 1."""
    from repro_torch.launch import roofline
    diff = op_diff(fake, real)
    if diff:
        print(f"  {what}: ops that differ (fake, real): {diff}")
    if fake["dot_flops"] != real["dot_flops"]:
        raise AssertionError(f"{what}: FLOPs fake {fake['dot_flops']!r} != "
                             f"real {real['dot_flops']!r}")
    rel = abs(fake["hbm_bytes"] - real["hbm_bytes"]) / real["hbm_bytes"]
    if rel > 0.01:
        raise AssertionError(f"{what}: bytes fake {fake['hbm_bytes']} vs "
                             f"real {real['hbm_bytes']} ({rel:.3%})")
    entries = real["flash_attention_entries"]
    bwd = real["flash_attention_backward_entries"]
    if not (entries == fake["flash_attention_entries"]
            == launches["flash_attention_sm90"]
            and launches["flash_attention_simt"] == 0
            and bwd == fake["flash_attention_backward_entries"]
            == launches["flash_attention_backward"]):
        raise AssertionError(f"{what}: flash entries fake "
                             f"{fake['flash_attention_entries']}, real "
                             f"{entries}, backward entries fake "
                             f"{fake['flash_attention_backward_entries']}, "
                             f"real {bwd}, launches {launches}")
    compute_ms = 1e3 * real["dot_flops"] / roofline.PEAK_FLOPS
    memory_ms = 1e3 * real["hbm_bytes"] / roofline.HBM_BW
    bound = max(compute_ms, memory_ms)
    by = "compute" if compute_ms >= memory_ms else "memory"
    share = bound / ms
    print(f"  {what}: FLOPs {real['dot_flops']:.6e} (fake = real), bytes "
          f"fake {fake['hbm_bytes']:.6e} real {real['hbm_bytes']:.6e} "
          f"({rel:.2e}); flash entries {entries} = sm90 launches, backward "
          f"entries {bwd} = backward launches; device "
          f"{ms:.3f} ms, bound {bound:.3f} ms ({by}), share {share:.4f}; "
          f"ops fake {sum(fake['op_counts'].values())} real "
          f"{sum(real['op_counts'].values())}")
    if share > 1.0:
        raise AssertionError(f"{what}: measured {ms} ms below the roofline "
                             f"bound {bound} ms")
    return dict(flops=real["dot_flops"], bytes_fake=fake["hbm_bytes"],
                bytes_real=real["hbm_bytes"], bytes_rel_diff=rel, bound_by=by,
                ops_fake=sum(fake["op_counts"].values()),
                ops_real=sum(real["op_counts"].values()), op_diff=diff,
                flash_attention_entries=entries,
                flash_attention_backward_entries=bwd, launches=launches,
                device_ms=ms, compute_ms=compute_ms, memory_ms=memory_ms,
                bound_ms=bound, share=share)


def phase_trace_card(dev) -> dict:
    """(b): gemma2-2b at full width, each step traced on fake tensors and
    run on the card under the op analyzer, its warm device time beside
    the roofline bound; MFU by both formulas."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.op_analyzer import OpAnalyzer
    from repro_torch.models.inputs import batch_struct
    cfg = get_config("gemma2-2b")
    model = model_lib.build(cfg)
    opt = make_optimizer(cfg)
    out = {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    B, S = TRACE_TRAIN["batch"], TRACE_TRAIN["seq"]
    with FakeTensorMode():
        params = model.init(seed=0, device=dev)
        state = TrainState(params, opt.init(params),
                           torch.zeros((), dtype=torch.int32, device=dev))
        fake = OpAnalyzer()
        dryrun.trace_train(model, opt, state,
                           batch_struct(cfg, B, S, "train", dev), 1, fake)
    params = model.init(seed=0, device=dev)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=dev))
    batch = make_batch(cfg, B, S, "train", device=dev)
    step = make_train_step(model, opt, 1)
    ms = device_ms(lambda: step(state, batch, [1.0]))
    peak = torch.cuda.max_memory_allocated(dev)
    reset_counts()
    real = OpAnalyzer()
    dryrun.trace_train(model, opt, state, batch, 1, real)
    torch.cuda.synchronize()
    train = traced_against_card("train step 1 x 4096", fake.summary(),
                                real.summary(), ms, fa_counts())
    # MFU two ways: the dry run's formula (the reference's; every
    # non-embedding parameter, norms too, 6 FLOPs a token, attention at
    # S/2 a token) and phase 16's (the matmul parameters, the lm-head
    # among them, and the causal pairs S(S+1)/2)
    share = B * S / (TRACE_TRAIN["cut_from"][0] * TRACE_TRAIN["cut_from"][1])
    analytic = dryrun.model_flops_analytic(cfg, "train_4k") * share
    phase16 = model_flops_per_step(cfg, B * S, B, S)
    peak_ops = roofline.PEAK_FLOPS
    train.update(model_flops_analytic=analytic, model_flops_phase16=phase16,
                 mfu_analytic=analytic / (1e-3 * ms * peak_ops),
                 mfu_phase16=phase16 / (1e-3 * ms * peak_ops),
                 peak_bytes=peak, reduced=dict(
                     batch=f"{TRACE_TRAIN['cut_from'][0]} -> {B} sequences "
                           f"(one microbatch of {B} x {S})"))
    n_eff = cfg.active_param_count() - padded_vocab(cfg) * cfg.d_model
    matmul = (cfg.n_layers * (cfg.d_model * cfg.head_dim * (
        2 * cfg.n_heads + 2 * cfg.n_kv_heads) + 3 * cfg.d_model * cfg.d_ff)
        + cfg.d_model * padded_vocab(cfg))
    print(f"  MFU formulas: the dry run's counts {n_eff:,} parameters "
          f"(active_param_count less the padded embedding table) at 6 "
          f"FLOPs a token and attention at S/2 a token; phase 16's counts "
          f"{matmul:,} matmul parameters (lm-head included) and the causal "
          f"pairs S(S+1)/2: {analytic:.4e} against {phase16:.4e} FLOPs "
          f"({phase16 / analytic - 1:+.2%})")
    print(f"  train step 1 x {S}: MFU {train['mfu_analytic']:.4f} "
          f"(model_flops_analytic), {train['mfu_phase16']:.4f} (phase 16's "
          f"formula); traced FLOPs {train['flops'] / analytic:.3f}x the "
          f"analytic; peak {peak / 2**30:.2f} GiB")
    out["train"] = train
    del params, state, batch, step, real
    gc.collect()
    torch.cuda.empty_cache()

    B, S = TRACE_DECODE["batch"], TRACE_DECODE["seq"]
    with FakeTensorMode():
        params = model.init(seed=0, device=dev)
        cache = model.init_cache(B, S, device=dev)
        tokens_fake = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        fake = OpAnalyzer()
        dryrun.trace_decode(model, params, tokens_fake, cache, fake)
    params = model.init(seed=0, device=dev)
    cache = model.init_cache(B, S, device=dev)
    cache["lengths"].fill_(S - 1)
    tokens = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    with torch.no_grad():
        ms = device_ms(lambda: model.decode_step(params, tokens, cache))
    reset_counts()
    real = OpAnalyzer()
    dryrun.trace_decode(model, params, tokens, cache, real)
    torch.cuda.synchronize()
    decode = traced_against_card(f"decode step {B} x {S}", fake.summary(),
                                 real.summary(), ms, fa_counts())
    arg = n_elements(params) * 4 + sum(
        x.numel() * x.element_size() for layer in cache["kv"]
        for x in layer.values())
    decode.update(argument_bytes=arg,
                  argument_floor_ms=1e3 * arg / roofline.HBM_BW,
                  reduced=dict(batch=f"{TRACE_DECODE['cut_from'][0]} -> {B}"))
    print(f"  decode step: every argument byte once "
          f"{decode['argument_floor_ms']:.3f} ms of {ms:.3f} ms")
    out["decode"] = decode
    del params, cache, tokens, real
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_planner_card(dev) -> dict:
    """(c): card_mesh over NCCL, gemma2-2b's full-width state placed with
    the (1, 1) plan and placed again on a fresh plan, every leaf's bits
    equal to the original's; the process group destroyed."""
    import torch.distributed as dist
    from repro_torch.ckpt.checkpoint import tree_leaves_with_paths
    from repro_torch.launch.mesh import card_mesh
    from repro_torch.models.param import param_axes
    from repro_torch.runtime import elastic
    from repro_torch.sharding import make_plan, placements
    t0 = time.perf_counter()
    mesh = card_mesh()
    try:
        backend = dist.get_backend()
        if backend != "nccl":
            raise AssertionError(f"card_mesh: backend {backend}, not nccl")
        cfg = get_config("gemma2-2b")
        params = model_lib.build(cfg).init(seed=0, device=dev)
        axes = param_axes(cfg, params)
        plan = make_plan(cfg, mesh)
        state = elastic.reshard_state(params, None, plan, axes)
        moved = elastic.reshard_state(state, plan, make_plan(cfg, mesh), axes)
        del state
        leaves = equal = placed = 0
        specs = plan.param_specs(params, axes)
        for (path, want), (_, got), (_, spec) in zip(
                tree_leaves_with_paths(params), tree_leaves_with_paths(moved),
                tree_leaves_with_paths(specs)):
            leaves += 1
            placed += tuple(got.placements) == placements(spec, mesh)
            equal += bool(torch.equal(got.full_tensor(), want))
        if not equal == placed == leaves:
            raise AssertionError(f"reshard: {equal} of {leaves} leaves "
                                 f"bit-equal, {placed} placed as planned")
        sharded = sum(len(s) > 0 for _, s in tree_leaves_with_paths(specs))
    finally:
        dist.destroy_process_group()
    seconds = time.perf_counter() - t0
    print(f"phase 20 (c): card_mesh over {backend}, gemma2-2b's {leaves} "
          f"leaves ({n_elements(params):,} parameters; {sharded} with a "
          f"Shard placement) placed and re-sharded, all bit-equal, "
          f"{seconds:.1f} s")
    del params, moved
    gc.collect()
    torch.cuda.empty_cache()
    return dict(backend=backend, leaves=leaves, bit_equal=equal,
                sharded_leaves=sharded, seconds=seconds)


def phase_planner(dev, dry) -> dict:
    """Phase 20: (a) the dry run, in the processes `dry` started
    (`start_dryrun`), while (b) traces against the card and (c) places
    the planner's state on it."""
    t0 = time.perf_counter()
    _, futures, groups, t_a = dry
    out = dict(trace=phase_trace_card(dev), planner=phase_planner_card(dev))
    out["dryrun"] = phase_dryrun(futures, groups, t_a)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 20: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 21: the fleet on a mesh of several points
# ---------------------------------------------------------------------------

MESH_REPS = 3                      # pads the "rep" axis on (2, 2)
MESH_FLAT_SHAPES = ((2, 2), (1, 4))
MESH_CAPACITY_SHAPE = (2, 2)
MESH_SERVE_SHAPE = (1, 4)
MESH_SERVE_WINDOW = 254            # padded to 256 on the (1, 4) mesh
MESH_CHAOS_POINTS, MESH_CHAOS_REPS = 8, 2
MESH_LOSS_PLAN = FaultPlan(events=(
    FaultEvent("device_loss", 1, device_ids=(3, 6)),
    FaultEvent("device_loss", 2, 2),
    FaultEvent("crash", 2)))
MESH_LOSS_RECORDS = ["failed=[3, 6] alive=6", "failed=[5, 7] alive=4"]


class PointCounts:
    """The kernel launches of a mesh run by mesh point. A path calls its
    per-point work in point order (the flat fleet's `_exec_blocks` and
    serving's `_serve_lanes` once a point a chunk or window, the capacity
    fleet's `engine._replay` once a point a round), so the k-th such call
    is point k mod the mesh's size: philox_rows launches count to the
    point whose call draws them (the capacity fleet draws a group's
    tables just before its `_replay`), dispatch_scan launches to the
    point whose replay makes them, grid-solve launches to the first
    point, where every solve must run (checked by device)."""

    def __init__(self, mesh):
        self.mesh, self.calls, self.current, self.pending = mesh, 0, 0, 0
        self.philox = [0] * mesh.size
        self.dispatch = [0] * mesh.size
        self.grid = 0

    def _point(self) -> int:
        k = self.calls % self.mesh.size
        self.calls += 1
        return k

    @contextlib.contextmanager
    def counting(self, path: str):
        saved = (fleet_runner._exec_blocks, cluster_engine._replay,
                 serve_scheduler._serve_lanes, ph.philox_rows_cuda,
                 ds.dispatch_scan_batched_cuda, gs.grid_solve_cuda)
        exec_blocks, replay_, lanes, philox, dispatch, grid = saved

        def per_point(inner):
            def call(*a, **k):
                self.current = self._point()
                return inner(*a, **k)
            return call

        def replay_point(*a, **k):
            self.current = self._point()
            self.philox[self.current] += self.pending
            self.pending = 0
            return replay_(*a, **k)

        def philox_counted(*a, **k):
            if path == "capacity":
                self.pending += 1
            else:
                self.philox[self.current] += 1
            return philox(*a, **k)

        def dispatch_counted(*a, **k):
            self.dispatch[self.current] += 1
            return dispatch(*a, **k)

        def grid_counted(spec, job, r_max):
            if job.t_min.device != self.mesh.devices[0]:
                raise AssertionError(f"mesh: a grid solve on "
                                     f"{job.t_min.device}, not the first "
                                     f"point {self.mesh.devices[0]}")
            self.grid += 1
            return grid(spec, job, r_max)

        fleet_runner._exec_blocks = per_point(exec_blocks)
        cluster_engine._replay = replay_point
        serve_scheduler._serve_lanes = per_point(lanes)
        ph.philox_rows_cuda = philox_counted
        ds.dispatch_scan_batched_cuda = dispatch_counted
        gs.grid_solve_cuda = grid_counted
        try:
            yield self
        finally:
            (fleet_runner._exec_blocks, cluster_engine._replay,
             serve_scheduler._serve_lanes, ph.philox_rows_cuda,
             ds.dispatch_scan_batched_cuda, gs.grid_solve_cuda) = saved
        if self.pending:
            raise AssertionError(f"mesh {path}: {self.pending} draws after "
                                 f"the last replay")

    def by_point(self, kernels) -> list:
        out = []
        for k, d in enumerate(self.mesh.devices):
            row = dict(point=k, id=self.mesh.ids[k], device=str(d),
                       philox_rows=self.philox[k])
            if "dispatch_scan" in kernels:
                row["dispatch_scan"] = self.dispatch[k]
            row["grid_solve"] = self.grid if k == 0 else 0
            out.append(row)
        for row in out:
            for name in kernels:
                if name != "grid_solve" and row[name] == 0:
                    raise AssertionError(f"mesh point {row['point']} "
                                         f"launched no {name}: {out}")
        if "grid_solve" in kernels and self.grid == 0:
            raise AssertionError("mesh: no grid-solve launch")
        return out


def mesh_same_bits(got: dict, want: dict, what: str, queue=False) -> None:
    """Every strategy's pocd, mean_cost, per-job columns, r* and theory
    columns (and the queue and capacity metrics) bit for bit."""
    if list(got) != list(want):
        raise AssertionError(f"{what}: strategies {list(got)}")
    for name, o in got.items():
        w = want[name]
        pairs = [(f, getattr(o.result, f), getattr(w.result, f))
                 for f in ("pocd", "mean_cost", "job_met", "job_completion",
                           "job_cost")]
        pairs += [(f, getattr(o, f), getattr(w, f)) for f in (
            "r_opt", "utility", "theory_pocd", "theory_cost")
            if hasattr(o, f)]
        if queue:
            pairs += [(f"queue.{f}", getattr(o.queue, f),
                       getattr(w.queue, f))
                      for f in o.queue._fields if f != "slots"]
            pairs += [(f"metrics.{f}", to_host(getattr(o.metrics, f)),
                       to_host(getattr(w.metrics, f)))
                      for f in o.metrics._fields]
        for f, x, y in pairs:
            same = (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else np.array_equal(np.asarray(x), np.asarray(y)))
            if not same:
                raise AssertionError(f"{what} {name}: {f} differs")


def on_first_point(outs: dict, mesh, what: str) -> None:
    for name, o in outs.items():
        if o.result.job_met.device != mesh.devices[0]:
            raise AssertionError(f"{what} {name}: outputs on "
                                 f"{o.result.job_met.device}, not the first "
                                 f"point {mesh.devices[0]}")
    if torch.cuda.current_device() != 0:
        raise AssertionError(f"{what}: the current device moved to "
                             f"{torch.cuda.current_device()}")


def mesh_run(label: str, mesh, run, want, want_wall: float, path: str,
             kernels, queue=False) -> dict:
    """One run on `mesh`, counted by point, held bit for bit against the
    run without a mesh: its row of the phase's JSON."""
    pc = PointCounts(mesh)
    with pc.counting(path):
        (got, r_min), wall = synced(run)
    mesh_same_bits(got, want[0], label, queue)
    if r_min != want[1]:
        raise AssertionError(f"{label}: r_min {r_min} against {want[1]}")
    on_first_point(got, mesh, label)
    points = pc.by_point(kernels)
    print(f"  {label}: {mesh.rep_extent} x {mesh.job_extent} on "
          f"{sorted({str(d) for d in mesh.devices})}: wall {wall:.3f} s "
          f"against {want_wall:.3f} s without a mesh; the same bits; "
          f"launches by point " + "; ".join(
              f"{r['point']}: " + ", ".join(f"{k} {r[k]}" for k in kernels)
              for r in points))
    return dict(shape=[mesh.rep_extent, mesh.job_extent],
                devices=[str(d) for d in mesh.devices], wall_s=wall,
                no_mesh_wall_s=want_wall, launches_by_point=points)


def mesh_launches(mesh_out: dict, name: str) -> dict:
    """{run: [launches of kernel `name` at each point]} over phase 21's
    counted runs that launch it."""
    runs = {f"flat {r['shape']} on {len(set(r['devices']))} card(s)": r
            for r in mesh_out["flat"]["runs"]}
    runs["capacity"] = mesh_out["capacity"]["run"]
    for regime in ("known_tail", "online"):
        runs[f"serving {regime}"] = mesh_out["serving"][regime]
    return {label: [pt[name] for pt in r["launches_by_point"]]
            for label, r in runs.items()
            if name in r["launches_by_point"][0]}


def phase_mesh(dev, p: SimParams) -> dict:
    """The fleet on a mesh (phase 21): (a) the flat fleet, (b) the
    capacity fleet, (c) serving, (d) a device loss across a crash and a
    resume; every run bit-equal to its run without a mesh."""
    t_phase = time.perf_counter()
    card0 = (torch.device("cuda", torch.cuda.current_device())
             if dev.type == "cuda" else dev)
    on_card = lambda n: [card0] * n
    out = {"cards": torch.cuda.device_count()}
    flat_k = ("grid_solve", "philox_rows")

    # (a) the flat fleet over phase 10c's trace, in chunks
    tr = make_trace("paper-hadoop", n_jobs=FLEET_JOBS, device=dev)
    kw = dict(theta=THETA, reps=MESH_REPS, block_jobs=FLEET_BLOCK,
              chunk_jobs=FLEET_CHUNK, device=dev)
    want, wall0 = synced(lambda: run_all_fleet(Philox(0), tr, p, **kw))
    print(f"phase 21 (a): run_all_fleet on {FLEET_JOBS} paper-hadoop jobs "
          f"in chunks of {FLEET_CHUNK}, reps {MESH_REPS}, every strategy")
    flat = []
    for shape in MESH_FLAT_SHAPES:
        mesh = fleet_mesh(shape=shape, device=on_card(4))
        flat.append(mesh_run(
            f"flat {shape}", mesh,
            lambda: run_all_fleet(Philox(0), tr, p, mesh=mesh, **kw), want,
            wall0, "flat", flat_k))
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        k = min(4, n_cards)
        mesh = fleet_mesh(shape=(1, k))
        flat.append(mesh_run(
            f"flat (1, {k}) on distinct cards", mesh,
            lambda: run_all_fleet(Philox(0), tr, p, mesh=mesh, **kw), want,
            wall0, "flat", flat_k))
    else:
        print("  one card is visible: the flat fleet over distinct cards "
              "was not run")
    out["flat"] = dict(jobs=FLEET_JOBS, chunk_jobs=FLEET_CHUNK,
                       reps=MESH_REPS, runs=flat,
                       distinct_cards_run=n_cards >= 2)

    # (b) the capacity fleet, windowed, on the paper trace
    jobs = generate(2700, seed=0, device=dev)
    ckw = dict(theta=THETA, slots=CLUSTER_SLOTS, discipline="fifo",
               reps=MESH_REPS, chunk_jobs=FLEET_WINDOW, collect_metrics=True,
               device=dev)
    cwant, cwall0 = synced(lambda: run_cluster_fleet(Philox(0), jobs, p,
                                                     **ckw))
    print(f"phase 21 (b): run_cluster_fleet on {jobs.n_jobs} jobs, "
          f"{CLUSTER_SLOTS} slots, FIFO, windows of {FLEET_WINDOW}, reps "
          f"{MESH_REPS}, collect_metrics")
    mesh = fleet_mesh(shape=MESH_CAPACITY_SHAPE, device=on_card(4))
    out["capacity"] = dict(
        jobs=jobs.n_jobs, slots=CLUSTER_SLOTS, window_jobs=FLEET_WINDOW,
        reps=MESH_REPS, run=mesh_run(
            f"capacity {MESH_CAPACITY_SHAPE}", mesh,
            lambda: run_cluster_fleet(Philox(0), jobs, p, mesh=mesh, **ckw),
            cwant, cwall0, "capacity",
            ("grid_solve", "philox_rows", "dispatch_scan"), queue=True))

    # (c) serving, the window padded to the "job" extent on the mesh
    reqs = make_requests(SERVING["scenario"], device=dev)
    print(f"phase 21 (c): run_serve on {reqs.n_requests} "
          f"{SERVING['scenario']} requests, window {MESH_SERVE_WINDOW}")
    out["serving"] = {"requests": reqs.n_requests,
                      "window": MESH_SERVE_WINDOW}
    mesh = fleet_mesh(shape=MESH_SERVE_SHAPE, device=on_card(4))
    for regime, rkw in (("known_tail", {}),
                        ("online", dict(
                            refit_every=SERVING["refit_every"],
                            probe_every=SERVING["probe_every"]))):
        skw = dict(window=MESH_SERVE_WINDOW, device=dev, **rkw)
        swant, swall0 = synced(lambda: run_serve(Philox(0), reqs, p, **skw))
        got = mesh_run(
            f"serving {regime} {MESH_SERVE_SHAPE}", mesh,
            lambda: run_serve(Philox(0), reqs, p, mesh=mesh, **skw), swant,
            swall0, "serving", flat_k)
        out["serving"][regime] = got

    # (d) a device loss on eight points across a crash and a resume
    mesh = fleet_mesh(devices=MESH_CHAOS_POINTS, reps=MESH_CHAOS_REPS,
                      device=on_card(MESH_CHAOS_POINTS))
    dkw = dict(theta=THETA, r_min=want[1], reps=MESH_CHAOS_REPS,
               block_jobs=FLEET_BLOCK, chunk_jobs=FLEET_CHUNK, device=dev)
    one = lambda m, **x: run_fleet_strategy(Philox(0), tr, "sresume", p,
                                            mesh=m, **dkw, **x)
    no_mesh, dwall0 = synced(lambda: one(None))
    base, dwall = synced(lambda: one(mesh))
    mesh_same_bits({"sresume": base}, {"sresume": no_mesh}, "chaos base")
    gov = ElasticGovernor(alpha=0.0)     # its history; the price stays
    ctx = ChaosContext(MESH_LOSS_PLAN, governor=gov)
    gs.launches = ph.launches = 0
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        try:
            one(mesh, chaos=ctx, checkpoint=d)
            raise AssertionError("mesh chaos: the run did not crash")
        except SimulatedCrash as err:
            if err.chunk != 2:
                raise AssertionError(f"mesh chaos: crashed after chunk "
                                     f"{err.chunk}") from err
        losses = [x for _, k, x in ctx.records if k == "device_loss"]
        if losses != MESH_LOSS_RECORDS:
            raise AssertionError(f"mesh chaos: records {ctx.records}")
        if gov.history != [(1, 6, 1.0), (2, 4, 1.0)]:
            raise AssertionError(f"mesh chaos: governor history "
                                 f"{gov.history}")
        resumed = one(mesh, chaos=ChaosContext(MESH_LOSS_PLAN),
                      checkpoint=d, resume=True)
        torch.cuda.synchronize()
        crash_resume_s = time.perf_counter() - t0
    mesh_same_bits({"sresume": resumed}, {"sresume": base},
                   "chaos resumed vs fault-free")
    on_first_point({"sresume": resumed}, mesh, "chaos resumed")
    print(f"phase 21 (d): run_fleet_strategy[sresume] on {mesh.size} points "
          f"{mesh.rep_extent} x {mesh.job_extent}, reps {MESH_CHAOS_REPS}: "
          f"{'; '.join(losses)}, crash after chunk 2, resumed: the bits of "
          f"the eight-point run without faults (wall {dwall:.3f} s; without "
          f"a mesh {dwall0:.3f} s, the same bits); governor history "
          f"{gov.history}; crash and resume {crash_resume_s:.3f} s, "
          f"{gs.launches} grid-solve and {ph.launches} philox_rows "
          f"launches")
    out["chaos"] = dict(
        points=mesh.size, reps=MESH_CHAOS_REPS, records=ctx.records,
        governor_history=gov.history, wall_s=dwall, no_mesh_wall_s=dwall0,
        crash_and_resume_s=crash_resume_s,
        launches=dict(grid_solve=gs.launches, philox_rows=ph.launches))
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 21: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 22: the sharded train step
# ---------------------------------------------------------------------------

# (a) on card_mesh() (NCCL, (1, 1)): gemma2-2b at full width,
# olmoe-1b-7b cut in depth as phase 19 cuts it, and paligemma-3b,
# hubert-xlarge, mamba2-2.7b and zamba2-7b at full width cut to the
# depths of SHARDED_CUTS in their own (bf16) compute type, 2 steps of 4
# microbatches of 1 x 2048 tokens each (paligemma 256 patches and 1792
# text tokens), with "shard_grads" and the parameters' specs as
# grad_specs, against the unsharded step from the same seed
SHARDED = dict(archs=("gemma2-2b", "olmoe-1b-7b", "paligemma-3b",
                      "hubert-xlarge", "mamba2-2.7b", "zamba2-7b"),
               steps=2, batch=4, seq=2048, n_micro=4)
# phase 19 (b)'s depths (cut_config), paligemma at 2 layers
SHARDED_CUTS = {"paligemma-3b": dict(n_layers=2),
                "hubert-xlarge": dict(n_layers=2),
                "mamba2-2.7b": dict(n_layers=2),
                "zamba2-7b": dict(n_layers=3, shared_attn_every=2)}
# (b) only with two cards or more: olmoe-1b-7b at full width cut to 2
# layers on a (1, n) mesh of NCCL ranks, one a card, against one card;
# bf16 compute summed in other orders, so the losses and gradient norms
# are held within loss_rtol, and each parameter's difference from the
# one card's, on average over its elements, within param_rtol of the
# one card's update to it (no machine with two cards has run this yet:
# both limits are provisional)
SHARDED_CARDS = dict(arch="olmoe-1b-7b", layers=2, steps=2, batch=4,
                     seq=1024, n_micro=2, loss_rtol=1e-2, param_rtol=0.1)
# (c) the 16x16 dry run of every family's train_4k cell, traced sharded:
# gemma2-2b's and zamba2-7b's are phase 20 (a)'s records, the others are
# traced in spawned processes (SHARDED_DRYRUN_GROUPS) started before
# phase 18
SHARDED_DRYRUN = ("gemma2-2b", "olmoe-1b-7b", "paligemma-3b",
                  "hubert-xlarge", "mamba2-2.7b", "zamba2-7b")
SHARDED_DRYRUN_GROUPS = (("olmoe-1b-7b", "mamba2-2.7b"),
                         ("hubert-xlarge", "paligemma-3b"))


def sharded_dryrun_groups() -> tuple:
    """(c)'s groups of cells, as `start_dryrun` takes them."""
    return tuple(tuple((a, "train_4k", "16x16") for a in group)
                 for group in SHARDED_DRYRUN_GROUPS)


def sharded_config(arch, dev):
    """(config, depth record) as phase 22 trains `arch`: SHARDED_CUTS'
    depth in the config's own compute type, or phase 19's depth cut
    where it has one, else the full config."""
    if arch in SHARDED_CUTS:
        cut = SHARDED_CUTS[arch]
        cfg = dataclasses.replace(cut_config(arch, cut), compute_dtype=
                                  get_config(arch).compute_dtype)
        return cfg, dict(cut, full_layers=get_config(arch).n_layers)
    spec = next((s for s in TRAIN_FAMILIES if s["arch"] == arch), {})
    if "cut" not in spec:
        return get_config(arch), None
    return depth_cut(spec, dev)


def metric(x) -> float:
    """A step's metric as a float: a replicated DTensor's local value."""
    return float(x.to_local() if hasattr(x, "to_local") else x)


def sharded_train_run(cfg, dev, mesh=None, capture=None) -> tuple:
    """SHARDED's steps of `cfg` from seed 0: unsharded, or on `mesh` with
    the state and batch placed by the plan and "shard_grads". The counts
    are set to 0 just before the first step. `capture`, a dict, gets the
    first flash-attention launch's local inputs and output. Returns
    (state, record)."""
    from repro_torch.models.param import param_axes
    from repro_torch.sharding import make_plan, plan_context
    from repro_torch.sharding.planner import place_train_state
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = model_lib.build(cfg)
    opt = make_optimizer(cfg)
    params = model.init(seed=0, device=dev)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=dev))
    batch = make_batch(cfg, SHARDED["batch"], SHARDED["seq"], "train",
                       seed=0, device=dev)
    mask = torch.ones((SHARDED["n_micro"],), device=dev)
    ctx, kw = contextlib.nullcontext(), {}
    if mesh is not None:
        plan = make_plan(cfg, mesh)
        axes = param_axes(cfg, params)
        kw = dict(opts=frozenset({"shard_grads"}), mesh=mesh,
                  grad_specs=plan.param_specs(params, axes))
        state, batch = place_train_state(plan, state, opt, batch, axes)
        ctx = plan_context(plan)
    del params
    step = make_train_step(model, opt, SHARDED["n_micro"], **kw)
    launch = fa._launch

    def captured(route, q, k, v, causal, softcap, window=None, prefix_len=0):
        out = launch(route, q, k, v, causal, softcap, window, prefix_len)
        if capture is not None and not capture:
            capture.update(q=q.clone(), k=k.clone(), v=v.clone(),
                           out=out.clone(), mask=dict(
                               causal=causal, softcap=softcap, window=window,
                               prefix_len=prefix_len))
        return out

    losses, norms, times = [], [], []
    reset_counts()
    fa._launch = captured
    try:
        with ctx:
            for _ in range(SHARDED["steps"]):
                (state, m), dt = synced(lambda: step(state, batch, mask))
                losses.append(metric(m["loss"]))
                norms.append(metric(m["grad_norm"]))
                times.append(dt)
    finally:
        fa._launch = launch
    return state, dict(losses=losses, grad_norms=norms, step_s=times,
                       counts=fa_counts(),
                       peak_memory_bytes=torch.cuda.max_memory_allocated(
                           dev))


def sharded_against_plain(arch, dev, mesh, cfg=None,
                          what="phase 22 (a)") -> dict:
    """(a) for one arch: the unsharded steps, their parameters copied to
    the host; then the sharded steps, their losses, gradient norms and
    parameters against those (bit-equal, or the first differing leaf and
    its largest difference), the flash launches counted, and the first
    DTensor-path launch against the plain version on its own inputs.
    `cfg` replaces phase 22's config of `arch` (`sharded_config`)."""
    from repro_torch.ckpt.checkpoint import tree_leaves_with_paths
    t0 = time.perf_counter()
    cfg, cut = (cfg, None) if cfg is not None else sharded_config(arch,
                                                                   dev)
    state, plain = sharded_train_run(cfg, dev)
    want = [(path, p.detach().cpu())
            for path, p in tree_leaves_with_paths(state.params)]
    n_leaves = len(want)
    del state
    capture = {}
    state, sharded = sharded_train_run(cfg, dev, mesh, capture)
    first_diff, equal = None, 0
    for (path, w), (_, got) in zip(want, tree_leaves_with_paths(
            state.params)):
        g = got.to_local()
        w = w.to(dev)
        if torch.equal(g, w):
            equal += 1
        elif first_diff is None:
            first_diff = dict(leaf=str(path), max_abs_diff=float(
                (g.float() - w.float()).abs().max()))
        del w
    del state, want
    gc.collect()
    torch.cuda.empty_cache()
    want_fa = (2 * attention_layers(cfg) * SHARDED["n_micro"]
               * SHARDED["steps"])
    counts = sharded["counts"]
    if (counts["flash_attention"], counts["flash_attention_sm90"],
            counts["flash_attention_simt"],
            counts["flash_attention_backward"]) != (want_fa, want_fa, 0,
                                                    want_fa // 2):
        raise AssertionError(f"{what} {arch}: flash launches {counts}"
                             f", expected {want_fa} sm90 (forward and "
                             f"recompute of {attention_layers(cfg)} layers x "
                             f"{SHARDED['n_micro']} microbatches x "
                             f"{SHARDED['steps']} steps) and "
                             f"{want_fa // 2} of the backward kernel")
    if not all(math.isfinite(x) for x in sharded["losses"]
               + sharded["grad_norms"]):
        raise AssertionError(f"{what} {arch}: {sharded}")
    # an attention-free family launches none
    e = mean_rel = max_rel = None
    if want_fa:
        e, mean_rel, max_rel = fa_compare(
            f"{what} {arch}'s first DTensor-path launch", capture["out"],
            fa.attention_plain(capture["q"], capture["k"], capture["v"],
                               **capture["mask"]), "bfloat16")
    same = (sharded["losses"] == plain["losses"]
            and sharded["grad_norms"] == plain["grad_norms"]
            and first_diff is None)
    out = dict(arch=arch, layers=cfg.n_layers, depth_cut=cut,
               plain=plain, sharded=sharded, bit_equal=same,
               leaves=n_leaves, leaves_equal=equal, first_differing_leaf=first_diff,
               flash_attention_predicted=want_fa,
               captured_launch=dict(
                   shape=list(capture["q"].shape), mask=capture["mask"],
                   max_abs_err=e, mean_rel=mean_rel, max_rel=max_rel)
               if want_fa else None,
               seconds=time.perf_counter() - t0)
    print(f"{what} {arch} ({cfg.n_layers} layers, full width; "
          f"{SHARDED['steps']} steps of {SHARDED['n_micro']} x "
          f"{SHARDED['batch'] // SHARDED['n_micro']} x {SHARDED['seq']}) on "
          f"card_mesh with shard_grads: losses {sharded['losses']} (plain "
          f"{plain['losses']}), grad norms {sharded['grad_norms']} (plain "
          f"{plain['grad_norms']}); parameters {equal} of {out['leaves']} "
          f"leaves bit-equal"
          + ("" if first_diff is None else f", first differing {first_diff}")
          + f"; bit-equal {same}; flash launches {counts} (predicted "
          f"{want_fa}); step s {sharded['step_s']} (plain {plain['step_s']});"
          f" peak {sharded['peak_memory_bytes'] / 2**30:.2f} GiB (plain "
          f"{plain['peak_memory_bytes'] / 2**30:.2f}); "
          + ("" if not want_fa else
             f"first DTensor-path launch {out['captured_launch']['shape']} "
             f"against the plain version: max |err| {e:.3g}, mean rel "
             f"{mean_rel:.3g}, max rel {max_rel:.3g}; ")
          + f"{out['seconds']:.1f} s")
    if not same:
        # on (1, 1) every redistribution is a no-op: the kernels and the
        # order of every sum are the unsharded step's
        raise AssertionError(
            f"{what} {arch}: the sharded step on card_mesh is not "
            f"bit-equal to the unsharded one: losses {sharded['losses']} "
            f"against {plain['losses']}, grad norms "
            f"{sharded['grad_norms']} against {plain['grad_norms']}, "
            f"{equal} of {n_leaves} leaves equal, first differing leaf "
            f"{first_diff}")
    return out


def sharded_cards_rank(rank, n, store_path, out_path):
    """(b)'s rank `rank` of `n`, on cuda:`rank`: SHARDED_CARDS's steps on
    the (1, n) mesh with "shard_grads"; rank 0 writes the losses and
    gradient norms to `out_path` and the whole parameters, gathered, to
    `out_path`.pt."""
    import torch.distributed as dist
    from repro_torch.ckpt.checkpoint import tree_leaves
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.param import param_axes
    from repro_torch.sharding import make_plan, plan_context
    from repro_torch.sharding.planner import place_train_state
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(store_path, n),
                            rank=rank, world_size=n, device_id=dev)
    try:
        c = SHARDED_CARDS
        cfg = dataclasses.replace(get_config(c["arch"]), n_layers=c["layers"])
        mesh = make_debug_mesh(1, n)
        model = model_lib.build(cfg)
        opt = make_optimizer(cfg)
        params = model.init(seed=0, device=dev)
        axes = param_axes(cfg, params)
        plan = make_plan(cfg, mesh)
        specs = plan.param_specs(params, axes)
        state, batch = place_train_state(
            plan, TrainState(params, opt.init(params), torch.zeros(
                (), dtype=torch.int32, device=dev)), opt,
            make_batch(cfg, c["batch"], c["seq"], "train", seed=0,
                       device=dev), axes)
        del params
        step = make_train_step(model, opt, c["n_micro"],
                               opts=frozenset({"shard_grads"}),
                               grad_specs=specs, mesh=mesh)
        mask = torch.ones((c["n_micro"],), device=dev)
        losses, norms, times = [], [], []
        with plan_context(plan):
            for _ in range(c["steps"]):
                (state, m), dt = synced(lambda: step(state, batch, mask))
                losses.append(metric(m["loss"]))
                norms.append(metric(m["grad_norm"]))
                times.append(dt)
        whole = [p.full_tensor().detach().cpu()
                 for p in tree_leaves(state.params)]
        if rank == 0:
            torch.save(whole, f"{out_path}.pt")
            Path(out_path).write_text(json.dumps(dict(
                losses=losses, grad_norms=norms, step_s=times,
                peak_memory_bytes=torch.cuda.max_memory_allocated(dev))))
    finally:
        dist.destroy_process_group()


def phase_sharded_cards(dev) -> dict:
    """(b): only where the machine has two cards or more; on one card a
    line says that it did not run and why."""
    n = torch.cuda.device_count()
    c = SHARDED_CARDS
    if n < 2:
        reason = (f"{n} card visible: the (1, n) mesh of NCCL ranks needs "
                  f"two or more, one a card")
        print(f"phase 22 (b): did not run: {reason}")
        return dict(ran=False, cards=n, reason=reason)
    import torch.multiprocessing as tmp
    from repro_torch.ckpt.checkpoint import (tree_leaves,
                                             tree_leaves_with_paths)
    cfg = dataclasses.replace(get_config(c["arch"]), n_layers=c["layers"])
    model = model_lib.build(cfg)
    opt = make_optimizer(cfg)
    params = model.init(seed=0, device=dev)
    before = [p.detach().to("cpu", copy=True) for p in tree_leaves(params)]
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=dev))
    batch = make_batch(cfg, c["batch"], c["seq"], "train", seed=0,
                       device=dev)
    step = make_train_step(model, opt, c["n_micro"])
    mask = torch.ones((c["n_micro"],), device=dev)
    one, one_norms = [], []
    for _ in range(c["steps"]):
        state, m = step(state, batch, mask)
        one.append(float(m["loss"]))
        one_norms.append(float(m["grad_norm"]))
    paths = [str(path) for path, _ in tree_leaves_with_paths(state.params)]
    after = [p.detach().cpu() for p in tree_leaves(state.params)]
    del params, state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        tmp.spawn(sharded_cards_rank, args=(n, f"{d}/store", f"{d}/out.json"),
                  nprocs=n, join=True)
        got = json.loads(Path(f"{d}/out.json").read_text())
        whole = torch.load(f"{d}/out.json.pt")
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(got["losses"] + got["grad_norms"], one + one_norms))
    def leaf_rel_of(g, a, b):
        """A leaf's mean |difference| from the one card's over the mean
        |update| the one card's steps made to it."""
        d = float((g.float() - a.float()).abs().mean())
        u = float((a.float() - b.float()).abs().mean())
        return d / u if u > 0 else (0.0 if d == 0 else math.inf)

    leaf_rel = {path: leaf_rel_of(g, a, b)
                for path, g, a, b in zip(paths, whole, after, before)}
    worst = max(leaf_rel, key=leaf_rel.get)
    print(f"phase 22 (b): {c['arch']} at full width cut to {c['layers']} "
          f"layers on a (1, {n}) mesh of NCCL ranks: losses {got['losses']} "
          f"against one card's {one}, grad norms {got['grad_norms']} against "
          f"{one_norms} (largest relative difference {rel:.3g}, limit "
          f"{c['loss_rtol']}); parameters: the largest mean |difference| "
          f"over the mean |update| {leaf_rel[worst]:.3g} at {worst} (limit "
          f"{c['param_rtol']}); step s {got['step_s']}")
    if rel > c["loss_rtol"] or leaf_rel[worst] > c["param_rtol"]:
        raise AssertionError(
            f"phase 22 (b): losses {got['losses']} against {one}, grad "
            f"norms {got['grad_norms']} against {one_norms}, {worst}: "
            f"{leaf_rel[worst]:.3g} of its update")
    return dict(ran=True, cards=n, losses=got["losses"], one_card=one,
                grad_norms=got["grad_norms"], one_card_grad_norms=one_norms,
                max_rel_diff=rel, worst_leaf=worst,
                worst_leaf_rel=leaf_rel[worst], step_s=got["step_s"],
                peak_memory_bytes=got["peak_memory_bytes"])


def dryrun_row(rec) -> dict:
    """A dry-run record's figures and roofline row, as phases 20 and 22
    print them."""
    from repro_torch.launch import roofline
    row = roofline.roofline_row(rec)
    return dict(
        flops_per_device=rec["flops_per_device"],
        hbm_bytes_per_device=rec["hbm_bytes_per_device"],
        argument_bytes_per_device=rec["memory"]["argument_bytes"],
        fits=rec["fits"], dominant=row["dominant"],
        compute_s=row["compute_s"], memory_s=row["memory_s"],
        collective_s=row["collective_s"], ideal_s=row["ideal_s"],
        roofline_fraction=row["roofline_fraction"],
        model_flops=rec["model_flops"], trace_s=rec["trace_s"],
        n_micro=rec.get("n_micro"), plan_notes=rec["plan_notes"],
        flash_attention_entries=rec["flash_attention_entries"],
        flash_attention_backward_entries=rec[
            "flash_attention_backward_entries"],
        n_ops=rec["n_ops"], opts=rec.get("opts", []),
        per_device=rec["per_device"],
        collective_wire_bytes=rec["collective_wire_bytes"],
        collectives=rec["collectives"],
        top_collectives=rec.get("top_collectives"),
        cache_gathers=rec.get("cache_gathers"))


def phase_sharded_dryrun(futures, planner) -> dict:
    """(c): the 16x16 train_4k records of SHARDED_DRYRUN, traced sharded
    (per-device figures from rank 0's trace, wire bytes by collective),
    with their roofline rows and collective terms."""
    recs = {r["arch"]: dryrun_row(r) for f in futures for r in f.result()}
    for arch in ("gemma2-2b", "zamba2-7b"):
        recs[arch] = planner["dryrun"]["cells"][f"{arch}/train_4k/16x16"]
    out = {}
    for arch in SHARDED_DRYRUN:
        r = recs[arch]
        if r["per_device"] != "trace" or not r["collective_wire_bytes"] or \
                not {"all-gather", "reduce-scatter"} <= set(r["collectives"]) \
                or r["collective_s"] is None:
            raise AssertionError(f"phase 22 (c) {arch}: {r}")
        hand = r["fsdp_reckoning"] = fsdp_reckoning(arch)
        out[arch] = r
        print(f"phase 22 (c) {arch}/train_4k/16x16, sharded trace: flops/dev "
              f"{r['flops_per_device']:.4e}, bytes/dev "
              f"{r['hbm_bytes_per_device']:.4e}, wire bytes/dev "
              f"{r['collective_wire_bytes']:.4e} ("
              + ", ".join(f"{k} {v['count']:.0f} x, {v['wire_bytes']:.4e} B"
                          for k, v in r["collectives"].items())
              + f"); roofline compute {r['compute_s']:.4f} s, memory "
              f"{r['memory_s']:.4f} s, collective {r['collective_s']:.4f} s, "
              f"dominant {r['dominant']}, fraction "
              f"{r['roofline_fraction']:.4f} (trace {r['trace_s']:.1f} s); "
              f"by hand, the parameters' all-gathers "
              f"{hand['all_gather_bytes']:.4e} B and their gradients' "
              f"reduce-scatters {hand['reduce_scatter_bytes']:.4e} B, the "
              f"traced wire {r['collective_wire_bytes'] / hand['total_bytes']:.2f}"
              f"x that; largest: " + "; ".join(
                  f"{c['kind']} {c['count']:.0f} x {c['operands']} -> "
              f"{c['results']} {c['dtype']} {c['wire_bytes']:.4e} B"
                  for c in r["top_collectives"][:6]))
    return out


def phase_sharded_train(dev, planner, phase16_peak, dry) -> dict:
    """Phase 22: the sharded train step. (a) runs on card_mesh, (b) only
    on several cards, (c) reads the traces of the processes `dry`
    started (`start_dryrun(sharded_dryrun_groups())`)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import card_mesh
    t0 = time.perf_counter()
    mesh = card_mesh()
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"card_mesh: backend "
                                 f"{dist.get_backend()}, not nccl")
        out = {arch: sharded_against_plain(arch, dev, mesh)
               for arch in SHARDED["archs"]}
    finally:
        dist.destroy_process_group()
    peak = max(out[a]["sharded"]["peak_memory_bytes"]
               for a in SHARDED["archs"])
    print(f"phase 22 (a): peak device memory of the sharded steps "
          f"{peak / 2**30:.2f} GiB, beside phase 16's "
          f"{phase16_peak / 2**30:.2f} GiB")
    out["phase16_peak_memory_bytes"] = phase16_peak
    out["cards"] = phase_sharded_cards(dev)
    out["dryrun"] = phase_sharded_dryrun(dry[1], planner)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 22: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 23: sharded prefill and decode
# ---------------------------------------------------------------------------

# on card_mesh() (NCCL, (1, 1)): `Model.prefill` and `Model.decode_step`
# on weights (cast to bf16 once, as the Engine casts them), prompt,
# tokens and caches placed by `place_serve_state` under `plan_context`,
# against the same calls unsharded: gemma2-2b at full width and
# zamba2-7b at full width cut to `groups` of its 13 groups (the tail
# kept), for the phase's seconds; 4 x 2048 prompts and 16 greedy steps
SHARDED_SERVE = dict(archs=("gemma2-2b", "zamba2-7b"), batch=4, prompt=2048,
                     tokens=16, groups={"zamba2-7b": 4})


def sharded_serve_config(arch):
    """(config, depth record) of phase 23's `arch`."""
    cfg = get_config(arch)
    n = SHARDED_SERVE["groups"].get(arch)
    if n is None:
        return cfg, None
    per = cfg.hybrid.shared_attn_every
    tail = cfg.n_layers - (cfg.n_layers // per) * per
    cut = dataclasses.replace(cfg, n_layers=n * per + tail)
    return cut, dict(unit="groups", kept=n, full=cfg.n_layers // per,
                     layers=cut.n_layers, full_layers=cfg.n_layers)


def host_tree(tree):
    """Every tensor of a cache (a DTensor's local shard: the whole of it
    on card_mesh) copied to the host."""
    from repro_torch.ckpt.checkpoint import tree_map
    return tree_map(lambda x: (x.to_local() if hasattr(x, "to_local")
                               else x).to("cpu", copy=True), tree)


def sharded_serve_run(cfg, dev, mesh=None, capture=None) -> dict:
    """SHARDED_SERVE's prefill and greedy decode steps of `cfg` from
    seed 0, unsharded, or on `mesh` with the weights, prompt, tokens
    and caches placed by the plan; the counts set to 0 just before the
    prefill. `capture`, a dict, gets the first flash-attention launch's
    inputs and output. Returns the logits of every step, the tokens and
    the caches after the prefill and after the last step (on the host),
    the counts, times and peak memory."""
    from repro_torch.models.param import param_axes
    from repro_torch.sharding import make_plan, plan_context
    from repro_torch.sharding.planner import place_serve_state
    c = SHARDED_SERVE
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = model_lib.build(cfg)
    params = cast_weights(model.init(seed=0, device=dev), torch.bfloat16)
    batch = make_batch(cfg, c["batch"], c["prompt"], "prefill", seed=0,
                       device=dev)
    ctx, place_tokens = contextlib.nullcontext(), lambda t: t
    if mesh is not None:
        plan = make_plan(cfg, mesh)
        params, batch, _, _ = place_serve_state(
            plan, params, param_axes(cfg, params), batch=batch)
        ctx = plan_context(plan)
        place_tokens = lambda t: place_serve_state(plan, {}, tokens=t)[3]
    launch = fa._launch

    def captured(route, q, k, v, causal, softcap, window=None, prefix_len=0):
        out = launch(route, q, k, v, causal, softcap, window, prefix_len)
        if capture is not None and not capture:
            capture.update(q=q.clone(), k=k.clone(), v=v.clone(),
                           out=out.clone(), mask=dict(
                               causal=causal, softcap=softcap, window=window,
                               prefix_len=prefix_len))
        return out

    V = cfg.vocab_size
    out = dict(logits=[], tokens=[], step_s=[])
    reset_counts()
    fa._launch = captured
    try:
        with ctx, torch.no_grad():
            (logits, cache), out["prefill_s"] = synced(
                lambda: model.prefill(params, batch,
                                      c["prompt"] + c["tokens"]))
            out["prefill_counts"] = fa_counts()
            out["prefill_cache"] = host_tree(cache)
            for _ in range(c["tokens"]):
                local = logits.to_local() if hasattr(logits, "to_local") \
                    else logits
                out["logits"].append(local.to("cpu", copy=True))
                tok = local[:, -1:, :V].argmax(-1).to(torch.int32)
                out["tokens"].append(tok[:, 0].tolist())
                (logits, cache), dt = synced(
                    lambda: model.decode_step(params, place_tokens(tok),
                                              cache))
                out["step_s"].append(dt)
            out["logits"].append(host_tree(logits))
            out["final_cache"] = host_tree(cache)
    finally:
        fa._launch = launch
    out["counts"] = fa_counts()
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def first_difference(got, want):
    """The first leaf of two host trees that differs, and its largest
    difference; None where every leaf is bit-equal."""
    from repro_torch.ckpt.checkpoint import tree_leaves_with_paths
    for (path, g), (_, w) in zip(tree_leaves_with_paths(got),
                                 tree_leaves_with_paths(want)):
        if not torch.equal(g, w):
            return dict(leaf=str(path), max_abs_diff=float(
                (g.double() - w.double()).abs().max()))
    return None


def sharded_serve_against_plain(arch, dev, mesh) -> dict:
    """Phase 23 for one arch: the unsharded run, then the sharded run;
    every step's logits, the greedy tokens and every cache leaf after the
    prefill and after the last step bit-equal (or it raises, naming the
    first difference); flash launches counted (one a prefill's attention
    layer, none a decode step) and the first one held against the plain
    version on its own inputs."""
    t0 = time.perf_counter()
    cfg, cut = sharded_serve_config(arch)
    plain = sharded_serve_run(cfg, dev)
    capture = {}
    sharded = sharded_serve_run(cfg, dev, mesh, capture)
    diffs = {
        "logits": next((dict(step=i, max_abs_diff=float(
            (g.double() - w.double()).abs().max()))
            for i, (g, w) in enumerate(zip(sharded["logits"],
                                           plain["logits"]))
            if not torch.equal(g, w)), None),
        "tokens": None if sharded["tokens"] == plain["tokens"] else dict(
            sharded=sharded["tokens"], plain=plain["tokens"]),
        "prefill_cache": first_difference(sharded["prefill_cache"],
                                          plain["prefill_cache"]),
        "final_cache": first_difference(sharded["final_cache"],
                                        plain["final_cache"])}
    want_fa = attention_layers(cfg)
    counts = sharded["counts"]
    e, mean_rel, max_rel = (None,) * 3
    if want_fa:
        e, mean_rel, max_rel = fa_compare(
            f"phase 23 {arch}'s first DTensor-path launch", capture["out"],
            fa.attention_plain(capture["q"], capture["k"], capture["v"],
                               **capture["mask"]), "bfloat16")
    same = not any(diffs.values())
    n_cache = len(list(tree_leaves_named(sharded["final_cache"])))
    out = dict(arch=arch, layers=cfg.n_layers, depth_cut=cut,
               bit_equal=same, differences=diffs, cache_leaves=n_cache,
               tokens=sharded["tokens"],
               counts=counts, prefill_counts=sharded["prefill_counts"],
               flash_attention_predicted=want_fa,
               prefill_s=dict(sharded=sharded["prefill_s"],
                              plain=plain["prefill_s"]),
               decode_step_s=dict(sharded=sharded["step_s"],
                                  plain=plain["step_s"]),
               peak_memory_bytes=dict(sharded=sharded["peak_memory_bytes"],
                                      plain=plain["peak_memory_bytes"]),
               captured_launch=dict(
                   shape=list(capture["q"].shape), mask=capture["mask"],
                   max_abs_err=e, mean_rel=mean_rel, max_rel=max_rel)
               if want_fa else None,
               seconds=time.perf_counter() - t0)
    c = SHARDED_SERVE
    mean = lambda xs: sum(xs) / len(xs)
    print(f"phase 23 {arch} ({cfg.n_layers} layers, full width, bf16 "
          f"weights; {c['batch']} x {c['prompt']} prompt, {c['tokens']} "
          f"greedy steps) on card_mesh: logits, tokens and {n_cache} cache "
          f"leaves bit-equal {same}"
          + ("" if same else f" ({ {k: v for k, v in diffs.items() if v} })")
          + f"; flash launches {counts} (predicted {want_fa}, all in the "
          f"prefill); prefill s {sharded['prefill_s']:.3f} (plain "
          f"{plain['prefill_s']:.3f}), decode step s "
          f"{mean(sharded['step_s']):.4f} (plain "
          f"{mean(plain['step_s']):.4f}); peak "
          f"{sharded['peak_memory_bytes'] / 2**30:.2f} GiB (plain "
          f"{plain['peak_memory_bytes'] / 2**30:.2f}); "
          + ("" if not want_fa else
             f"first DTensor-path launch {out['captured_launch']['shape']} "
             f"against the plain version: max |err| {e:.3g}, mean rel "
             f"{mean_rel:.3g}, max rel {max_rel:.3g}; ")
          + f"{out['seconds']:.1f} s")
    if not same:
        # on (1, 1) every redistribution is a no-op: the kernels and the
        # order of every sum are the unsharded calls'
        raise AssertionError(f"phase 23 {arch}: sharded prefill and decode "
                             f"on card_mesh not bit-equal: {diffs}")
    if (counts["flash_attention"], counts["flash_attention_sm90"],
            counts["flash_attention_simt"]) != (want_fa, want_fa, 0) or \
            sharded["prefill_counts"] != counts:
        raise AssertionError(f"phase 23 {arch}: flash launches {counts} "
                             f"(prefill {sharded['prefill_counts']}), "
                             f"expected {want_fa} sm90 in the prefill")
    return out


def phase_sharded_serve(dev) -> dict:
    """Phase 23: sharded prefill and decode on card_mesh."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import card_mesh
    t0 = time.perf_counter()
    mesh = card_mesh()
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"card_mesh: backend {dist.get_backend()}, "
                                 f"not nccl")
        out = {arch: sharded_serve_against_plain(arch, dev, mesh)
               for arch in SHARDED_SERVE["archs"]}
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 23: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 24: the registered configs never built on the card
# ---------------------------------------------------------------------------

# chatglm3-6b (32 query heads over 2 kv heads, a group of 16; RoPE on half
# of each head dim), mistral-nemo-12b (32 over 8; a 131,072-token
# vocabulary), deepseek-coder-33b (d_model 7168, 56 heads over 8, a group
# of 7) and arctic-480b (deepseek's attention, 128 experts top-2 beside a
# dense residual, bf16 parameters, Adafactor): published widths, cut only
# in depth, each cut printed
CONFIG_ARCHS = ("chatglm3-6b", "mistral-nemo-12b", "deepseek-coder-33b",
                "arctic-480b")
CONFIG_DENSE = CONFIG_ARCHS[:3]
# (a) each config's flash-attention launch at 4 x 2048 tokens, causal, no
# softcap, bf16, the model's strided views (fa_path_times): (B, H, K, S,
# D); arctic-480b's attention is deepseek-coder-33b's
CONFIG_FA = {"chatglm3-6b": (4, 32, 2, 2048, 128),
             "mistral-nemo-12b": (4, 32, 8, 2048, 128),
             "deepseek-coder-33b": (4, 56, 8, 2048, 128)}
# (b) the Engine in bf16 compute, a 4 x 2048 prompt and 16 greedy tokens
# (32 before PR 32, as phase 17's paths):
# chatglm3-6b (6.24e9 parameters, 25.0 GB in f32, at full depth) and
# mistral-nemo-12b (12.25e9, 49.0 GB) cut to 14 of 28 and 20 of 40 layers
# since PR 32 (for the script's seconds), built in f32 and cast once;
# deepseek-coder-33b (33.3e9) cut to 16 of 62 layers (8.95e9, 35.8 GB);
# arctic-480b in its bf16 to 2 of 35 layers (27.68e9, 55.4 GB). The
# profiled generate decodes 8 tokens: a 32-token generate's ~100,000
# device ops take the profiler some 20 s to read back
CONFIG_SERVE = tuple(
    dict(arch=a, batch=4, prompt=2048, tokens=16, profile_tokens=8, **cut)
    for a, cut in (("chatglm3-6b", dict(n_layers=14)),
                   ("mistral-nemo-12b", dict(n_layers=20)),
                   ("deepseek-coder-33b", dict(n_layers=16)),
                   ("arctic-480b", dict(n_layers=2))))
# (c) card against the CPU at full width, f32 compute, the same seeded
# weights: the dense configs cut to 2 layers through ssm_step_compare (B
# 1, a 64-token prompt, 3 decode steps fed the CPU's choices, each card
# step from the CPU's cache; the SIMT route, one launch a layer): the
# bf16 kv cache rounds f32 values that differ by ~1e-6 between the two,
# and one element rounded the other way moved chatglm3-6b's next logits
# by 1.4e-3 when each side decoded from its own cache (recorded beside,
# not held); arctic-480b cut to 1 layer with its bf16
# parameters on both sides (widened where used), the forward's logits of
# 1 x 32 tokens. The CPU's side of arctic holds 28.1 GB of parameters
# and one expert leaf widened to f32 (17.9 GB) at a time: the host's
# MemAvailable must hold that and ARCTIC_HOST_MARGIN more
CONFIG_CHECK = dict(layers=2, batch=1, prompt=64, tokens=3, tol=1e-4,
                    arctic_layers=1, arctic_seq=32)
ARCTIC_HOST_MARGIN = 4 * 2 ** 30
# (d) training at full width: the dense configs through the Trainer as
# phase 19 (c) trains olmoe-1b-7b (f32 parameters, AdamW, bf16 compute,
# remat, FAMILY_STEPS steps of 4 microbatches of 1 x 2048, the governor
# on), cut in depth to the most layers whose 16 bytes a parameter leave
# 10 GiB of the card (mistral-nemo-12b 16 GiB: its loss holds (2048,
# 131,072) f32 logits and their gradients, and 12 layers ran out of
# memory at 10 GiB); arctic-480b through make_train_step with its own
# optimizer (Adafactor) and bf16 parameters, 1 layer, one microbatch of
# 4 x 2048 tokens a step (a second microbatch would need the 56.3 GB f32
# accumulator of the reference's default path beside the 56.3 GB of bf16
# parameters and gradients), 3 steps at a constant rate
CONFIG_TRAIN = tuple(
    dict(arch=a, via="trainer", cut="layers",
         headroom=(16 if a == "mistral-nemo-12b" else 10) * 2 ** 30)
    for a in CONFIG_DENSE)
ARCTIC_TRAIN = dict(arch="arctic-480b", layers=1, batch=4, seq=2048,
                    steps=3, lr=1e-3, check_experts=8, rtol=1e-6)
# (e) the dense configs cut to 1 layer, one make_train_step on the card
# and on the CPU, phase 19 (b)'s limits
CONFIG_TRAIN_CHECK = {a: dict(n_layers=1) for a in CONFIG_DENSE}


def mem_available() -> int:
    """The host's MemAvailable, bytes (/proc/meminfo)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def config_check(arch, dev) -> dict:
    """(c) one config at full width, f32 compute, the same seeded weights
    on the card (SIMT route) and on the CPU (plain path): a dense config
    cut to CONFIG_CHECK["layers"] through ssm_step_compare (logits and
    caches at every step, each card decode step from the CPU's cache);
    arctic-480b cut to one layer, its bf16 parameters on both sides, the
    forward's logits."""
    c = CONFIG_CHECK
    t0 = time.perf_counter()
    base = get_config(arch)
    n_layers = c["layers"] if base.moe is None else c["arctic_layers"]
    cfg = dataclasses.replace(base, n_layers=n_layers,
                              compute_dtype="float32")
    model = model_lib.build(cfg)
    params = model.init(seed=1, device=dev)
    reset_counts()
    out = dict(layers=n_layers, param_dtype=cfg.param_dtype)
    if base.moe is None:
        batch = make_batch(cfg, c["batch"], c["prompt"], "prefill", seed=1,
                           device="cpu")
        max_seq = c["prompt"] + c["tokens"]
        card = Engine.build(cfg, max_seq=max_seq, params=params, device=dev)
        host = Engine.build(cfg, max_seq=max_seq, params=params,
                            device="cpu")
        del params
        err, clear, free_err, caches = ssm_step_compare(
            cfg, card, host, batch, max_seq, c["tokens"], c["tol"])
        del card, host
        out.update(max_logit_err=err, clear_choices=clear,
                   free_running_max_logit_err=free_err, caches=caches)
    else:
        leaves = ckpt.checkpoint.tree_leaves(params)
        host_bytes = sum(x.numel() * x.element_size() for x in leaves)
        widened = 4 * max(x.numel() for x in leaves)
        need = host_bytes + widened + ARCTIC_HOST_MARGIN
        avail = mem_available()
        print(f"config check {arch}: host MemAvailable {avail / 1e9:.1f} GB;"
              f" the CPU's side needs {host_bytes / 1e9:.1f} GB of "
              f"{cfg.param_dtype} parameters + {widened / 1e9:.1f} GB for one"
              f" expert leaf widened to f32 + {ARCTIC_HOST_MARGIN / 1e9:.1f}"
              f" GB = {need / 1e9:.1f} GB")
        if avail < need:
            raise AssertionError(f"config check {arch}: the host has "
                                 f"{avail / 1e9:.1f} GB available, the CPU's"
                                 f" forward needs {need / 1e9:.1f} GB")
        batch = make_batch(cfg, c["batch"], c["arctic_seq"], "prefill",
                           seed=1, device="cpu")
        with torch.no_grad():
            lg = model.forward(params, {k: v.to(dev) for k, v in
                                        batch.items()})[0].cpu()
            host = to_host(params)
            del params
            torch.cuda.empty_cache()
            lc = model.forward(host, batch)[0]
        del host
        err = float((lg - lc).abs().max())
        if not bool(torch.isfinite(lg).all()) or not torch.allclose(
                lg, lc, rtol=c["tol"], atol=c["tol"]):
            raise AssertionError(f"config check {arch}: card logits "
                                 f"{err:.3g} off the CPU's (tol {c['tol']})")
        out.update(max_logit_err=err, clear_choices=None,
                   host_need_bytes=need, host_available_bytes=avail)
        del lg, lc
    counts = fa_counts()
    if (counts["flash_attention"], counts["flash_attention_simt"]) != (
            n_layers, n_layers):
        raise AssertionError(f"config check {arch}: launches {counts}, "
                             f"expected {n_layers} on the simt route")
    gc.collect()
    torch.cuda.empty_cache()
    out.update(seconds=time.perf_counter() - t0,
               simt_launches=counts["flash_attention_simt"])
    print(f"config check {arch} ({n_layers} layers, full width, f32 "
          f"compute, {cfg.param_dtype} parameters): card equals the CPU's "
          f"plain path, max logit err {out['max_logit_err']:.3g} (tol "
          f"{c['tol']}); clear greedy choices {out['clear_choices']}; "
          f"from its own caches "
          f"{out.get('free_running_max_logit_err')}; caches "
          f"{out.get('caches')}; {out['seconds']:.1f} s")
    return out


class SliceRecorder:
    """An optimizer that keeps, at its first update, the first `n` experts
    of the gradient and of the parameter at `path` (before the update),
    then updates as the optimizer it wraps."""

    def __init__(self, opt, path, n):
        self.opt, self.path, self.n = opt, path, n
        self.grad = self.param = None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, lr_scale=1.0):
        if self.grad is None:
            at = lambda tree: dict(ckpt.checkpoint.tree_leaves_with_paths(
                tree))[self.path][:self.n].detach().clone()
            self.grad, self.param = at(grads), at(params)
        return self.opt.update(grads, state, params, lr_scale=lr_scale)


def streamed_against_whole(grad, param, lr, rtol) -> dict:
    """(e) for arctic-480b: the card's own gradient of an expert slice,
    taken with its parameter (widened to f32) as a leaf of its own,
    through one Adafactor update streamed in SLICE_ELEMS-element slices
    and through one unstreamed (one slice): every statistic bit-equal,
    every parameter within `rtol` of its largest value (only the clip's
    sum of squares is added in another order), each update's peak memory
    above what it was given."""
    from repro_torch.train import Adafactor
    from repro_torch.train.optimizer import SLICE_ELEMS
    runs = {}
    for name, n in (("streamed", SLICE_ELEMS), ("whole", grad.numel())):
        opt = Adafactor(lr=lr, slice_elems=n)
        p = {"w": param.to(torch.float32)}
        state = opt.init(p)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        opt.update({"w": grad}, state, p)
        torch.cuda.synchronize()
        runs[name] = (p["w"], state,
                      torch.cuda.max_memory_allocated() - base)
    (a, sa, peak_a), (b, sb, peak_b) = runs["streamed"], runs["whole"]
    for f in ("vr", "vc"):
        if not torch.equal(getattr(sa, f)["w"], getattr(sb, f)["w"]):
            raise AssertionError(f"streamed Adafactor: statistic {f} differs"
                                 f" from the unstreamed update's")
    rel = float((a - b).abs().max() / b.abs().max())
    if not rel <= rtol:
        raise AssertionError(f"streamed Adafactor: parameters {rel:.3g} of "
                             f"their max off the unstreamed update's (limit "
                             f"{rtol})")
    out = dict(shape=list(grad.shape), slices=math.ceil(
        grad.shape[0] / max(1, SLICE_ELEMS // grad[0].numel())),
        stats_bit_equal=True, param_rel=rel, peak_streamed_bytes=peak_a,
        peak_whole_bytes=peak_b)
    print(f"  streamed Adafactor on the card's gradient of "
          f"{tuple(grad.shape)} experts ({out['slices']} slices): vr and vc "
          f"bit-equal to the unstreamed update's, parameters within "
          f"{rel:.3g} of their max (limit {rtol}); peak above its inputs "
          f"{peak_a / 2**30:.2f} GiB streamed, {peak_b / 2**30:.2f} GiB "
          f"whole")
    return out


def arctic_train(dev) -> dict:
    """(d) arctic-480b at full width cut to ARCTIC_TRAIN's layers:
    make_train_step with its own optimizer (Adafactor, stack_period from
    its block pattern), bf16 parameters and compute, one microbatch a
    step, every count set to 0 just before the first step and read after
    the last (2 sm90 launches an attention layer a step: forward and
    remat recompute); losses finite and falling; step s, tokens/s, peak
    memory; then (e) the streamed update against the unstreamed one on
    the first step's gradient of ARCTIC_TRAIN["check_experts"] experts."""
    s = ARCTIC_TRAIN
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    base = get_config(s["arch"])
    cfg = dataclasses.replace(base, n_layers=s["layers"])
    model = model_lib.build(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, build_s = synced(lambda: model.init(seed=0, device=dev))
    n_params = n_elements(params)
    param_bytes = sum(x.numel() * x.element_size()
                      for x in ckpt.checkpoint.tree_leaves(params))
    rec = SliceRecorder(make_optimizer(cfg, lr=s["lr"]),
                        ("blocks", 0, "moe", "wi_gate"), s["check_experts"])
    state = TrainState(params, rec.init(params),
                       torch.zeros((), dtype=torch.int32, device=dev))
    del params
    step = make_train_step(model, rec, 1)
    batch = make_batch(cfg, s["batch"], s["seq"], "train", seed=0,
                       device=dev)
    mask = torch.ones((1,), device=dev)
    reset_counts()
    losses, norms, times = [], [], []
    for _ in range(s["steps"]):
        (state, m), dt = synced(lambda: step(state, batch, mask))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        times.append(dt)
    counts = fa_counts()
    peak = torch.cuda.max_memory_allocated()
    want_fa = 2 * cfg.n_layers * s["steps"]
    if (counts["flash_attention"], counts["flash_attention_sm90"]) != (
            want_fa, want_fa):
        raise AssertionError(f"train {cfg.name}: launches {counts}, expected "
                             f"{want_fa} sm90 (forward and recompute of "
                             f"{cfg.n_layers} layers x {s['steps']} steps)")
    if not all(math.isfinite(x) for x in losses + norms) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train {cfg.name}: losses {losses}, gradient "
                             f"norms {norms} (finite, the loss lower at the "
                             f"last step than at the first)")
    warm_s = sorted(times[1:])[len(times[1:]) // 2]
    opt = rec.opt
    out = dict(arch=s["arch"], via="make_train_step", layers=cfg.n_layers,
               full_layers=base.n_layers, params=n_params,
               param_bytes=param_bytes, param_dtype=cfg.param_dtype,
               optimizer=type(opt).__name__, stack_period=opt.stack_period,
               batch=dict(seqs=s["batch"], seq=s["seq"], n_micro=1),
               build_s=build_s, losses=losses, grad_norms=norms,
               step_s=times, first_step_s=times[0], warm_step_s=warm_s,
               tokens_per_s=s["batch"] * s["seq"] / warm_s,
               peak_memory_bytes=peak, counts=counts,
               flash_attention_predicted=want_fa)
    print(f"train {cfg.name} via make_train_step ({cfg.n_layers} of "
          f"{base.n_layers} layers, {n_params:,} parameters, "
          f"{cfg.param_dtype}, {param_bytes / 1e9:.1f} GB; "
          f"{type(opt).__name__} stack_period {opt.stack_period}; "
          f"{s['steps']} steps of 1 x {s['batch']} x {s['seq']}): build "
          f"{build_s:.2f} s; losses {losses}; gradient norms {norms}; step s "
          f"{times} (warm {warm_s:.3f}); {out['tokens_per_s']:.0f} tokens/s; "
          f"peak device memory {peak / 2**30:.2f} GiB; launches {counts}")
    grad, param = rec.grad, rec.param
    del state, batch, step, rec, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    out["streamed_check"] = streamed_against_whole(grad, param, s["lr"],
                                                   s["rtol"])
    del grad, param
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_configs(dev, refs=None) -> dict:
    """Phase 24: the registered configs never built on the card: (a) their
    flash-attention launches, (b) served, (c) card against the CPU, (d)
    trained at full width, (e) train steps against the CPU and arctic's
    streamed Adafactor update. (e)'s train checks take the last of the
    worker's CPU steps (`refs`), which then stops, so that arctic-480b's
    CPU check (c), some 50 GB of host memory, runs by itself."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    print(f"phase 24: device memory free {free / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB; host MemAvailable "
          f"{mem_available() / 1e9:.1f} GB")
    out, secs = {}, {}

    def timed(name, fn):
        t = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t

    timed("fa", lambda: {a: fa_path_times(dev, shape, 240 + i, a)
                         for i, (a, shape) in enumerate(CONFIG_FA.items())})
    timed("serve", lambda: {spec["arch"]: engine_path(spec, dev)
                            for spec in CONFIG_SERVE})
    timed("check", lambda: {a: config_check(a, dev) for a in CONFIG_DENSE})

    def train_checks():
        with host_heap_reuse():
            return {a: train_family_check(a, (), dev, CONFIG_TRAIN_CHECK,
                                          refs=refs)
                    for a in CONFIG_DENSE}

    timed("train_check", train_checks)
    stop_cpu_refs(refs)
    arctic = CONFIG_ARCHS[3]
    timed("check_arctic", lambda: config_check(arctic, dev))
    out["check"][arctic] = out.pop("check_arctic")
    timed("train", lambda: {spec["arch"]: train_family(spec, dev)
                            for spec in CONFIG_TRAIN})
    timed("train_arctic", lambda: arctic_train(dev))
    out["train"][ARCTIC_TRAIN["arch"]] = out.pop("train_arctic")
    out["seconds_by_part"] = secs
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 24: {out['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()) + ")")
    return out


# ---------------------------------------------------------------------------
# phase 25: the attention gradient as a kernel, and remat="dots"
# ---------------------------------------------------------------------------

# (a) the backward kernel against attention_backward_plain on the card:
# phase 16 (a)'s cases (and its hot softcaps, q scaled by FA_HOT_SCALE),
# phase 17's masks, phase 19 (a)'s head dims 80 and 112 (and their hot
# cases), phase 24's groups 16, 4 and 7; f32 within FA_GRAD_F32 of each
# gradient's max, bf16 within FA_MEAN_REL / FA_MAX_REL; two calls the
# same bits
BWD_CASES = tuple(
    [((B, H, K, S, D, dt, causal, None, 0, cap, views), q_scale)
     for (B, H, K, S, D, dt, causal, cap, views), q_scale in
     [(x, 1.0) for x in FA_SHAPES + (FA_TRAIN + (True,),)]
     + [(x, FA_HOT_SCALE) for x in FA_HOT_SHAPES]]
    + [(c, 1.0) for c in FA_MASK_CASES + FA_GRAD_CASES]
    + [(c, FA_HOT_SCALE) for c in FA_GRAD_HOT]
    + [((*CONFIG_FA[a], "bfloat16", True, None, 0, None, True), 1.0)
       for a in CONFIG_DENSE])
# SDPA's backward (phase 25 (a)'s yardstick) is the median of this many
# runs of 20 calls (CUDA events: single runs have read 0.2371 and 1.151
# ms), beside its device time (`device_ms_per_call`), which the host's
# speed does not move: the medians read 0.2322 to 0.3365 ms across hosts
BWD_LIBRARY_RUNS = 9
# (a) the tensor-core backward's two dk/dv schedules (`splits_heads`: one
# block a query head and a head-sum launch, or one block a kv head), each
# timed at FA_TRAIN and at two of phase 24's launches (4 x 2048, causal,
# no softcap, the model's views): FA_TRAIN's 128 blocks a kv head are
# below the threshold (132 SMs), chatglm3-6b's 256 and mistral-nemo-12b's
# 1024 above it
BWD_ROUTE_SHAPES = (FA_TRAIN, (4, 32, 2, 2048, 128, "bfloat16", True, None),
                    (4, 32, 8, 2048, 128, "bfloat16", True, None))
# (b) the extra peak memory of one backward at gemma2-2b's 1 x 8192 local
# layer: (B, H, K, S, D), causal, window, softcap; the kernel's limit and
# the least the plain version's (B, K, G, S, S) f32 tensors take
BWD_LONG = dict(shape=(1, 8, 4, 8192, 256), window=4096, cap=50.0,
                kernel_limit=256 * 2**20, plain_least=2 * 2**30)
# (c) remat="dots" against "full": gemma2-2b at full width and
# olmoe-1b-7b cut to 2 layers, SHARDED's 2 steps of 4 microbatches of 1 x
# 2048 from seed 0 (f32 parameters, AdamW, bf16 compute); then gemma2-2b
# cut to 2 layers under "dots" on card_mesh against unsharded (phase 22
# (a)'s check)
REMAT = dict(archs=(("gemma2-2b", None), ("olmoe-1b-7b", 2)),
             sharded=("gemma2-2b", 2))
# (d) the dry run's train_4k cells of gemma2-2b and olmoe-1b-7b on h100
# and 16x16 with the reference's options remat_dots and blockattn; the
# default records are phase 20 (a)'s (gemma2-2b) and phase 22 (c)'s
# (olmoe-1b-7b on 16x16) but olmoe-1b-7b's on h100, traced here. Three
# processes started after phase 20, beside phases 21 to 24, balanced by
# trace time
REMAT_DRYRUN_GROUPS = (
    (("gemma2-2b", "train_4k", "h100", ("remat_dots",)),
     ("gemma2-2b", "train_4k", "16x16", ("remat_dots",)),
     ("olmoe-1b-7b", "train_4k", "h100")),
    (("gemma2-2b", "train_4k", "h100", ("blockattn",)),
     ("gemma2-2b", "train_4k", "16x16", ("blockattn",)),
     ("olmoe-1b-7b", "train_4k", "h100", ("remat_dots",))),
    (("olmoe-1b-7b", "train_4k", "16x16", ("remat_dots",)),
     ("olmoe-1b-7b", "train_4k", "16x16", ("blockattn",)),
     ("olmoe-1b-7b", "train_4k", "h100", ("blockattn",))))


def bwd_inputs(case, q_scale, seed, dev):
    """Case `case`'s q, k, v (fa_inputs) and a seeded dout of q's type."""
    B, H, K, S, D, dt, causal, window, prefix, cap, views = case
    q, k, v = fa_inputs(B, H, K, S, D, dt, seed, dev, views=views,
                        q_scale=q_scale)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 10_000)
    dout = torch.randn((B, H, S, D), generator=g, device=dev).to(q.dtype)
    mask = dict(causal=causal, softcap=cap, window=window, prefix_len=prefix)
    return q, k, v, dout, mask


def unaligned(x):
    """x's values in a tensor of its shape whose storage starts one element
    past an allocation: no 16-byte loads for the kernel."""
    out = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    return out.view(x.shape).copy_(x)


def bwd_check(dev) -> dict:
    """(a)'s checks: every case of BWD_CASES through the kernel twice (one
    launch a call, the same bits) and the plain version, and the first
    case of each type again with unaligned inputs (the f32 kernel's
    element-by-element loads, the copies the bf16 wrapper makes for TMA),
    which must give the aligned inputs' bits; the worst max |err| and
    relative readings by type, and the zeros excused (`excused_zeros`)."""
    worst = {dt: dict(max_abs_err=0.0, mean_rel=0.0, max_rel=0.0)
             for dt in ("float32", "bfloat16")}
    n = {"float32": 0, "bfloat16": 0, "unaligned": 0}
    first, aligned, excused = {}, {}, []
    cases = [(i, c, qs, False) for i, (c, qs) in enumerate(BWD_CASES)]
    for i, (case, q_scale) in enumerate(BWD_CASES):
        first.setdefault(case[5], (i, case, q_scale, True))
    for i, case, q_scale, skew in cases + list(first.values()):
        dt = case[5]
        q, k, v, dout, mask = bwd_inputs(case, q_scale, 1300 + i, dev)
        if skew:
            q, k, v, dout = (unaligned(x) for x in (q, k, v, dout))
        before = fa.launches_backward
        got = fa.attention_backward(q, k, v, dout, **mask)
        again = fa.attention_backward(q, k, v, dout, **mask)
        torch.cuda.synchronize()
        if fa.launches_backward != before + 2:
            raise AssertionError(f"phase 25 (a) {case}: backward launches "
                                 f"moved {fa.launches_backward - before}, "
                                 f"expected 2")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"phase 25 (a) {case}: two calls gave other "
                                 f"bits")
        if skew:
            if not all(torch.equal(a, b) for a, b in zip(got, aligned[i])):
                raise AssertionError(f"phase 25 (a) {case}: unaligned inputs "
                                     f"gave other bits than aligned ones")
            n["unaligned"] += 1
            del q, k, v, dout, got, again
            continue
        if first[dt][0] == i:
            aligned[i] = got
        want = fa.attention_backward_plain(q, k, v, dout, **mask)
        ref = rounding_reference(q, k, v, dout, mask)
        for name, a, b in zip("qkv", got, want):
            rel = fa_grad_compare(f"phase 25 (a) d{name} {case} q "
                                  f"x{q_scale:g}", a, b, dt,
                                  exact=functools.partial(ref, name))
            w = worst[dt]
            w.update(max_abs_err=max(w["max_abs_err"], float(
                (a.float() - b.float()).abs().max())),
                mean_rel=max(w["mean_rel"], rel[0]),
                max_rel=max(w["max_rel"], rel[1]))
            if rel[2] is not None:
                excused.append(dict(rel[2], case=list(case), grad=f"d{name}"))
        n[dt] += 1
        del q, k, v, dout, got, again, want, ref
    torch.cuda.empty_cache()
    return dict(cases=n, worst=worst, excused_zeros=excused)


def bwd_times(dev) -> dict:
    """(a)'s times at FA_TRAIN (the model's strided views): each of the
    kernel's two launches (profiler) and their sum, the call (CUDA
    events), the plain version, SDPA's backward alone (its forward
    recorded once; no softcap) as the yardstick, and the bound
    (`fa_backward_bound`)."""
    B, H, K, S, D, dt, causal, cap = FA_TRAIN
    q, k, v = fa_inputs(B, H, K, S, D, dt, 19, dev, views=True)
    g = torch.Generator(device=dev)
    g.manual_seed(20)
    dout = torch.randn((B, H, S, D), generator=g, device=dev).to(q.dtype)
    call = lambda: fa.attention_backward(q, k, v, dout, causal, cap)
    plain = lambda: fa.attention_backward_plain(q, k, v, dout, causal, cap)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=causal, enable_gqa=True)
    library = lambda: torch.autograd.grad(out, leaves, dout,
                                          retain_graph=True)
    bytes_ms, ops_ms = fa_backward_bound(B, H, K, S, D, causal)
    bound_ms, bound_by = bound_of(bytes_ms, ops_ms)
    library_runs = sorted(cuda_ms(library, 20) for _ in range(BWD_LIBRARY_RUNS))
    split = fa.splits_heads(B, H, K, S, dev)
    t = dict(dq_ms=kernel_ms(call, 20, "flash_attention_bwd_dq_sm90_kernel"),
             dkdv_ms=kernel_ms(call, 20,
                               "flash_attention_bwd_dkdv_sm90_kernel"),
             # one dk/dv block a query head, and the launch that sums them
             splits_heads=split,
             reduce_ms=kernel_ms(call, 20, "flash_attention_bwd_reduce_kernel")
             if split else 0.0,
             call_ms=cuda_ms(call, 20), plain_ms=cuda_ms(plain, 5),
             library_ms=library_runs[len(library_runs) // 2],
             library_runs_ms=library_runs,
             library_device_ms=device_ms_per_call(library, 20),
             bound_ms=bound_ms,
             bound_by=bound_by, bytes_ms=bytes_ms, ops_ms=ops_ms,
             shape=dict(zip(("B", "H", "K", "S", "D", "dtype", "causal",
                             "softcap"), FA_TRAIN)),
             library="torch.autograd.grad of torch.nn.functional."
                     "scaled_dot_product_attention(is_causal=True, "
                     "enable_gqa=True), its backward alone, without the "
                     "softcap")
    t["ms"] = t["dq_ms"] + t["dkdv_ms"] + t["reduce_ms"]
    t["bound_share"] = bound_ms / t["ms"]
    # the products a pair the kernel does (BWD_PRODUCTS, all on the tensor
    # cores), against the bf16 tensor rate
    t["tensor_tflops"] = (BWD_PRODUCTS * 2 * B * H * D
                          * fa_pairs(S, causal, None, 0) / t["ms"] / 1e9)
    t["tensor_share"] = 1e12 * t["tensor_tflops"] / BF16_TENSOR_OPS_PER_S
    print(f"phase 25 (a) backward kernel at {FA_TRAIN}: {t['ms']:.4f} ms "
          f"(dq launch {t['dq_ms']:.4f}, dk/dv launch {t['dkdv_ms']:.4f}, "
          f"head sum {t['reduce_ms']:.4f}; "
          f"call {t['call_ms']:.4f}; {t['tensor_tflops']:.1f} TFLOP/s of its "
          f"{BWD_PRODUCTS} bf16 products a pair, {t['tensor_share']:.3f} of "
          f"the tensor rate), bound {bound_ms:.5f} ms ({bound_by}; "
          f"{t['bound_share']:.4f} of it), plain {t['plain_ms']:.4f} ms, "
          f"SDPA's backward without softcap (yardstick) "
          f"{t['library_ms']:.4f} ms (median of {BWD_LIBRARY_RUNS} runs of 20 "
          f"calls, {library_runs[0]:.4f} to {library_runs[-1]:.4f}; its device "
          f"time {t['library_device_ms']:.4f} ms)")
    del out, leaves
    return t


@contextlib.contextmanager
def forced_dkdv_schedule(split: bool):
    """attention_backward_cuda with its dk/dv schedule set: one block a
    query head (`split`) or one a kv head, whatever `splits_heads`
    would choose."""
    keep = fa.splits_heads
    fa.splits_heads = lambda *args: split
    try:
        yield
    finally:
        fa.splits_heads = keep


def bwd_route_times(dev) -> list:
    """(a): at each of BWD_ROUTE_SHAPES, the dk/dv launch's device time
    (profiler) under both schedules, the head-sum launch's added to the
    split one's, and the schedule `splits_heads` takes; the two
    schedules' dk and dv within FA_MEAN_REL / FA_MAX_REL of each other
    (they sum a group's heads in other orders)."""
    out = []
    for i, (B, H, K, S, D, dt, causal, cap) in enumerate(BWD_ROUTE_SHAPES):
        q, k, v = fa_inputs(B, H, K, S, D, dt, 30 + i, dev, views=True)
        g = torch.Generator(device=dev)
        g.manual_seed(40 + i)
        dout = torch.randn((B, H, S, D), generator=g, device=dev).to(q.dtype)
        call = lambda: fa.attention_backward(q, k, v, dout, causal, cap)
        row = dict(shape=[B, H, K, S, D], causal=causal, softcap=cap,
                   blocks_per_kv_head=B * K * -(-S // 64),
                   chosen="split" if fa.splits_heads(B, H, K, S, dev)
                   else "per_kv_head")
        got = {}
        for split in (False, True):
            name = "split" if split else "per_kv_head"
            with forced_dkdv_schedule(split):
                got[name] = call()
                ms = kernel_ms(call, 20, "flash_attention_bwd_dkdv_sm90_kernel")
                if split:
                    ms += kernel_ms(call, 20,
                                    "flash_attention_bwd_reduce_kernel")
            row[f"{name}_ms"] = ms
        for x, a, b in zip("kv", got["split"][1:], got["per_kv_head"][1:]):
            err, size = (a.float() - b.float()).abs(), b.float().abs()
            if not (float(err.mean()) <= FA_MEAN_REL * float(size.mean())
                    and float(err.max()) <= FA_MAX_REL * float(size.max())):
                raise AssertionError(f"phase 25 (a) d{x} {row['shape']}: the "
                                     f"split schedule against one block a kv "
                                     f"head: mean |err| {float(err.mean())}, "
                                     f"max |err| {float(err.max())}")
        print(f"phase 25 (a) dk/dv schedules at {tuple(row['shape'])}: one "
              f"block a kv head {row['per_kv_head_ms']:.4f} ms, one a query "
              f"head with the head sum {row['split_ms']:.4f} ms; "
              f"{row['blocks_per_kv_head']} blocks a kv head, splits_heads "
              f"takes {row['chosen']}")
        out.append(row)
        del q, k, v, dout, got
    return out


def bwd_peak_memory(dev) -> dict:
    """(b): the device memory one backward allocates above its inputs at
    BWD_LONG, kernel and plain version."""
    c = BWD_LONG
    B, H, K, S, D = c["shape"]
    q, k, v = fa_inputs(B, H, K, S, D, "bfloat16", 21, dev, views=True)
    dout = torch.ones((B, H, S, D), device=dev, dtype=q.dtype)
    out = {}
    for name, fn in (("kernel", fa.attention_backward),
                     ("plain", fa.attention_backward_plain)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        grads = fn(q, k, v, dout, causal=True, softcap=c["cap"],
                   window=c["window"])
        torch.cuda.synchronize()
        out[f"{name}_extra_bytes"] = torch.cuda.max_memory_allocated(dev) \
            - base
        del grads
    torch.cuda.empty_cache()
    print(f"phase 25 (b) one backward at {c['shape']}, causal, window "
          f"{c['window']}, softcap {c['cap']}: extra peak memory kernel "
          f"{out['kernel_extra_bytes'] / 2**20:.2f} MiB (limit "
          f"{c['kernel_limit'] / 2**20:.0f}), plain "
          f"{out['plain_extra_bytes'] / 2**30:.3f} GiB (at least "
          f"{c['plain_least'] / 2**30:.0f})")
    if out["kernel_extra_bytes"] >= c["kernel_limit"] or \
            out["plain_extra_bytes"] < c["plain_least"]:
        raise AssertionError(f"phase 25 (b): {out}")
    return out


class FirstGrads:
    """An optimizer that, at its first update, takes the gradients'
    digests (`leaf_digests`), then updates as the optimizer it wraps."""

    def __init__(self, opt):
        self.opt, self.digests = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, lr_scale=1.0):
        if self.digests is None:
            self.digests = leaf_digests(grads)
        return self.opt.update(grads, state, params, lr_scale=lr_scale)


#: odd 64-bit weights of a digest: element i weighs (i * A) | 1
DIGEST_A = -7046029254386353131    # 0x9E3779B97F4A7C15 as a signed int64
DIGEST_CHUNK = 1 << 26


def leaf_digests(tree) -> list:
    """(path, digest) of each leaf, on the card: its 32- or 16-bit words,
    sign-extended, times odd weights, summed mod 2^64. Two leaves that
    differ in one element always differ here (an odd weight times a
    nonzero difference below 2^33 is not 0 mod 2^64); several differences
    cancel with a chance near 2^-64. No copy leaves the card."""
    from repro_torch.ckpt.checkpoint import tree_leaves_with_paths
    out = []
    for path, x in tree_leaves_with_paths(tree):
        flat = x.detach().reshape(-1)
        words = flat.view(torch.int32 if flat.element_size() == 4
                          else torch.int16)
        total = 0
        for lo in range(0, words.numel(), DIGEST_CHUNK):
            w = words[lo: lo + DIGEST_CHUNK].to(torch.int64)
            i = torch.arange(lo, lo + w.numel(), dtype=torch.int64,
                             device=w.device)
            total += int((w * ((i * DIGEST_A) | 1)).sum())
        out.append((str(path), total % 2**64))
    return out


def digests_against(got, want) -> dict:
    """{"equal", "leaves", "first"}: the leaves whose digests equal
    `want`'s, and the first that does not."""
    equal = sum(g == w for g, w in zip(got, want, strict=True))
    first = next((g[0] for g, w in zip(got, want) if g != w), None)
    return dict(equal=equal, leaves=len(want), first=first)


def remat_train_run(cfg, dev) -> dict:
    """SHARDED's steps of `cfg` from seed 0 through make_train_step, the
    counts set to 0 just before the first: losses, gradient norms, step s
    (the last one warm), peak memory, launches, and the digests of the
    first step's gradients and of the updated parameters
    (`leaf_digests`)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = model_lib.build(cfg)
    opt = FirstGrads(make_optimizer(cfg))
    params = model.init(seed=0, device=dev)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=dev))
    del params
    batch = make_batch(cfg, SHARDED["batch"], SHARDED["seq"], "train",
                       seed=0, device=dev)
    mask = torch.ones((SHARDED["n_micro"],), device=dev)
    step = make_train_step(model, opt, SHARDED["n_micro"])
    losses, norms, times = [], [], []
    reset_counts()
    for _ in range(SHARDED["steps"]):
        (state, m), dt = synced(lambda: step(state, batch, mask))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        times.append(dt)
    out = dict(remat=cfg.remat, losses=losses, grad_norms=norms,
               step_s=times, warm_step_s=times[-1], counts=fa_counts(),
               peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
               grad_digests=opt.digests,
               param_digests=leaf_digests(state.params))
    del state, batch, step, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def remat_against_full(arch, layers, dev) -> dict:
    """(c) for one arch: "full", then "dots" held against it: losses,
    gradient norms, the first step's gradients and the updated parameters
    bit-equal (their digests, `leaf_digests`); launches (forward, recompute and backward of every layer,
    microbatch and step); warm step s and peak memory of both."""
    base = get_config(arch)
    if layers is not None:
        base = dataclasses.replace(base, n_layers=layers)
    full = remat_train_run(dataclasses.replace(base, remat="full"), dev)
    dots = remat_train_run(dataclasses.replace(base, remat="dots"), dev)
    dots["grads_against"] = digests_against(dots.pop("grad_digests"),
                                            full.pop("grad_digests"))
    dots["params_against"] = digests_against(dots.pop("param_digests"),
                                             full.pop("param_digests"))
    want_fa = 2 * base.n_layers * SHARDED["n_micro"] * SHARDED["steps"]
    for run in (full, dots):
        c = run["counts"]
        if (c["flash_attention_sm90"], c["flash_attention_simt"],
                c["flash_attention_backward"]) != (want_fa, 0, want_fa // 2):
            raise AssertionError(f"phase 25 (c) {arch} {run['remat']}: "
                                 f"launches {c}, expected {want_fa} sm90 and "
                                 f"{want_fa // 2} backward")
    same = (dots["losses"] == full["losses"]
            and dots["grad_norms"] == full["grad_norms"]
            and dots["grads_against"]["first"] is None
            and dots["params_against"]["first"] is None)
    out = dict(arch=arch, layers=base.n_layers, full=full, dots=dots,
               bit_equal=same, flash_attention_predicted=want_fa)
    print(f"phase 25 (c) {arch} ({base.n_layers} layers, full width; "
          f"{SHARDED['steps']} steps of {SHARDED['n_micro']} x 1 x "
          f"{SHARDED['seq']}): warm step s full {full['warm_step_s']:.3f}, "
          f"dots {dots['warm_step_s']:.3f}; peak GiB full "
          f"{full['peak_memory_bytes'] / 2**30:.2f}, dots "
          f"{dots['peak_memory_bytes'] / 2**30:.2f}; launches {dots['counts']}"
          f" (predicted {want_fa} forward and recompute, {want_fa // 2} "
          f"backward); losses {dots['losses']} (full {full['losses']}); "
          f"gradients {dots['grads_against']['equal']} of "
          f"{dots['grads_against']['leaves']} leaves and parameters "
          f"{dots['params_against']['equal']} of "
          f"{dots['params_against']['leaves']} bit-equal; bit-equal {same}")
    if not same:
        raise AssertionError(f"phase 25 (c) {arch}: remat=\"dots\" is not "
                             f"bit-equal to \"full\": {dots['losses']} "
                             f"against {full['losses']}, norms "
                             f"{dots['grad_norms']} against "
                             f"{full['grad_norms']}, gradients "
                             f"{dots['grads_against']}, parameters "
                             f"{dots['params_against']}")
    return out


def remat_dryrun(futures, planner, sharded) -> dict:
    """(d): the remat_dots and blockattn cells against the default ones:
    on h100 remat_dots's FLOPs are the default's less the blocks' weight
    products' forward FLOPs (2 a parameter and token, every layer), on
    16x16 fewer; blockattn's records equal the default's."""
    recs = {}
    for f in futures:
        for r in f.result():
            recs[(r["arch"], r["mesh"], tuple(r["opts"]))] = dryrun_row(r)
    recs[("gemma2-2b", "h100", ())] = planner["dryrun"]["cells"][
        "gemma2-2b/train_4k/h100"]
    recs[("gemma2-2b", "16x16", ())] = planner["dryrun"]["cells"][
        "gemma2-2b/train_4k/16x16"]
    recs[("olmoe-1b-7b", "16x16", ())] = sharded["dryrun"]["olmoe-1b-7b"]
    from repro_torch.configs import SHAPES
    seq, batch, _ = SHAPES["train_4k"]
    same_keys = ("flops_per_device", "hbm_bytes_per_device",
                 "collective_wire_bytes", "flash_attention_entries",
                 "flash_attention_backward_entries", "n_ops")
    out = {}
    for arch in ("gemma2-2b", "olmoe-1b-7b"):
        cfg = get_config(arch)
        per_token = cfg.d_model * cfg.head_dim * (2 * cfg.n_heads
                                                  + 2 * cfg.n_kv_heads)
        per_token += (cfg.d_model * cfg.moe.n_experts if cfg.moe else
                      3 * cfg.d_model * cfg.d_ff)
        saved = 2.0 * per_token * seq * batch * cfg.n_layers
        for mesh in DRYRUN_MESHES:
            base, dots = recs[(arch, mesh, ())], recs[(arch, mesh,
                                                       ("remat_dots",))]
            blocked = recs[(arch, mesh, ("blockattn",))]
            less = base["flops_per_device"] - dots["flops_per_device"]
            row = dict(default=base, remat_dots=dots, blockattn=blocked,
                       flops_less=less, saved_forward_flops=saved)
            print(f"phase 25 (d) {arch}/train_4k/{mesh}: flops/dev default "
                  f"{base['flops_per_device']:.6e}, remat_dots "
                  f"{dots['flops_per_device']:.6e} ({less:.6e} fewer; the "
                  f"blocks' weight products {saved:.6e} on one card), bytes/"
                  f"dev {base['hbm_bytes_per_device']:.4e} and "
                  f"{dots['hbm_bytes_per_device']:.4e}, roofline fraction "
                  f"{base['roofline_fraction']:.4f} and "
                  f"{dots['roofline_fraction']:.4f}; blockattn equal to the "
                  f"default: "
                  + str(all(blocked[k] == base[k] for k in same_keys)))
            if mesh == "h100" and not math.isclose(less, saved,
                                                   rel_tol=1e-12):
                raise AssertionError(f"phase 25 (d) {arch}/{mesh}: remat_dots "
                                     f"saves {less} FLOPs, not {saved}")
            if not 0 < less <= saved:
                raise AssertionError(f"phase 25 (d) {arch}/{mesh}: "
                                     f"remat_dots saves {less} FLOPs")
            if any(blocked[k] != base[k] for k in same_keys):
                raise AssertionError(f"phase 25 (d) {arch}/{mesh}: blockattn "
                                     f"{blocked} against {base}")
            out[f"{arch}/train_4k/{mesh}"] = row
    return out


def phase_backward(dev, planner, sharded, dry) -> dict:
    """Phase 25: (a) the attention gradient's kernel against its plain
    version, timed; (b) its extra memory at 1 x 8192; (c) remat="dots"
    bit-equal to "full", and sharded on card_mesh to unsharded; (d) the
    dry run's remat_dots and blockattn cells."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import card_mesh
    t0 = time.perf_counter()
    out, secs = {}, {}

    def timed(name, fn):
        t = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t

    timed("check", lambda: bwd_check(dev))
    w = out["check"]["worst"]
    print(f"phase 25 (a): {out['check']['cases']} cases (f32, bf16) of the "
          f"backward kernel against attention_backward_plain, each called "
          f"twice with the same bits, unaligned inputs the aligned ones' "
          f"bits, {sum(e['n'] for e in out['check']['excused_zeros'])} "
          f"zeros within rounding of 0 excused; worst f32 max |err| "
          f"{w['float32']['max_abs_err']:.3g} (max rel "
          f"{w['float32']['max_rel']:.3g}, limit {FA_GRAD_F32}), bf16 max "
          f"|err| {w['bfloat16']['max_abs_err']:.3g} (mean rel "
          f"{w['bfloat16']['mean_rel']:.3g}, max rel "
          f"{w['bfloat16']['max_rel']:.3g})")
    timed("times", lambda: bwd_times(dev))
    timed("routes", lambda: bwd_route_times(dev))
    timed("memory", lambda: bwd_peak_memory(dev))
    timed("remat", lambda: {a: remat_against_full(a, n, dev)
                            for a, n in REMAT["archs"]})

    def sharded_dots():
        arch, layers = REMAT["sharded"]
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  remat="dots")
        mesh = card_mesh()
        try:
            if dist.get_backend() != "nccl":
                raise AssertionError(f"card_mesh: backend "
                                     f"{dist.get_backend()}, not nccl")
            return sharded_against_plain(arch, dev, mesh, cfg=cfg,
                                         what="phase 25 (c) remat=\"dots\"")
        finally:
            dist.destroy_process_group()

    timed("sharded_dots", sharded_dots)
    timed("dryrun", lambda: remat_dryrun(dry[1], planner, sharded))
    out["seconds_by_part"] = secs
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 25: {out['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()) + ")")
    return out



def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible")
    held = []
    try:
        run_phases(held)
    finally:
        for refs in held:
            stop_cpu_refs(refs)


def run_phases(held: list) -> None:
    """Every phase in order; the CPU-reference worker it starts is put in
    `held`, for `main` to stop whatever happens."""
    dev = torch.device("cuda")
    t_phases = time.perf_counter()
    card_line = card()
    print(card_line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.compile_sources(SOURCES)
    build_s = time.perf_counter() - t0
    # the CPU's sides of phases 16 (b), 19 (b) and 24 (e), in a worker
    refs = start_cpu_refs()
    held.append(refs)
    print(f"build: {', '.join(SOURCES)} in {build_s:.2f} s, in parallel ("
          + ", ".join(f"{n} {build.seconds[n]:.1f} s" for n in SOURCES
                      if n in build.seconds) + ")")
    for name in SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}:", line.strip())
    sm90 = ptxas_report("flash_attention_sm90", "Li256E")
    print(f"  flash_attention_sm90 at D 256: {sm90}, dynamic shared memory "
          f"{fa.SM90_SMEM_BYTES[256]} bytes")
    bwd_regs = {k: ptxas_report("flash_attention_bwd_bf16",
                                f"bwd_{k}_sm90_kernelILi256E")
                for k in ("dq", "dkdv")}
    print(f"  flash_attention_bwd_bf16 at D 256 (dynamic shared memory "
          f"{fa.BWD_SM90_SMEM_BYTES[256]} bytes): {bwd_regs}")
    for k, r in bwd_regs.items():
        if r["stack"] or r["spill_stores"] or r["spill_loads"]:
            raise AssertionError(f"flash_attention_bwd_bf16 {k} launch at D "
                                 f"256: {r} (a stack frame or spills)")
    dsk = {d: ptxas_report("dispatch_scan", f"dispatch_scan_kernelILi{i}E")
           for i, d in enumerate(ds.DESIGNS)}
    print("  dispatch_scan by design: " + "; ".join(
        f"{d} {r}" for d, r in dsk.items()))
    for d, r in dsk.items():
        if r["stack"] or r["spill_stores"] or r["spill_loads"]:
            raise AssertionError(f"dispatch_scan design {d}: {r} (a stack "
                                 f"frame or spills)")
    # the sorted design's warps meet at one named barrier a step
    sass = sass_step("dispatch_scan", "dispatch_scan_kernelILi0E",
                     "BAR.SYNC")
    print(f"  dispatch_scan sorted design, SASS: "
          f"{sass['instructions_per_step']:.1f} instructions a step (a loop "
          f"of {sass['loop_instructions']} over {sass['steps_per_loop']} "
          f"steps; loops holding a step {sass['loops']}); a step's mix "
          + ", ".join(f"{k} {v:g}" for k, v in sass["mix_per_step"].items()))
    p = SimParams()

    check = phase_check(dev, p)
    philox_check = phase_philox_check(dev)

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
    fleet, fleet_state = phase_fleet(dev, p)
    serving, serving_state = phase_serving(dev, p)
    chaos = phase_chaos(dev, p, fleet_state)
    if not all(chaos["launches"].values()):
        raise AssertionError(f"chaos path: a kernel was never launched: "
                             f"{chaos['launches']}")
    chaos["facade"] = phase_facade(dev, p, dict(
        flat=(jobs, outs), fleet=fleet_state, capacity=cluster_state,
        serving=serving_state, chaos=chaos.pop("faulted")))
    del fleet_state, serving_state
    philox_t = philox_times(dev, {
        "serve_window": (SERVING["window"], 9),
        "fleet_chunk": (fleet["flat"]["chunk_tasks"], 9),
        "fleet_monolithic": (fleet["flat"]["tasks"], 9)})
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
    t16 = time.perf_counter()
    train = dict(attention=phase_train_attention(dev))
    with host_heap_reuse():
        train["check"] = phase_train_check(dev, refs)
    train.update(full_width=phase_train(dev),
                 restart=phase_train_restart(dev))
    train["seconds"] = time.perf_counter() - t16
    print(f"phase 16: {train['seconds']:.1f} s")
    families = phase_masks_families(dev)
    # the dry run's traces (phases 20 (a), 22 (c)) need no card: their
    # processes run beside phases 18 and 19 on the host's other cores
    dry = start_dryrun()
    sharded_dry = start_dryrun(sharded_dryrun_groups())
    pools = [dry[0], sharded_dry[0]]
    try:
        ssm = phase_ssm(dev)
        train_families = phase_train_families(dev, refs)
        planner = phase_planner(dev, dry)
        # phase 25 (d)'s traces run beside phases 21 to 24, once phase 20's
        # processes are done
        remat_dry = start_dryrun(REMAT_DRYRUN_GROUPS)
        pools.append(remat_dry[0])
        mesh = phase_mesh(dev, p)
        sharded = phase_sharded_train(
            dev, planner, train["full_width"]["peak_memory_bytes"],
            sharded_dry)
        for pool in pools[:2]:
            pool.shutdown(wait=True, cancel_futures=True)
        sharded_serve = phase_sharded_serve(dev)
        configs = phase_configs(dev, refs)
        backward = phase_backward(dev, planner, sharded, remat_dry)
    finally:
        for pool in pools:
            pool.shutdown(wait=True, cancel_futures=True)

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
        # the check shapes, the scenarios' inputs, the fleet's first
        # solves (100,000 jobs and an 8,192-job chunk) and the training
        # governor's warm decisions (J = 1)
        "max_abs_err": max(check["max_abs_err"], scen_kernel["max_abs_err"],
                           *(v["max_abs_err"] for v in fleet["flat"][
                               "grid_solve_vs_plain"].values()),
                           train["full_width"]["governor_grid_max_abs_err"]),
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
        # the fleet (phase 10c), each run counted: the 100,000-job
        # paper-hadoop run_all monolithic (one launch a strategy) and in
        # chunks (one a chunk), and the windowed run_cluster (one a window)
        "launches_fleet": dict(
            flat_monolithic=fleet["flat"]["grid_solve_launches"][
                "monolithic"],
            flat_chunked=fleet["flat"]["grid_solve_launches"]["chunked"],
            capacity_windows=fleet["capacity"]["launches"][0]),
        # hedged serving (phase 10d), each run counted: run_serve over
        # request-storm's 20,000 requests, known tail (one solve a
        # strategy) and online (epoch solves and the governor's re-solves)
        "launches_serving": {
            regime: serving[regime]["grid_solve_launches"]
            for regime in ("known_tail", "online")},
        # phase 10e (a): the chunked run_all under a plan of faults that
        # change nothing, counted from 0 (the solve is outside the retry)
        "launches_chaos": chaos["launches"]["grid_solve"],
        # phase 16 (c): the full-width Trainer's 4 steps, one launch per
        # Chronos strategy per warm governor decision (the pipeline's
        # producer thread runs ahead of the steps)
        "launches_train": train["full_width"]["counts"]["grid_solve"],
        "train_warm_decisions": train["full_width"]["counts"][
            "warm_decisions"],
        "max_abs_err_train": train["full_width"]["governor_grid_max_abs_err"],
        # phase 19 (c): each Trainer family's 3 steps, counted from 0; (d)
        # the serving launcher's hedged run
        "launches_train_families": {
            k: train_families[k]["counts"]["grid_solve"]
            for k in (s["arch"] for s in TRAIN_FAMILIES)},
        "max_abs_err_train_families": max(
            train_families[s["arch"]]["governor_grid_max_abs_err"] or 0.0
            for s in TRAIN_FAMILIES),
        "launches_serve_launcher": train_families["serve_launcher"][
            "counts"]["grid_solve"],
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
             max_abs_err=max(*fa_err.values(),
                             *families["masks"]["max_abs_err"].values(),
                             *ssm["masks"]["max_abs_err"].values()),
             max_abs_err_by_type=fa_err,
             bf16_relative_err=fa_rel,
             # phase 17: the masks (window, prefix, bidirectional) and head
             # dim 80 on both routes, against the plain version
             routes={
                 "sm90": dict(
                     source="src/repro_torch/kernels/csrc/"
                            "flash_attention_sm90.cu",
                     mask_cases=families["masks"]["cases"]["sm90"],
                     max_abs_err_masks=families["masks"]["max_abs_err"][
                         "bfloat16"],
                     bf16_relative_err_masks=families["masks"][
                         "bf16_relative_err"]),
                 "simt": dict(
                     source="src/repro_torch/kernels/csrc/flash_attention.cu",
                     mask_cases=families["masks"]["cases"]["simt"],
                     max_abs_err_masks=families["masks"]["max_abs_err"][
                         "float32"],
                     launches_family_checks={
                         k: v["simt_launches"]
                         for k, v in families["check"].items()})},
             # per launch on the new paths' shapes, bound over the allowed
             # pairs, SDPA with a boolean mask and no softcap
             mask_times=families["times"],
             # each full-width path of phase 17, counted from 0
             launches_phase17={
                 k: families[k]["counts"]["flash_attention"]
                 for k in ("window_serve", "olmoe-1b-7b", "paligemma-3b",
                           "hubert-xlarge")},
             # phase 18: head dim 112 on both routes (every mask), zamba2-7b's
             # launch timed, and the full-width paths' launches from 0
             d112=dict(
                 cases=ssm["masks"]["cases"],
                 max_abs_err=ssm["masks"]["max_abs_err"],
                 bf16_relative_err=ssm["masks"]["bf16_relative_err"],
                 registers=ssm["registers"], smem_bytes=ssm["smem_bytes"],
                 times=ssm["times"],
                 launches_simt_check={k: v["simt_launches"]
                                      for k, v in ssm["check"].items()}),
             launches_phase18={
                 spec["arch"]: ssm[spec["arch"]]["counts"]["flash_attention"]
                 for spec in SSM_SERVE},
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
             serve=serve, serve_check=serve_check,
             # phase 16 (c): the full-width Trainer's 4 steps, forward and
             # remat recompute of every layer and microbatch, all sm90
             launches_train=train["full_width"]["counts"]["flash_attention"],
             route_counts_train={
                 "sm90": train["full_width"]["counts"][
                     "flash_attention_sm90"],
                 "simt": train["full_width"]["counts"][
                     "flash_attention_simt"]},
             # phase 16 (a): the gradient (attention_backward, the
             # backward kernel since PR 32) at one training microbatch's
             # shape
             train_backward={k: train["attention"][k] for k in (
                 "backward_ms", "forward_backward_ms",
                 "plain_forward_backward_ms", "library_forward_backward_ms",
                 "bound_ms", "bound_by", "shape")},
             # phase 19: the gradient at D 80 and 112 on every mask, and
             # each family's 4 full-width training steps counted from 0
             # (all sm90), beside their prediction; the serving launcher's
             train_backward_d80_d112=train_families["attention_grad"],
             launches_phase19={
                 s["arch"]: dict(
                     counts=train_families[s["arch"]]["counts"],
                     predicted=train_families[s["arch"]][
                         "flash_attention_predicted"])
                 for s in TRAIN_FAMILIES},
             launches_serve_launcher=train_families["serve_launcher"][
                 "counts"]["flash_attention"],
             # phase 20 (b): one traced full-width train step of 1 x 4096
             # (forward and remat recompute), equal to the analyzer's
             # flash-attention entries
             launches_phase20=planner["trace"]["train"]["launches"],
             # phase 22 (a): the sharded steps on card_mesh, counted from 0
             # (each launch on the local shards of the DTensor rule)
             launches_phase22={
                 a: dict(counts=sharded[a]["sharded"]["counts"],
                         predicted=sharded[a]["flash_attention_predicted"])
                 for a in SHARDED["archs"]},
             # phase 23: the sharded prefill and 16 decode steps on
             # card_mesh, counted from 0 (all in the prefill)
             launches_phase23={
                 a: dict(counts=sharded_serve[a]["counts"],
                         predicted=sharded_serve[a][
                             "flash_attention_predicted"])
                 for a in SHARDED_SERVE["archs"]},
             # phase 24: the new configs' launch shapes (groups 16, 4 and
             # 7 at D 128, causal) held and timed, and their paths'
             # launches counted from 0: one a layer in a generate (all in
             # the prefill), 2 a layer, microbatch and step in training
             config_times=configs["fa"],
             launches_phase24=dict(
                 serve={a: v["counts"] for a, v in configs["serve"].items()},
                 train={a: dict(counts=v["counts"],
                                predicted=v["flash_attention_predicted"])
                        for a, v in configs["train"].items()},
                 check={a: v["simt_launches"]
                        for a, v in configs["check"].items()})),
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
        # over every case and both strategies' prefixes (bit-equal: 0),
        # and the fleet's held segments (phase 10c, K 500; phase 10e d,
        # K 400 after a slot change)
        max_abs_err=max(cluster["max_abs_err"],
                        fleet["capacity"]["dispatch_vs_plain"]["max_abs_err"],
                        chaos["capacity"]["dispatch_vs_plain"]["max_abs_err"]),
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
        stack={k: v["stack"] for k, v in dsk.items()},
        # the sorted pool in registers up to the cutover, lane-private
        # groups above; ns a step on clone's pass 2 by K and design
        cutover_slots=ds.SORTED_MAX_SLOTS, designs=cluster["designs"],
        ns_per_step_by_K=ct["ns_per_step_by_K"], sass_step=sass,
        sorted_warps=SORTED_WARPS,
        sorted_ns_per_step_by_warps=ct["sorted_ns_per_step_by_warps"],
        # one warp issues at most one instruction a cycle: the step's
        # instructions over the SM clock measured while the kernel ran
        issue_floor_ns_per_step=1e3 * sass["instructions_per_step"]
        / ct["clock"]["sm_mhz"],
        clock=ct["clock"],
        # run_cluster at reps 8: 20 launches of 8 segments each
        reps8=dict(launches=cluster["reps8"]["launches"][1],
                   ms=ct["reps8"]["kernel_ms_per_run"],
                   over_reps1=ct["reps8"]["over_reps1"],
                   wall_s=cluster["reps8"]["wall_s"]),
        profile_run_cluster=ct["profile"],
        # the fleet's windowed run_cluster (phase 10c): every (window,
        # replication) a segment, one launch a pass for all of them
        launches_fleet=fleet["capacity"]["launches"][1],
        fleet=dict(
            segments_per_launch=fleet["capacity"]["segments_per_launch"],
            ms=fleet["capacity"]["kernel_ms"],
            ms_one_launch_a_window=fleet["capacity"][
                "kernel_ms_per_window_launches"],
            ns_per_step=fleet["capacity"]["ns_per_step"],
            launches_one_a_window=fleet["capacity"][
                "launches_per_window"][1]),
        # phase 10e (d): the windowed run_cluster with a slot change, one
        # launch a pass for each window's replications
        launches_chaos=chaos["launches"]["dispatch_scan"],
        chaos=dict(launch_pools=chaos["capacity"]["launch_pools"],
                   held=chaos["capacity"]["dispatch_vs_plain"])))
    pt = philox_t["serve_window"]
    kernels.append(dict(
        name="philox_rows", route="cuda",
        source="src/repro_torch/kernels/csrc/philox_rows.cu",
        replaces="src/repro/serve/scheduler.py:162 (jax.random.fold_in per "
                 "request, lowered by XLA; no Pallas kernel)",
        # the main path: one known-tail run_serve over request-storm; ms,
        # call, plain and bound per launch at its window shape (256, 9)
        launches=serving["known_tail"]["first_launches"]["philox_rows"],
        max_abs_err=philox_check["max_abs_err"],
        ms=pt["ms"], call_ms=pt["call_ms"], plain_ms=pt["plain_ms"],
        bound_ms=pt["bound_ms"], bound_by="bytes", library_ms=None,
        library="none: torch.rand draws from a generator's offset, not at "
                "given coordinates (rand_ms is a yardstick of the same "
                "shape)",
        rand_ms=pt["rand_ms"], per_shape=philox_t,
        launches_online=serving["online"]["philox_launches"],
        launches_fleet={k: v["launches"]
                        for k, v in fleet["flat"]["draws"].items()},
        # phase 10e (a): the faulted chunked run_all, chunk 4 drawn twice
        launches_chaos=chaos["launches"]["philox_rows"],
        # phase 19 (d): the serving launcher's hedged run
        launches_serve_launcher=train_families["serve_launcher"]["counts"][
            "philox_rows"],
        check=philox_check))
    bt, bc = backward["times"], backward["check"]
    kernels.append(dict(
        name="flash_attention_backward", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd_bf16.cu",
        # the f32 route: flash_attention_bwd.h, built as _f32.cu
        f32_route=dict(
            source="src/repro_torch/kernels/csrc/flash_attention_bwd_f32.cu",
            header="src/repro_torch/kernels/csrc/flash_attention_bwd.h"),
        replaces="src/repro/models/attention.py:92 (_attend_blocked, and "
                 "_attend's einsums, differentiated by XLA; the Pallas "
                 "kernel at src/repro/kernels/flash_attention.py:90 has no "
                 "backward)",
        # the main path: phase 16 (c)'s Trainer, 4 steps, one launch a
        # layer, microbatch and step (one call: its two kernels)
        launches=train["full_width"]["counts"]["flash_attention_backward"],
        max_abs_err=max(w["max_abs_err"] for w in bc["worst"].values()),
        worst_by_type=bc["worst"], cases=bc["cases"],
        # per call at FA_TRAIN (1, 8, 4, 2048, 256), bf16, causal,
        # softcap 50, the model's strided views: ms is both launches'
        # device time (profiler), call_ms the wrapper's (CUDA events);
        # build_s the source's nvcc seconds (in parallel with the others)
        build_s=build.seconds.get("flash_attention_bwd_bf16"),
        ms=bt["ms"], dq_ms=bt["dq_ms"], dkdv_ms=bt["dkdv_ms"],
        reduce_ms=bt["reduce_ms"], splits_heads=bt["splits_heads"],
        call_ms=bt["call_ms"], plain_ms=bt["plain_ms"],
        bound_ms=bt["bound_ms"], bound_by=bt["bound_by"],
        bound_share=bt["bound_share"], bytes_ms=bt["bytes_ms"],
        ops_ms=bt["ops_ms"], tensor_tflops=bt["tensor_tflops"],
        tensor_share=bt["tensor_share"],
        library_ms=bt["library_ms"], library_runs_ms=bt["library_runs_ms"],
        library_device_ms=bt["library_device_ms"],
        library=bt["library"],
        shape=bt["shape"], registers=bwd_regs, memory=backward["memory"],
        # phase 22 (a)'s sharded steps and phase 25 (c)'s remat runs,
        # counted from 0
        launches_phase22={a: sharded[a]["sharded"]["counts"][
            "flash_attention_backward"] for a in SHARDED["archs"]},
        launches_phase25={a: v["dots"]["counts"]["flash_attention_backward"]
                          for a, v in backward["remat"].items()}))
    # phase 21: each mesh run's launches by point, counted from 0
    for k in kernels:
        if k["name"] in ("grid_solve", "philox_rows", "dispatch_scan"):
            k["launches_mesh"] = mesh_launches(mesh, k["name"])
    for refs in held:
        stop_cpu_refs(refs)
    now = time.perf_counter()
    print(f"chip_smoke: every phase passed in {now - T_START:.1f} s since "
          f"the script started, its imports included ({now - t_phases:.1f} "
          f"s after them, {t_phases - T_START:.1f} s of imports)")
    backward_line = json.dumps({"backward": backward})
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "backward.json").write_text(backward_line)
    print(backward_line)
    configs_line = json.dumps({"configs": configs})
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "configs.json").write_text(configs_line)
    print(configs_line)
    sharded_serve_line = json.dumps({"sharded_serve": sharded_serve})
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "sharded_serve.json").write_text(
        sharded_serve_line)
    print(sharded_serve_line)
    sharded_line = json.dumps({"sharded_train": sharded})
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "sharded_train.json").write_text(sharded_line)
    print(sharded_line)
    mesh_line = json.dumps({"mesh": mesh})
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "mesh.json").write_text(mesh_line)
    print(mesh_line)
    planner_line = json.dumps({"planner": planner})
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "planner.json").write_text(planner_line)
    print(planner_line)
    train_families_line = json.dumps({"train_families": train_families})
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "train_families.json").write_text(
        train_families_line)
    print(train_families_line)
    ssm_line = json.dumps({"ssm": ssm})
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "ssm.json").write_text(ssm_line)
    print(ssm_line)
    families_line = json.dumps({"families": families})
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "families.json").write_text(families_line)
    print(families_line)
    train_line = json.dumps({"train": train})
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "train.json").write_text(train_line)
    print(train_line)
    chaos_line = json.dumps({"chaos": chaos})
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "chaos.json").write_text(chaos_line)
    print(chaos_line)
    serving_line = json.dumps({"serving": serving})
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "serving.json").write_text(serving_line)
    print(serving_line)
    fleet_line = json.dumps({"fleet": fleet})
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "fleet.json").write_text(fleet_line)
    print(fleet_line)
    cluster_line = json.dumps({"cluster": cluster})
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "cluster.json").write_text(cluster_line)
    print(cluster_line)
    print(json.dumps({"scenarios": {
        "workloads": workloads, "runs": scen_runs, "budget": budget,
        "spans": spans}}))
    kernels_line = json.dumps({"kernels": kernels})
    (ROOT / "chiprun_out" / "kernels.json").write_text(kernels_line)
    print(kernels_line)
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
