#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases; each raises on failure, so any failure exits non-zero:

1. print the card (nvidia-smi name and power limit) and build every kernel
   of the main path from `src/repro_torch/kernels/csrc/`, timed;
2. hold each kernel against its plain PyTorch version on the card, for
   every optimized strategy at (J, r_max) = (37, 9), (64, 33), (2700, 9)
   and (65536, 64): r*, choice and sat equal; U rtol 1e-4 / atol 1e-5,
   PoCD rtol 1e-5 / atol 1e-7, cost rtol 1e-4 / atol 1e-5 (the reference's
   own kernel tolerances, tests/test_grid_solve.py). The kernel's device
   time per launch (torch.profiler), the wrapper's and the plain
   version's call times (CUDA events), and the least time the card could
   take;
3. the main path: `run_all` over the paper's trace, generate(2700, seed=0)
   (912,199 tasks), all registered strategies, max_r=8, at reps=1 and
   reps=8, twice each; the grid-solve launch count is set to 0 before
   each run and must read 6 (one per optimized strategy) after it. Cold
   and warm wall times per strategy come from `run_strategy` calls made
   just before, in run_all's order;
4. replay the uniforms of one reps=1 run on the card through the plain
   CPU path: r* equal, job_met equal except jobs whose completion lies
   within f32 rtol 1e-5 of the deadline, pocd within rtol 1e-5 (plus 1/J
   per such job) and mean_cost within rtol 1e-4;
5. one torch.profiler pass over run_all reps=1: device busy time, idle
   share and the top device ops.

The last lines are the kernels JSON, the card line and the result JSON.
The script needs one CUDA card and exits non-zero without one.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import Philox, SimParams, generate, names, run_all  # noqa: E402
from repro_torch import run_strategy  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import grid_solve as gs  # noqa: E402
from repro_torch.sim.runner import jobspecs_of  # noqa: E402
from repro_torch.sim.trace import jobset_to  # noqa: E402
from repro_torch.strategies import get  # noqa: E402

# H100 SXM data sheet, at the full 700 W: HBM rate and the f32 rate outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# f32 operations per (job, r) of one closed-form family, counted from
# kernels/csrc/grid_solve.cu: each add, mul, div, compare or select and
# each transcendental call (powf, logf, ...) counts one, so this is a lower
# bound on the work. S-Restart's count is 44 + 1539 for the quadrature
# (12 per node at 128 nodes, plus 3).
OPS_PER_POINT = {"clone": 30, "srestart": 1611, "sresume": 72}

TOL = {"u": (1e-4, 1e-5), "pocd": (1e-5, 1e-7), "cost": (1e-4, 1e-5)}
CHECK_SHAPES = ((37, 9), (64, 33), (2700, 9), (65536, 64))
THETA = 1e-4
CHECK_R_MIN = 0.03   # about the main path's R_min, so -inf rows occur


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def kernel_ms(fn, iters: int, name: str) -> float:
    """Mean device time per launch of the kernels whose name holds `name`,
    from torch.profiler over `iters` calls of fn()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key]
    count = sum(e.count for e in rows)
    if count != iters:
        raise AssertionError(f"profiler saw {count} {name} launches, "
                             f"expected {iters}")
    return sum(e.device_time_total for e in rows) / count / 1e3


def grid_solve_bound(spec, J: int, r_max: int):
    """(bytes ms, operations ms) for one grid solve: the least time the card
    could take is the larger of the two."""
    forms = [get(n).form for n in (spec.components or (spec.name,))]
    per_r = sum(OPS_PER_POINT[f] for f in forms)
    # the grid, then every form again at r*; one max per extra form and
    # one argmax compare per grid point
    ops = J * ((r_max + 1) * per_r + r_max * len(forms))
    nbytes = J * (10 + 6) * 4 + 2 * 128 * 4
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S


def bound_of(bytes_ms: float, ops_ms: float):
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def phase_check(dev, p: SimParams) -> dict:
    """Kernel against plain on the card at every check shape."""
    out = {"max_abs_err": 0.0, "main": {}}
    for J, r_max in CHECK_SHAPES:
        job = jobspecs_of(generate(J, seed=0, device=dev), p, THETA,
                          CHECK_R_MIN)
        for name in names("optimized"):
            spec = get(name)
            k = gs.grid_solve(spec, job, r_max)
            ref = gs.grid_solve_plain(spec, job, r_max)
            torch.cuda.synchronize()
            for i, what in ((0, "r*"), (1, "choice"), (5, "sat")):
                if not torch.equal(k[i], ref[i]):
                    bad = int((k[i] != ref[i]).sum())
                    raise AssertionError(
                        f"grid_solve[{name}] J={J} r_max={r_max}: {what} "
                        f"differs from the plain version in {bad} jobs")
            errs = []
            for i, what in ((2, "u"), (3, "pocd"), (4, "cost")):
                rtol, atol = TOL[what]
                close = torch.isclose(k[i], ref[i], rtol=rtol, atol=atol)
                if not bool(close.all()):
                    raise AssertionError(
                        f"grid_solve[{name}] J={J} r_max={r_max}: {what} "
                        f"outside rtol {rtol} / atol {atol} in "
                        f"{int((~close).sum())} jobs")
                fin = torch.isfinite(ref[i])
                errs.append(float((k[i] - ref[i])[fin].abs().max())
                            if bool(fin.any()) else 0.0)
            out["max_abs_err"] = max(out["max_abs_err"], *errs)
            launch = lambda: gs.grid_solve_cuda(spec, job, r_max)
            ms = kernel_ms(launch, 20, "grid_solve")
            call_ms = cuda_ms(launch, 50)
            plain_ms = cuda_ms(lambda: gs.grid_solve_plain(spec, job, r_max),
                               5)
            bytes_ms, ops_ms = grid_solve_bound(spec, J, r_max)
            bound_ms, bound_by = bound_of(bytes_ms, ops_ms)
            print(f"grid_solve[{name}] J={J} r_max={r_max}: equal r*/choice/"
                  f"sat; max abs err u {errs[0]:.3g} pocd {errs[1]:.3g} "
                  f"cost {errs[2]:.3g}; kernel {ms:.4f} ms (wrapper call "
                  f"{call_ms:.4f} ms), plain {plain_ms:.3f} ms, bound "
                  f"{bound_ms:.6f} ms ({bound_by})")
            if (J, r_max) == (2700, 9):
                out["main"][name] = dict(ms=ms, call_ms=call_ms,
                                         plain_ms=plain_ms,
                                         bytes_ms=bytes_ms, ops_ms=ops_ms,
                                         bound_ms=bound_ms)
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


def phase_profile(jobs, p, dev, wall_s: float) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_all(Philox(0), jobs, p, theta=THETA, reps=1, device=dev)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in rows)
    n_ops = sum(e.count for e in rows)
    if busy_us <= 0:
        raise AssertionError("profiler recorded no device time")
    grid_us = sum(e.device_time_total for e in rows
                  if "grid_solve" in e.key)
    idle = 1.0 - (busy_us / 1e3) / (wall_s * 1e3)
    print(f"profile run_all reps=1: device busy {busy_us / 1e3:.3f} ms in "
          f"{n_ops} device ops; unprofiled warm wall {wall_s * 1e3:.3f} ms; "
          f"device idle share {idle:.3f}; grid_solve kernel "
          f"{grid_us / 1e3:.3f} ms")
    for e in sorted(rows, key=lambda e: -e.device_time_total)[:8]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms "
              f"{100 * e.device_time_total / busy_us:5.1f}% x{e.count:<5d} "
              f"{e.key[:90]}")
    return dict(device_busy_ms=busy_us / 1e3, device_ops=n_ops,
                idle_share=idle, grid_solve_ms=grid_us / 1e3)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible")
    dev = torch.device("cuda")
    card_line = card()
    print(card_line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.compile_sources(["grid_solve"])
    build_s = time.perf_counter() - t0
    print(f"build: grid_solve in {build_s:.2f} s")
    for line in build.build_log("grid_solve").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
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
    prof = phase_profile(jobs, p, dev, walls[1][1])

    at_main = check["main"].values()
    bound_ms, bound_by = bound_of(sum(m["bytes_ms"] for m in at_main),
                                  sum(m["ops_ms"] for m in at_main))
    kernels = [{
        "name": "grid_solve",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grid_solve.cu",
        "replaces": "src/repro/kernels/grid_solve.py:142",
        "launches": launches,
        "max_abs_err": check["max_abs_err"],
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
        "build_s": build_s,
        "run_all_wall_s_first_second": {str(r): w
                                        for r, w in walls.items()},
        "profile_reps1": prof,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
