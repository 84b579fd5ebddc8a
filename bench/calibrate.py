#!/usr/bin/env python3
"""Readings that a cell's limits are set from, and the depth that fits.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--faults half_batch,token] [--out FILE]
    python3 bench/calibrate.py --workload <cell> --probe-layers 9,10

The first form builds the cell's trainer once and, for every seed, runs
its checked steps through `Trainer.run` (sound, then with each fault
planted on the control seeds); then frees it and, for every seed, runs
the float32 reference and, on the control seeds, the control (the
reference with float8 products) in the program's place. It prints each
number's readings: the largest over the sound seeds (the lower reading),
and the smallest of the control and of each fault (the upper ones).

The second form runs each depth's trainer for a short window in a
process of its own and prints its peak memory and tokens/s, or that it
ran out of memory. Both run on the card; the benchmark's runs never
call them.
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def calibrate(bench, cell, seeds, control_seeds=(), faults=(), device="cuda",
              cfg=None, traffic=None, log=print) -> dict:
    from bench.lib import compare, spec
    from bench.lib.cell import expected_batches, plant, reference_run
    from bench.lib.train import TrainRun
    cfg = cfg or spec.load_config(bench, cell["config"])
    traffic = traffic or spec.load_traffic(cell["name"])
    run = TrainRun(cfg, traffic, seeds[0], device).build()
    prog = {}
    for seed in seeds:
        for fault in (None,) + tuple(f for f in faults
                                     if seed in control_seeds):
            undo = plant(run, fault) if fault else (lambda: None)
            try:
                run.reset(seed)
                run.run_checked()
            finally:
                undo()
            prog[(seed, fault)] = run.readings()
            log(f"program seed {seed} fault {fault}: losses "
                f"{prog[(seed, fault)]['loss']}")
    run.free()
    out = {"sound": {}, "control": {}, "faults": {f: {} for f in faults}}
    for seed in seeds:
        t0 = time.perf_counter()
        ref = reference_run(cfg, traffic, seed, device)
        expected = expected_batches(cfg, traffic, seed,
                                    traffic["checked_steps"])
        log(f"reference seed {seed}: {time.perf_counter() - t0:.1f} s, "
            f"losses {ref['loss']}")
        for (s, fault), p in prog.items():
            if s != seed:
                continue
            vals, where = compare.readings(p, ref, expected, [])
            key = out["sound"] if fault is None else out["faults"][fault]
            key[seed] = dict(vals, worst=where,
                             details=compare.details(p, ref))
            log(f"  {fault or 'sound'}: {vals} {where} step gaps "
                f"{compare.details(p, ref)['loss_gaps']}")
        if seed in control_seeds:
            t0 = time.perf_counter()
            ctl = reference_run(cfg, traffic, seed, device, "float8")
            ctl["batches"] = expected
            vals, where = compare.readings(ctl, ref, expected, [])
            out["control"][seed] = dict(vals, worst=where,
                                        details=compare.details(ctl, ref))
            log(f"  control ({time.perf_counter() - t0:.1f} s): {vals} "
                f"{where} step gaps {compare.details(ctl, ref)['loss_gaps']}")
    numbers = ("loss_gap", "grad_gap", "update_gap", "update_diff")
    out["lower"] = {n: max(v[n] for v in out["sound"].values())
                    for n in numbers}
    out["upper"] = {
        kind: {n: min(v[n] for v in rows.values()) for n in numbers}
        for kind, rows in [("control", out["control"])]
        + [(f, out["faults"][f]) for f in faults] if rows}
    return out


def probe(cell_name: str, layers: list, seconds: float) -> None:
    for n in layers:
        code = (
            "import sys, json, torch\n"
            f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
            "from bench.lib import spec\n"
            "from bench.lib.train import TrainRun\n"
            "b = spec.load_benchmark()\n"
            f"c = spec.workload(b, {cell_name!r})\n"
            "cfg = spec.load_config(b, c['config'])\n"
            f"cfg['num_hidden_layers'] = {n}\n"
            "r = TrainRun(cfg, spec.load_traffic(c['name']), 1, 'cuda')\n"
            "r.build().reset(1)\n"
            f"w = r.run_window({seconds})\n"
            "print('PROBE', json.dumps({'layers': cfg['num_hidden_layers'],"
            " 'peak_gib': w['process_peak_bytes'] / 2**30,"
            " 'window_peak_gib': w['peak_bytes'] / 2**30,"
            " 'tokens_per_s': w['tokens'] / w['window_s'],"
            " 'steps': w['steps'], 'setup_s': w['setup_s'],"
            " 'capacity_gib': torch.cuda.get_device_properties(0)"
            ".total_memory / 2**30}))\n")
        p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True)
        line = [x for x in p.stdout.splitlines() if x.startswith("PROBE")]
        if line:
            print(line[-1], flush=True)
        else:
            tail = (p.stderr or "").strip().splitlines()[-3:]
            print(f"PROBE layers {n}: failed, exit {p.returncode}: "
                  f"{' | '.join(tail)}", flush=True)


def _keyed(x):
    """JSON keys as strings, all the way down."""
    if isinstance(x, dict):
        return {str(k): _keyed(v) for k, v in x.items()}
    return x


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--probe-layers", default="")
    ap.add_argument("--probe-seconds", type=float, default=8.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA card")
    from bench.lib import spec
    if args.probe_layers:
        probe(args.workload, [int(x) for x in args.probe_layers.split(",")],
              args.probe_seconds)
        return
    bench = spec.load_benchmark()
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    res = calibrate(bench, spec.workload(bench, args.workload),
                    ints(args.seeds), ints(args.control_seeds),
                    tuple(x for x in args.faults.split(",") if x),
                    log=lambda *a: print(*a, flush=True))
    print("LOWER", json.dumps(res["lower"]))
    print("UPPER", json.dumps(res["upper"]))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            _keyed(copy.deepcopy(res)), indent=1, default=str))
    print(f"calibrate: {time.perf_counter() - START:.1f} s", flush=True)


if __name__ == "__main__":
    main()
