#!/usr/bin/env python3
"""Run one cell of `BENCHMARK.json` once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell's set-up (the trainer built at
its sizes, the seed's weights, its checked steps) is followed by a
window of whole steps lasting at least `--seconds`; then the program's
state is freed and the float32 reference decides `correct`. With
`--trace 1` the window runs under the profiler and the line carries the
per-layer metrics instead of the end-to-end ones. The last line of
standard output is the result; the last lines of standard error name
each number compared beside its limit. No card, or fewer than the cell
asks for: exit 3 and no result. The kernels' build cache is
`src/repro_torch/kernels/build/` in the checkout; other caches go to
`.bench_cache/` there.
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def fail(msg: str, code: int = 3):
    print(f"bench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bench.lib import guard, spec
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the program's package {ROOT / 'src' / 'repro_torch'} is "
             f"missing", 2)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        fail(f"cell {cell['name']} needs {cell['chips']} CUDA card(s); "
             f"torch sees {torch.cuda.device_count()}")
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "extensions")
    sys.path.insert(0, str(ROOT / "src"))
    from bench.lib.cell import run_cell
    seed = args.seed % (1 << 63)
    result, lines = run_cell(bench, cell, seed, args.seconds,
                             bool(args.trace), device="cuda", start=START)
    found = guard.forbidden_loaded()
    if found:
        fail(f"forbidden modules loaded in this process: {found}", 4)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
