"""`BENCHMARK.json` and the files of one cell, found by name.

A cell names a configuration and a traffic mix. Everything of a
configuration is `configs/<config>.json`, everything of a cell's traffic
(and the limits of its check) is `workloads/<cell>.json`, and each
per-layer metric is read by `metrics/<metric>.py`. A later cell, config
or metric is a new file and a new entry: nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
BENCHMARK = ROOT / "BENCHMARK.json"

def load_benchmark(path: Path = BENCHMARK) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing: run from the root of a "
                                f"checkout that holds BENCHMARK.json")
    return json.loads(path.read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str) -> dict:
    """The configuration's file (`file` of its entry), as run."""
    return json.loads((ROOT / config_entry(bench, name)["file"]).read_text())


def load_traffic(cell: str) -> dict:
    path = BENCH / "workloads" / f"{cell}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic file for cell {cell!r}: {path}")
    return json.loads(path.read_text())


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries that a run of `cell` reports: the end-to-end
    ones untraced, the per-layer ones traced; an entry with `workloads`
    only in the cells it lists."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader(metric: str):
    """`read(run)` of `metrics/<metric>.py`: a float, or None where the
    run holds nothing to read."""
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
