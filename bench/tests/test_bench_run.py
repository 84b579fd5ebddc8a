"""The result line's keys, and the command's refusals: no card, or a
directory that holds only BENCHMARK.json and the benchmark's files."""
import json
import shutil
import subprocess
import sys

from bench.lib import spec
from bench.lib.cell import run_cell
from conftest import tiny, tiny_traffic

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_result_line_keys(bench):
    cell = bench["workloads"][0]
    res, lines = run_cell(bench, cell, 2**31 + 5, 0.3, False, device="cpu",
                          cfg=tiny(cell["config"]),
                          traffic=tiny_traffic(cell["name"]))
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert "breakdown" not in res
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(res["metrics"]) == {"train_tokens_per_s", "peak_mem_gib",
                                   "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(res["checks"]) == set(tiny_traffic(cell["name"])["limits"])
    assert lines[-1].startswith("correct ")
    json.dumps(res)


def test_traced_line_has_busy_window_and_breakdown(bench):
    cell = bench["workloads"][0]
    res, _ = run_cell(bench, cell, 17, 0.3, True, device="cpu",
                      cfg=tiny(cell["config"]),
                      traffic=tiny_traffic(cell["name"]))
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(res["breakdown"]["idle_gaps"]) <= 10
    names = {m["name"] for m in spec.metrics_of(bench, cell["name"], True)}
    assert set(res["metrics"]) <= names
    assert list(res)[-1] == "checks"


def _run(cwd, env_extra=None):
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "mistral-nemo-12b.train-8k", "--seed", "7", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=120)


def test_no_card_no_result():
    out = _run(spec.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_files_alone_are_not_enough(tmp_path):
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
