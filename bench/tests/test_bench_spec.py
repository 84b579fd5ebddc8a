"""BENCHMARK.json against the contract's shapes, and every cell's,
config's and metric's files found by name."""
import json
import math
import re

import pytest

from bench.lib import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size(bench):
    assert set(bench) == TOP
    assert len(spec.BENCHMARK.read_bytes()) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (spec.ROOT / p).is_dir()
    for w in bench["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in bench["paths"])


def test_names_and_units(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert w["config"] in names
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for group in (bench["configs"], bench["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in spec.metrics_of(bench, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(bench, w["name"], True)
        for m in spec.metrics_of(bench, w["name"], True):
            assert m["moves"] in e2e


def test_roofline_and_mfu_names_are_shares(bench):
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("kind", ["configs", "workloads", "metrics"])
def test_found_by_name(bench, kind):
    if kind == "configs":
        for c in bench["configs"]:
            cfg = spec.load_config(bench, c["name"])
            assert cfg["name"] == c["name"]
            assert c["file"].startswith("bench/configs/")
            assert sorted(cfg["reduced"]) == sorted(c["reduced"])
            assert cfg["source"] == c["source"]
            for k in cfg["reduced"]:
                assert k in cfg["published"] and cfg[k] != cfg["published"][k]
            for k, d in cfg.get("departures", {}).items():
                assert k not in cfg["reduced"]
                assert d["published"] != d["run"] and d["why"]
                assert cfg.get(k, d["run"]) == d["run"]
    elif kind == "workloads":
        for w in bench["workloads"]:
            t = spec.load_traffic(w["name"])
            assert t["kind"] == "train"
            assert t["global_batch"] % t["n_micro"] == 0
            assert t["global_batch"] % t["n_data_shards"] == 0
            assert set(t["limits"]) == {"loss_gap", "grad_gap", "update_gap",
                                        "update_diff", "token_mismatch",
                                        "window_nonfinite"}
            assert all(math.isfinite(v) and v >= 0
                       for v in t["limits"].values())
    else:
        for m in bench["per_layer"]:
            assert callable(spec.reader(m["name"]))


def test_unknown_names_raise(bench):
    with pytest.raises(KeyError):
        spec.workload(bench, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric")


def test_check_budget_fits(bench):
    """A full check of 24 cells at this run length fits the driver's
    43,200 s."""
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_config_files_parse():
    for p in (spec.BENCH / "configs").glob("*.json"):
        json.loads(p.read_text())
