"""The port's span tracing (`repro_torch.obs`), mirroring the reference's
span and export tests (tests/test_obs.py): tracing off is free, spans nest,
`fenced` separates dispatch from execution, and a traced run covers its
wall time with spans.

Where the reference flags a recompile (`compiled=True`, from jit's cache),
the port flags an nvcc build during the call (`built=True`). On the CPU a
call's output is finished when it returns, so `fenced` records no
execute span there; the card test checks that one is recorded on CUDA
outputs.
"""
import json
import time

import pytest
import torch

from repro_torch import Philox, SimParams, names, run_all
from repro_torch import obs
from repro_torch.kernels import build
from repro_torch.obs import export as obs_export
from repro_torch.obs import trace as obs_trace


@pytest.fixture(autouse=True)
def _tracing_off():
    """Every test starts and ends with the global tracer disabled."""
    obs_trace.disable()
    obs_trace.get_tracer().clear()
    yield
    obs_trace.disable()
    obs_trace.get_tracer().clear()


def test_span_disabled_is_shared_noop():
    s1 = obs_trace.span("a", x=1)
    s2 = obs_trace.span("b")
    assert s1 is s2
    with s1 as sp:
        sp.set(y=2)
    assert obs_trace.get_tracer().closed_spans() == []
    assert not obs.enabled()


def test_span_nesting_depth_and_attrs():
    obs_trace.enable()
    with obs_trace.span("outer", stage="demo"):
        with obs_trace.span("inner") as sp:
            sp.set(n=3)
    spans = {s.name: s for s in obs_trace.get_tracer().closed_spans()}
    assert spans["outer"].depth == 0 and spans["inner"].depth == 1
    assert spans["inner"].attrs == {"n": 3}
    assert spans["outer"].attrs == {"stage": "demo"}
    assert spans["inner"].start_ns >= spans["outer"].start_ns
    assert spans["inner"].end_ns <= spans["outer"].end_ns


def test_enable_fresh_clears_prior_spans():
    obs_trace.enable()
    with obs_trace.span("old"):
        pass
    obs_trace.enable(fresh=True)
    assert obs_trace.get_tracer().closed_spans() == []
    obs_trace.enable(fresh=False)
    with obs_trace.span("new"):
        pass
    assert [s.name for s in obs_trace.get_tracer().closed_spans()] == ["new"]


def test_fenced_dispatch_spans_and_built_flag(monkeypatch):
    """A call during which nvcc built a source gets built=True; the next
    one does not. CPU outputs need no wait, so no execute span."""
    obs_trace.enable()
    monkeypatch.setattr(build, "compiles", 0)

    def fn(x, compile_now):
        if compile_now:          # what compile_sources does per build
            build.compiles += 1
        return x * 2.0

    obs_trace.fenced("demo", fn, torch.tensor(3.0), True)
    out = obs_trace.fenced("demo", fn, torch.tensor(4.0), False)
    assert float(out) == 8.0
    spans = obs_trace.get_tracer().closed_spans()
    dispatch = [s for s in spans if s.name == "demo"]
    assert len(dispatch) == 2 and all(s.kind == "dispatch" for s in dispatch)
    assert dispatch[0].attrs.get("built") is True
    assert "built" not in dispatch[1].attrs
    assert not [s for s in spans if s.name == "demo.wait"]


def test_fenced_disabled_is_plain_call():
    calls = []

    def fn(x):
        calls.append(x)
        return x + 1

    assert obs_trace.fenced("demo", fn, 41) == 42
    assert calls == [41]
    assert obs_trace.get_tracer().closed_spans() == []


def test_chrome_trace_export(tmp_path):
    obs_trace.enable()
    with obs_trace.span("outer", scenario="demo"):
        with obs_trace.span("inner", kind="dispatch"):
            pass
    path = obs_export.write_chrome_trace(tmp_path / "t.json")
    events = json.loads(path.read_text())["traceEvents"]
    meta = [e for e in events if e["ph"] == "M"]
    slices = {e["name"]: e for e in events if e["ph"] == "X"}
    assert meta and meta[0]["args"]["name"] == "repro_torch"
    assert set(slices) == {"outer", "inner"}
    assert slices["inner"]["cat"] == "dispatch"
    assert slices["outer"]["args"] == {"scenario": "demo"}
    assert slices["inner"]["ts"] >= slices["outer"]["ts"]
    assert (slices["inner"]["ts"] + slices["inner"]["dur"]
            <= slices["outer"]["ts"] + slices["outer"]["dur"] + 1e-3)


def test_stage_breakdown_self_time_excludes_children():
    obs_trace.enable()
    with obs_trace.span("parent"):
        with obs_trace.span("child"):
            time.sleep(0.02)
    rows = obs_export.stage_breakdown()
    assert rows["child"]["total_ms"] >= 20.0
    assert rows["parent"]["self_ms"] <= rows["parent"]["total_ms"] - 15.0
    assert rows["parent"]["count"] == rows["child"]["count"] == 1


def test_traced_run_all_covers_the_pipeline():
    """A traced, budgeted run_all by scenario name: the workload spans and
    one dispatch span per strategy, >= 95% of the wall inside spans."""
    obs.enable()
    run_all(Philox(0), "multi-tenant-sla", SimParams(), budget=5e6,
            device="cpu")
    seen = {s.name for s in obs.get_tracer().closed_spans()}
    assert {"workloads.synthesize", "workloads.jobset_build"} <= seen
    assert {f"sim.run[{n}]" for n in names()} <= seen
    assert obs.coverage() >= 0.95
    text = obs.summary()
    assert "sim.run[clone]" in text and "coverage" in text


def test_optimizer_spans():
    from repro_torch.core import JobSpec, solve
    obs.enable()
    job = JobSpec.make(10.0, 2.0, 50.0, 10, phi_est=0.25, C=1.0,
                       theta=1e-3, R_min=0.0, device="cpu")
    solve(job, device="cpu")
    rows = obs.stage_breakdown()
    assert rows["optimizer.solve"]["count"] == 1
    assert rows["optimizer.solve_grid"]["count"] == len(names("chronos"))
    spans = obs.get_tracer().closed_spans()
    assert all("r_max" in s.attrs for s in spans
               if s.name == "optimizer.solve_grid")


def test_profile_writes_a_chrome_trace(tmp_path):
    obs.enable()
    with obs.profile(tmp_path):
        torch.ones(8).sum()
    doc = json.loads((tmp_path / "torch_trace.json").read_text())
    assert doc["traceEvents"]
    assert "torch.profiler" in obs.stage_breakdown()


@pytest.mark.cuda
def test_fenced_waits_for_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    obs.enable()
    x = torch.ones(1 << 20, device="cuda")
    obs.fenced("card", torch.mul, x, 2.0)
    spans = {s.name: s for s in obs.get_tracer().closed_spans()}
    assert spans["card"].kind == "dispatch"
    assert spans["card.wait"].kind == "execute"
