"""Port parity of the facade (`repro_torch.api`: `RunConfig`, `simulate`).

What is held: `RunConfig` has the reference's fields and defaults, and
`resolve_path` routes a table of configs as the reference's does; on
every route (flat, flat fleet, capacity, serve, chaos) `simulate` gives
the bits of the direct call; legacy keywords warn and match the config,
unknown ones raise TypeError; and `import repro_torch` loads no facade.
"""
import dataclasses
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro.api import RunConfig as RefRunConfig

import repro_torch
from repro_torch import Philox, RunConfig, SimParams, generate, simulate
from repro_torch import run_all, run_cluster
from repro_torch.chaos import FaultEvent, FaultPlan
from repro_torch.serve import run_serve, uniform_requests

P = SimParams()

CONFIGS = [
    {}, dict(devices=8), dict(devices=1, chunk_jobs=64),
    dict(chunk_jobs=4096, chaos=object()), dict(checkpoint="ckpt"),
    dict(resume=True), dict(budget=1e6), dict(slots=32),
    dict(governor=object()), dict(admission=object()),
    dict(discipline="edf"), dict(passes=3), dict(collect_metrics=True),
    dict(slots=32, chunk_jobs=8), dict(serve=True), dict(window=48),
    dict(refit_every=64), dict(probe_every=4), dict(r_override=2),
    dict(slots=4, serve=True), dict(slots=2, path="flat"),
    dict(serve=True, path="capacity"), dict(path="serve"),
    dict(theta=1e-3, max_r=6, reps=3, oracle=False),
]


def test_runconfig_has_the_reference_fields():
    got = [(f.name, f.default) for f in dataclasses.fields(RunConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(RefRunConfig)]
    assert got == want
    assert "device" not in {f.name for f in dataclasses.fields(RunConfig)}
    cfg = RunConfig(slots=3)
    assert cfg.replace(slots=None) == RunConfig()
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.slots = 4


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: ",".join(kw) or "-")
def test_resolve_path_matches_reference(kw):
    assert RunConfig(**kw).resolve_path() == RefRunConfig(**kw).resolve_path()


def test_resolve_path_refuses_an_unknown_path():
    with pytest.raises(ValueError, match="unknown path"):
        RunConfig(path="warp").resolve_path()


@pytest.fixture(scope="module")
def jobs():
    return generate(36, seed=2, device="cpu")


def same_outs(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for name, x in a.items():
        y = b[name]
        for f in ("job_met", "job_completion", "job_cost", "pocd",
                  "mean_cost"):
            assert torch.equal(getattr(x.result, f),
                               getattr(y.result, f)), (name, f)
        if hasattr(x, "r_opt"):
            assert torch.equal(x.r_opt, y.r_opt), name
        q = getattr(x, "queue", None)
        if q is not None:
            for f in q._fields[:-1]:
                assert torch.equal(getattr(q, f), getattr(y.queue, f)), f
            assert q.slots == y.queue.slots


STRATS = ("hadoop_ns", "clone", "sresume")
PLAN = FaultPlan(events=(FaultEvent("chunk_fail", 1, 2),
                         FaultEvent("corrupt", 2, 1),
                         FaultEvent("device_loss", 0, 2)))


@pytest.mark.parametrize("route", ["flat", "flat-fleet", "capacity",
                                   "chaos", "capacity-chaos"])
def test_simulate_equals_the_direct_call(jobs, route):
    kw = dict(strategies=STRATS)
    direct = dict(strategies=STRATS, device="cpu")
    if route == "flat-fleet":
        kw.update(chunk_jobs=12, block_jobs=6, reps=2)
        direct.update(chunk_jobs=12, block_jobs=6, reps=2)
    elif route == "capacity":
        kw.update(slots=40, reps=2)
        direct.update(slots=40, reps=2)
    elif route == "chaos":
        kw.update(chaos=PLAN, chunk_jobs=12)
        direct.update(chaos=PLAN, chunk_jobs=12)
    elif route == "capacity-chaos":
        kw.update(slots=40, chaos=PLAN, chunk_jobs=12)
        direct.update(slots=40, chaos=PLAN, chunk_jobs=12)
    cfg = RunConfig(**kw)
    got, r_got = simulate(Philox(0), jobs, P, cfg=cfg, device="cpu")
    call = run_cluster if cfg.resolve_path() == "capacity" else run_all
    want, r_want = call(Philox(0), jobs, P, **direct)
    assert r_got == r_want
    same_outs(got, want)


def test_simulate_serve_equals_run_serve():
    reqs = uniform_requests(96, t_min=1.0, beta=1.5, D=4.0)
    cfg = RunConfig(serve=True, window=48,
                    strategies=("hadoop_ns", "sresume"), theta=1e-3)
    got, r1 = simulate(Philox(0), reqs, cfg=cfg, device="cpu")
    want, r2 = run_serve(Philox(0), reqs, theta=1e-3, window=48,
                         strategies=("hadoop_ns", "sresume"), device="cpu")
    assert r1 == r2
    for name in got:
        for f in ("job_met", "job_completion", "job_cost"):
            assert torch.equal(getattr(got[name].result, f),
                               getattr(want[name].result, f)), (name, f)
        assert got[name].latency == want[name].latency


def test_legacy_keywords_warn_and_match_the_config(jobs):
    cfg_outs, _ = simulate(Philox(0), jobs, P, device="cpu",
                           cfg=RunConfig(theta=1e-3, max_r=6,
                                         strategies=STRATS))
    with pytest.warns(DeprecationWarning, match="RunConfig"):
        kw_outs, _ = simulate(Philox(0), jobs, P, device="cpu", theta=1e-3,
                              max_r=6, strategies=STRATS)
    same_outs(cfg_outs, kw_outs)


def test_unknown_keyword_and_bad_routes_raise(jobs):
    with pytest.raises(TypeError, match="unexpected keyword"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            simulate(Philox(0), jobs, P, chunk_size=4, device="cpu")
    with pytest.raises(TypeError, match="unexpected keyword"):
        simulate(Philox(0), jobs, P, devise="cpu")
    with pytest.raises(ValueError, match="oracle"):
        simulate(Philox(0), jobs, P, cfg=RunConfig(oracle=False),
                 device="cpu")
    with pytest.raises(ValueError, match="offline"):
        simulate(Philox(0), jobs, P, cfg=RunConfig(budget=1e6, serve=True),
                 device="cpu")


def test_import_repro_torch_is_lazy():
    code = ("import sys, repro_torch; "
            "assert 'repro_torch.api' not in sys.modules; "
            "from repro_torch import RunConfig, simulate; "
            "assert RunConfig().resolve_path() == 'flat'; "
            "assert not {'jax', 'repro'} & set(sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=os.path.dirname(
                       repro_torch.__path__[0])))
    with pytest.raises(AttributeError):
        repro_torch.no_such_name


def test_simulate_default_params_and_config(jobs):
    got, r_got = simulate(Philox(0), jobs, device="cpu",
                          cfg=RunConfig(strategies=STRATS))
    want, r_want = run_all(Philox(0), jobs, P, strategies=STRATS,
                           device="cpu")
    assert r_got == r_want
    same_outs(got, want)
    assert np.isfinite(float(got["sresume"].result.pocd))
