"""The whole slice: `repro_torch.run_all` against the reference's `run_all`
on the same trace, with the reference's draws replayed into the port, and
the port's boundaries (no JAX, no reference imports, the device rule, the
registry order).

Integers are compared exactly (r* per job, its sum, the saturation count).
job_met is equal except for jobs whose completion ties with the deadline
within f32 rtol 1e-5. pocd, mean_cost and the utilities agree within f32
rtol, not bitwise: the sums run in another order.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.sim import SimParams as RefSimParams
from repro.sim import generate as ref_generate
from repro.sim import run_all as ref_run_all
from repro.sim import run_strategy as ref_run_strategy
from repro.strategies import index_of as ref_index_of
from repro.strategies import names as ref_names

import repro_torch
from repro_torch import SimParams, generate, run_all, run_strategy
from test_torch_sim import JaxReplay, deadline_ties

ROOT = Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)


class OneRep:
    """The draws of replication `rep` of `source`, served as replication 0
    (to rerun one replication of a reps > 1 run on its own)."""

    def __init__(self, source, rep):
        self.source, self.rep = source, rep

    def uniform(self, strategy, rep, name, shape, device):
        return self.source.uniform(strategy, self.rep, name, shape, device)


@pytest.fixture(scope="module")
def slice_runs():
    ref_jobs = ref_generate(n_jobs=120, seed=3)
    jobs = generate(120, seed=3, device="cpu")
    runs = {}
    for reps in (1, 8):
        ref = ref_run_all(KEY, ref_jobs, RefSimParams(), theta=1e-4,
                          reps=reps)
        port = run_all(JaxReplay(KEY, reps), jobs, SimParams(), theta=1e-4,
                       reps=reps, device="cpu")
        runs[reps] = (ref, port)
    return ref_jobs, jobs, runs


def allowed_met_gap(jobs, strategy, reps, r_min):
    """Per job: the share of replications whose port completion ties with
    the deadline (where a met flip is legitimate)."""
    source = JaxReplay(KEY, reps)
    ties = np.zeros(jobs.n_jobs)
    for rep in range(reps):
        out = run_strategy(OneRep(source, rep) if reps > 1 else source, jobs,
                           strategy, SimParams(), theta=1e-4,
                           r_min=0.0 if strategy == "hadoop_ns" else r_min,
                           device="cpu")
        ties += deadline_ties(out.result.job_completion.numpy(),
                              jobs.D.numpy())
    return ties / reps


@pytest.mark.parametrize("reps", [1, 8])
def test_run_all_matches_reference(slice_runs, reps):
    ref_jobs, jobs, runs = slice_runs
    (ref_outs, ref_r_min), (outs, r_min) = runs[reps]
    assert list(outs) == list(ref_outs) == list(ref_names())
    J = jobs.n_jobs
    for name, want in ref_outs.items():
        got = outs[name]
        np.testing.assert_array_equal(got.r_opt.numpy(),
                                      np.asarray(want.r_opt), err_msg=name)
        assert int(got.r_opt.sum()) == int(np.asarray(want.r_opt).sum())
        assert int(got.n_saturated) == int(want.n_saturated)
        np.testing.assert_allclose(got.theory_pocd.numpy(),
                                   np.asarray(want.theory_pocd), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        np.testing.assert_allclose(got.theory_cost.numpy(),
                                   np.asarray(want.theory_cost), rtol=1e-4,
                                   err_msg=name)
        met = got.result.job_met.to(torch.float32).numpy()
        ref_met = np.asarray(want.result.job_met, np.float32)
        gap = np.abs(met - ref_met)
        if gap.any():      # only then are the per-replication ties needed
            allowed = allowed_met_gap(jobs, name, reps, r_min)
            assert (gap <= allowed + 1e-6).all(), name
        np.testing.assert_allclose(float(got.result.pocd),
                                   float(want.result.pocd),
                                   atol=gap.sum() / J + 1e-6, rtol=0)
        np.testing.assert_allclose(float(got.result.mean_cost),
                                   float(want.result.mean_cost), rtol=1e-5)
        np.testing.assert_allclose(float(got.utility), float(want.utility),
                                   rtol=1e-5, atol=1e-6)
    assert r_min == pytest.approx(ref_r_min, abs=1e-7)


@pytest.mark.parametrize("strategy,oracle", [("adaptive", True),
                                             ("srestart", False)])
def test_run_strategy_r_override_matches_reference(strategy, oracle):
    """A pinned r in place of the solve: the choose closure, the theory
    columns at r, and straggler detection by the estimator."""
    ref_jobs = ref_generate(n_jobs=30, seed=4)
    want = ref_run_strategy(KEY, ref_jobs, strategy, RefSimParams(),
                            theta=1e-4, r_min=0.02, oracle=oracle,
                            r_override=2)
    source = JaxReplay(KEY)
    # the reference uses the caller's key directly, without a fold_in
    source.key_of = lambda s, rep, name: (
        KEY if name == "key" else
        jax.random.split(KEY)[1 if name == "k2" else 0])
    got = run_strategy(source, generate(30, seed=4, device="cpu"), strategy,
                       SimParams(), theta=1e-4, r_min=0.02, oracle=oracle,
                       r_override=2, device="cpu")
    assert (got.r_opt.numpy() == 2).all()
    np.testing.assert_allclose(got.theory_pocd.numpy(),
                               np.asarray(want.theory_pocd), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got.theory_cost.numpy(),
                               np.asarray(want.theory_cost), rtol=1e-4)
    np.testing.assert_array_equal(got.result.job_met.numpy(),
                                  np.asarray(want.result.job_met))
    np.testing.assert_allclose(float(got.result.mean_cost),
                               float(want.result.mean_cost), rtol=1e-5)


def test_registry_order_equals_reference():
    assert repro_torch.names() == ref_names()
    assert repro_torch.names("optimized") == ref_names(kind="optimized")
    for name in ref_names():
        assert repro_torch.index_of(name) == ref_index_of(name)


def test_port_imports_neither_jax_nor_the_reference():
    """The package (with its workloads, coupled, obs and cluster packages)
    and chip_smoke.py import torch and numpy only."""
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert\n"
        "import repro_torch.kernels.build, repro_torch.kernels.grid_solve\n"
        "import repro_torch.workloads, repro_torch.coupled, repro_torch.obs\n"
        "import repro_torch.cluster, repro_torch.obs.metrics\n"
        "import repro_torch.kernels.dispatch_scan\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_default_device_is_the_card():
    """Without a card, entry points called without `device=` raise; with
    `device="cpu"` they run the plain path."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    jobs = generate(12, seed=1, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(12, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_all(repro_torch.Philox(0), jobs, SimParams())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.solve_jobs("clone", repro_torch.sim.jobspecs_of(
            jobs, SimParams(), 1e-4), 9)
    outs, _ = run_all(repro_torch.Philox(0), jobs, SimParams(),
                      device="cpu")
    assert set(outs) == set(ref_names())
