"""Port parity of the joint budget solve (`repro_torch.coupled`) and of
`budget=` through the runner.

Both packages solve the reference's acceptance case: the 120-job
`multi-tenant-sla` trace of seed 0, written by the reference as `.npz` and
loaded by the port, theta 1e-4, B = 850,000. The grids agree within rtol
1e-6 (U with an atol of 1e-7 where its two terms cancel); a slack budget
gives the port's `solve_jobs` bit for bit; at B the port's lam is within
rtol 1e-5 of the reference's and its selection equal but for jobs whose
two best priced scores lie within 1e-6 (relative) of each other.

The reference's own selection at B spends 850,405.4 > B: its in-loop
check and its final selection read one near-tied job differently. The
port's spend is held to B exactly.
"""
import warnings

import numpy as np
import pytest
import torch

from repro.coupled import repair_independent as ref_repair
from repro.coupled import solve_jobs_coupled as ref_solve_coupled
from repro.coupled import utility_cost_grids as ref_grids
from repro.sim import SimParams as RefSimParams
from repro.sim.runner import jobspecs_of as ref_jobspecs_of
from repro.strategies import get as ref_get
from repro.workloads import make_trace as ref_make_trace
from repro.workloads import save_trace as ref_save_trace
from repro.workloads import to_jobset as ref_to_jobset

from repro_torch import (Philox, SimParams, generate, run_all, run_strategy,
                         solve_jobs)
from repro_torch.coupled import (repair_independent, solve_jobs_coupled,
                                 total_utility, utility_cost_grids)
from repro_torch.sim.runner import jobspecs_of
from repro_torch.strategies import get
from repro_torch.workloads import load_trace, to_jobset

P = SimParams()
SCEN, N_JOBS, SEED, THETA, BUDGET = ("multi-tenant-sla", 120, 0, 1e-4,
                                     850_000.0)
NEAR_TIE = 1e-6


@pytest.fixture(scope="module")
def sla_trace(tmp_path_factory):
    """(port JobSet, reference JobSet) of the reference's trace."""
    trace = ref_make_trace(SCEN, n_jobs=N_JOBS, seed=SEED)
    path = tmp_path_factory.mktemp("trace") / "sla.npz"
    ref_save_trace(trace, path)
    return to_jobset(load_trace(path), device="cpu"), ref_to_jobset(trace)


@pytest.fixture(scope="module")
def sla(sla_trace):
    """(port JobSpec, reference JobSpec) of the reference's trace."""
    jobs, ref_jobs = sla_trace
    return (jobspecs_of(jobs, P, THETA, 0.0),
            ref_jobspecs_of(ref_jobs, RefSimParams(), THETA, 0.0))


@pytest.fixture(scope="module")
def sla_ns(sla_trace):
    """(port JobSet, port JobSpec at run_all's R_min, R_min): Hadoop-NS's
    PoCD minus 1e-3, so some grid levels have U = -inf."""
    jobs, _ = sla_trace
    _, r_min = run_all(Philox(0), jobs, P, theta=THETA,
                       strategies=["hadoop_ns"], device="cpu")
    return jobs, jobspecs_of(jobs, P, THETA, r_min), r_min


@pytest.fixture(scope="module")
def jobs120():
    return generate(120, seed=3, device="cpu")


def clone_cost(specs):
    U, E = utility_cost_grids(get("clone"), specs, 9)
    return U, E, E * specs.C[:, None]


def spend_of(cost, i) -> float:
    return float(torch.gather(cost, 1, i[:, None].long()).sum())


@pytest.mark.parametrize("strategy", ["clone", "srestart", "sresume",
                                      "adaptive"])
def test_grids_match_reference(sla, strategy):
    specs, ref_specs = sla
    U, E = utility_cost_grids(get(strategy), specs, 9)
    want_U, want_E = (np.asarray(x) for x in ref_grids(ref_get(strategy),
                                                       ref_specs, 9))
    assert U.shape == E.shape == (N_JOBS, 9)
    np.testing.assert_array_equal(np.isfinite(U.numpy()),
                                  np.isfinite(want_U))
    np.testing.assert_allclose(U.numpy(), want_U, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(E.numpy(), want_E, rtol=1e-6)


@pytest.mark.parametrize("strategy", ["clone", "sresume", "adaptive"])
def test_slack_budget_is_solve_jobs_bitwise(sla, strategy):
    specs, _ = sla
    want = solve_jobs(strategy, specs, 9, device="cpu")
    got, info = solve_jobs_coupled(strategy, specs, 9, 1e12, device="cpu")
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert float(info.lam) == 0.0
    assert not bool(info.binding) and bool(info.feasible)


@pytest.mark.parametrize("strategy", ["clone", "sresume"])
def test_slack_budget_run_is_bitwise_unbudgeted(jobs120, strategy):
    a = run_strategy(Philox(0), jobs120, strategy, P, theta=1e-3, max_r=8,
                     device="cpu")
    b = run_strategy(Philox(0), jobs120, strategy, P, theta=1e-3, max_r=8,
                     budget=1e12, device="cpu")
    assert torch.equal(a.r_opt, b.r_opt)
    for x, y in zip(a.result, b.result):
        assert torch.equal(x, y)
    assert a.coupled is None and b.coupled is not None


def test_binding_budget_matches_reference_and_holds(sla):
    """At B the port is feasible and binding, spends at most B, finds the
    reference's lam, and picks the reference's r* but at near-ties."""
    specs, ref_specs = sla
    (r, *_), info = solve_jobs_coupled("clone", specs, 9, BUDGET,
                                       device="cpu")
    (ref_r, *_), ref_info = ref_solve_coupled("clone", ref_specs, 9, BUDGET)
    assert bool(info.feasible) and bool(info.binding)
    assert float(info.spend) <= BUDGET < float(info.spend_free)
    assert float(info.lam) > 0.0
    assert float(info.lam) == pytest.approx(float(ref_info.lam), rel=1e-5)
    U, _, cost = clone_cost(specs)
    assert spend_of(cost, r) == float(info.spend)
    differ = np.nonzero(r.numpy() != np.asarray(ref_r))[0]
    score = (U - float(ref_info.lam) * cost).numpy()
    for j in differ:
        top = np.sort(score[j])[-2:]
        assert top[1] - top[0] <= NEAR_TIE * abs(top[1]), j
    assert len(differ) <= 1


def test_dual_beats_repair_and_competitive_policies(sla):
    """The reference's acceptance property, on the port: the dual's total
    utility is >= the repaired independent solution's and > both
    competitive policies', all within B and scored on clone's grids."""
    specs, ref_specs = sla
    U, E, cost = clone_cost(specs)
    (i_dual, *_), _ = solve_jobs_coupled("clone", specs, 9, BUDGET,
                                         device="cpu")
    i_rep = repair_independent(U, E, specs.C, BUDGET)
    ref_U, ref_E = ref_grids(ref_get("clone"), ref_specs, 9)
    np.testing.assert_array_equal(
        i_rep.numpy(), np.asarray(ref_repair(ref_U, ref_E, ref_specs.C,
                                             BUDGET)))
    tot_dual = total_utility(U, i_dual)
    assert spend_of(cost, i_dual) <= BUDGET
    assert spend_of(cost, i_rep) <= BUDGET
    assert tot_dual >= total_utility(U, i_rep)
    for name in ("clone_prop", "clone_sjf"):
        (i_c, *_), inf_c = solve_jobs_coupled(name, specs, 9, BUDGET,
                                              device="cpu")
        (ref_c, *_), _ = ref_solve_coupled(name, ref_specs, 9, BUDGET)
        np.testing.assert_array_equal(i_c.numpy(), np.asarray(ref_c))
        assert bool(inf_c.feasible), name
        assert spend_of(cost, i_c) <= BUDGET, name
        assert tot_dual > total_utility(U, i_c), name


def test_tighter_budget_never_raises_utility(sla):
    specs, _ = sla
    U, _, cost = clone_cost(specs)
    lo = float(cost.amin(dim=1).sum())
    hi = spend_of(cost, torch.argmax(U, dim=1))
    totals = []
    for frac in (0.2, 0.5, 0.8, 1.2):
        b = lo + frac * (hi - lo)
        (i, *_), info = solve_jobs_coupled("clone", specs, 9, b,
                                           device="cpu")
        assert bool(info.feasible) and float(info.spend) <= b
        totals.append(total_utility(U, i))
    assert totals == sorted(totals), totals


def finite_min_spend(U, cost) -> float:
    """Spend of the cheapest selection the priced argmax can make: levels
    whose U is -inf never win it."""
    return float(torch.where(torch.isfinite(U), cost, torch.inf)
                 .amin(dim=1).sum())


def test_budget_below_every_selectable_selection_warns(sla_ns):
    """At run_all's positive R_min the sum of row minima counts levels
    whose U is -inf. A budget between it and the cheapest selection with
    finite U fits no selection the solver can make: the solve is
    infeasible, warns, and returns that cheapest selection."""
    jobs, specs, r_min = sla_ns
    U, _, cost = clone_cost(specs)
    lo, lo_finite = float(cost.amin(dim=1).sum()), finite_min_spend(U, cost)
    assert r_min > 0.0 and lo < lo_finite
    b = 0.5 * (lo + lo_finite)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = run_strategy(Philox(0), jobs, "clone", P, theta=THETA,
                           r_min=r_min, budget=b, device="cpu")
    warned = any("no selection meets the budget" in str(x.message)
                 for x in w if x.category is RuntimeWarning)
    info = out.coupled
    assert warned and not bool(info.feasible)
    assert float(info.spend) == lo_finite > b
    assert bool(torch.isfinite(torch.gather(
        U, 1, out.r_opt[:, None].long())).all())


@pytest.mark.parametrize("strategy", ["clone", "srestart", "sresume",
                                      "adaptive", "clone_prop",
                                      "clone_sjf"])
def test_spend_within_budget_whenever_feasible(sla_ns, strategy):
    """At run_all's R_min, on budgets below, inside and above the
    strategy's band: the solve is feasible exactly when it spends at most
    B, and the dual solve is feasible exactly when the cheapest selection
    with finite U fits."""
    _, specs, _ = sla_ns
    U, E = utility_cost_grids(get(strategy), specs, 9)
    cost = E * specs.C[:, None]
    lo, hi = float(cost.amin(dim=1).sum()), spend_of(cost, U.argmax(1))
    lo_finite = finite_min_spend(U, cost)
    for b in (0.5 * lo, 0.5 * (lo + lo_finite), lo_finite,
              0.5 * (lo_finite + hi), hi, 2.0 * hi):
        _, info = solve_jobs_coupled(strategy, specs, 9, b, device="cpu")
        assert bool(info.feasible) == (float(info.spend) <= b), b
        if get(strategy).allocate is None:
            assert bool(info.feasible) == (lo_finite <= b), b


def test_infeasible_budget_returns_min_cost_and_warns(jobs120):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = run_strategy(Philox(0), jobs120, "sresume", P, theta=1e-3,
                           budget=1.0, device="cpu")
    assert not bool(out.coupled.feasible)
    assert any("no selection meets the budget" in str(x.message)
               for x in w if x.category is RuntimeWarning)
    specs = jobspecs_of(jobs120, P, 1e-3, 0.0)
    _, E = utility_cost_grids(get("sresume"), specs, 9)
    cost = E * specs.C[:, None]
    assert float(out.coupled.spend) == pytest.approx(
        float(cost.amin(dim=1).sum()), rel=1e-6)


def test_baselines_reject_or_ignore_a_budget(sla, jobs120):
    specs, _ = sla
    with pytest.raises(ValueError, match="baseline"):
        solve_jobs_coupled("hadoop_ns", specs, 9, 1e6, device="cpu")
    out = run_strategy(Philox(0), jobs120, "hadoop_ns", P, budget=1e6,
                       device="cpu")
    assert out.coupled is None
    pinned = run_strategy(Philox(0), jobs120, "sresume", P, r_override=2,
                          budget=1.0, device="cpu")
    assert pinned.coupled is None and (pinned.r_opt == 2).all()


def test_competitive_policies_differ_under_budget(sla):
    specs, _ = sla
    picks = {name: solve_jobs_coupled(name, specs, 9, BUDGET,
                                      device="cpu")[0][0].numpy()
             for name in ("clone", "clone_prop", "clone_sjf")}
    assert not np.array_equal(picks["clone"], picks["clone_prop"])
    assert not np.array_equal(picks["clone"], picks["clone_sjf"])
