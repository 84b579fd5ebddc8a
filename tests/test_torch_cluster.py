"""Port parity of the finite-capacity replay (`repro_torch.cluster`).

The fixtures are the reference's own (`tests/test_cluster.py`): uniform
traces of 150 and 800 jobs of 10 tasks. Draws are the reference's
`jax.random` draws replayed into the port (`test_torch_sim.JaxReplay`).

What is held, and how tightly:
* the dispatch recursion, the replay on the reference's own table
  (`convert.attempt_table`) and the realized per-task outcomes are
  bit-equal: every step is one f32 max or add in the same order, and
  per-task minima and sums are exact in both packages;
* `busy_time`, `span` and `preempted` within rtol 1e-6 (a whole-table
  sum, added in another order);
* table builders on replayed draws: integer and bool fields equal, times
  within rtol 1e-5 (the Pareto transform's, as in test_torch_sim.py);
* `run_cluster` end to end: r* equal, job_met equal but deadline ties,
  pocd within 1/J a tie, mean_cost, mean_wait and utilization within
  rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import dispatch_scan as ref_dispatch_scan
from repro.cluster import make_pool as ref_make_pool
from repro.cluster import run_cluster as ref_run_cluster
from repro.cluster.admission import AdmissionConfig as RefAdmission
from repro.cluster.admission import admit_jobs as ref_admit_jobs
from repro.cluster.admission import offered_load as ref_offered_load
from repro.cluster.engine import build_strategy_table as ref_build_table
from repro.cluster.engine import replay as ref_replay
from repro.cluster.events import masked_dispatch as ref_masked_dispatch
from repro.cluster.slots import dispatch_order as ref_dispatch_order
from repro.obs.metrics import capacity_metrics as ref_capacity_metrics
from repro.sim import SimParams as RefSimParams
from repro.sim import uniform_jobset as ref_uniform_jobset
from repro.strategies import names as ref_names

import repro_torch
from repro_torch import Philox, SimParams, convert, run_all, run_strategy
from repro_torch.coupled import utility_cost_grids
from repro_torch.cluster import (AdmissionConfig, GovernorConfig,
                                 admit_jobs, build_strategy_table,
                                 dispatch_scan, make_pool, masked_dispatch,
                                 offered_load, replay, run_cluster,
                                 run_cluster_strategy)
from repro_torch.kernels import dispatch_scan as ds
from repro_torch.obs.metrics import capacity_metrics
from repro_torch.sim.runner import jobspecs_of
from repro_torch.strategies import StrategySpec, get, register
from test_torch_sim import JaxReplay, deadline_ties

KEY = jax.random.PRNGKey(0)
P = SimParams()
REF_P = RefSimParams()
RTOL = 1e-5


def port_jobs(ref):
    return convert.jobset(ref.n_jobs, {f: np.asarray(getattr(ref, f))
                                       for f in ref._fields[1:]},
                          device="cpu")


@pytest.fixture(scope="module")
def small_jobs():
    ref = ref_uniform_jobset(150, 10, t_min=10.0, beta=2.0, D=50.0)
    return ref, port_jobs(ref)


@pytest.fixture(scope="module")
def uniform_jobs():
    ref = ref_uniform_jobset(800, 10, t_min=10.0, beta=2.0, D=50.0)
    return ref, port_jobs(ref)


class KeyReplay(JaxReplay):
    """The reference's `build_strategy_table(KEY, ...)` draws from KEY
    itself, with no per-strategy fold_in."""

    def key_of(self, strategy, rep, name):
        return self.key if name == "key" else \
            jax.random.split(self.key)[1 if name == "k2" else 0]


# ---------------------------------------------------------------------------
# 1. the dispatch recursion
# ---------------------------------------------------------------------------


def recursion_inputs(n=3000, seed=0):
    """Releases and holds on coarse grids (ties in release and in the
    times slots come free), deadlines with ties, 20% inactive units."""
    rng = np.random.default_rng(seed)
    release = (rng.integers(0, n // 6, n) * 0.5).astype(np.float32)
    hold = (1.0 + rng.integers(0, 12, n) * 0.25).astype(np.float32)
    deadline = (release + rng.integers(1, 8, n) * 2.0).astype(np.float32)
    active = rng.random(n) >= 0.2
    return release, hold, deadline, active


_ref_masked = jax.jit(ref_masked_dispatch, static_argnums=(0, 1))


def ref_host_dispatch(slots, discipline, release, hold, active, deadline):
    """The reference's host oracle: compact the active units, sort them
    into dispatch order, one `dispatch_scan` over them."""
    idx = np.flatnonzero(active)
    sub = idx[ref_dispatch_order(discipline, release[idx], deadline[idx])]
    _, starts = ref_dispatch_scan(ref_make_pool(slots), release[sub],
                                  hold[sub], jnp.ones((sub.size,), bool))
    out = release.copy()
    out[sub] = np.asarray(starts)
    return out


@pytest.mark.parametrize("discipline", ["fifo", "edf"])
@pytest.mark.parametrize("slots", [1, 5, 37, 300])
def test_masked_dispatch_bit_equal(slots, discipline):
    release, hold, deadline, active = recursion_inputs()
    t = torch.from_numpy
    got = masked_dispatch(slots, discipline, t(release), t(hold), t(active),
                          t(deadline)).numpy()
    want = np.asarray(_ref_masked(slots, discipline, release, hold, active,
                                  deadline))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, ref_host_dispatch(slots, discipline, release, hold, active,
                               deadline))
    assert (got[active] >= release[active]).all()
    np.testing.assert_array_equal(got[~active], release[~active])


@pytest.mark.parametrize("slots", [1, 5, 37, 300])
def test_dispatch_scan_with_pool_bit_equal(slots):
    """The pool-carrying form on unsorted rows with an active mask: the
    same starts and the same final pool as the reference's scan."""
    release, hold, _, active = recursion_inputs(seed=1)
    ref_pool, want = ref_dispatch_scan(ref_make_pool(slots, t0=3.0),
                                       release, hold, active)
    pool, got = dispatch_scan(make_pool(slots, t0=3.0, device="cpu"),
                              torch.from_numpy(release),
                              torch.from_numpy(hold),
                              torch.from_numpy(active))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(pool.free.numpy(),
                                  np.asarray(ref_pool.free))
    np.testing.assert_array_equal(pool.gmin.numpy(),
                                  np.asarray(ref_pool.gmin))


def _pool_padding():
    free = make_pool(5, t0=2.0, device="cpu").free.numpy().ravel()
    assert (free[np.isfinite(free)] == 2.0).sum() == 5
    assert np.isinf(free).sum() == free.size - 5


def _single_slot_serializes():
    _, starts = dispatch_scan(make_pool(1, device="cpu"), torch.zeros(3),
                              torch.full((3,), 5.0),
                              torch.ones(3, dtype=torch.bool))
    np.testing.assert_array_equal(starts.numpy(), [0.0, 5.0, 10.0])


def _skips_inactive():
    _, starts = dispatch_scan(make_pool(1, device="cpu"), torch.zeros(3),
                              torch.full((3,), 5.0),
                              torch.tensor([True, False, True]))
    np.testing.assert_array_equal(starts.numpy(), [0.0, 0.0, 5.0])


@pytest.mark.parametrize("case", [_pool_padding, _single_slot_serializes,
                                  _skips_inactive],
                         ids=["make_pool_padding",
                              "single_slot_serializes", "skips_inactive"])
def test_pool_and_scan_cases(case):
    """The reference's test_make_pool_padding,
    test_dispatch_scan_single_slot_serializes and
    test_dispatch_scan_skips_inactive, on the port."""
    case()


# ---------------------------------------------------------------------------
# 2. table builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ref_names())
def test_build_table_matches_reference(small_jobs, strategy):
    ref_jobs, jobs = small_jobs
    ref_table, ref_race = ref_build_table(KEY, ref_jobs, strategy, REF_P,
                                          theta=1e-3, max_r=8)
    table, race = build_strategy_table(KeyReplay(KEY), jobs, strategy, P,
                                       theta=1e-3, max_r=8, device="cpu")
    assert race == ref_race
    for f in ("task_id", "job_id", "can_win", "active", "is_primary"):
        np.testing.assert_array_equal(getattr(table, f).numpy(),
                                      np.asarray(getattr(ref_table, f)),
                                      err_msg=f)
    for f in ("rel_offset", "dur", "hold_cap"):
        np.testing.assert_allclose(getattr(table, f).numpy(),
                                   np.asarray(getattr(ref_table, f)),
                                   rtol=RTOL, err_msg=f)


def test_register_refuses_spec_without_build_table():
    spec = StrategySpec(name="no_table", kind="baseline", detectable=False,
                        draw=lambda *a, **k: None)
    with pytest.raises(ValueError, match="build_table"):
        register(spec)
    assert "no_table" not in repro_torch.names()


# ---------------------------------------------------------------------------
# 3. replay on the reference's own table
# ---------------------------------------------------------------------------

# every strategy meets every pool size; (discipline, passes) cycles, so
# each value of each meets both disciplines and both pass counts
REPLAY_CASES = [
    (s, slots) + ((("fifo", 2), ("edf", 3), ("edf", 2), ("fifo", 3))[
        (i + j) % 4])
    for i, s in enumerate(("sresume", "clone", "adaptive", "hadoop_s"))
    for j, slots in enumerate((40, 200, 20_000, None))]


@pytest.fixture(scope="module")
def ref_tables(small_jobs):
    ref_jobs, _ = small_jobs
    return {s: ref_build_table(KEY, ref_jobs, s, REF_P, theta=1e-3,
                               max_r=8)
            for s in ("sresume", "clone", "adaptive", "hadoop_s")}


@pytest.mark.parametrize("strategy,slots,discipline,passes", REPLAY_CASES)
def test_replay_on_reference_table_bit_equal(small_jobs, ref_tables,
                                             strategy, slots, discipline,
                                             passes):
    ref_jobs, jobs = small_jobs
    ref_table, race = ref_tables[strategy]
    want, want_rel, want_st = ref_replay(ref_table, race, ref_jobs, slots,
                                         discipline=discipline,
                                         passes=passes)
    table = convert.attempt_table(
        {f: np.asarray(getattr(ref_table, f)) for f in ref_table._fields},
        device="cpu")
    got, rel, st = replay(table, race, jobs, slots, discipline=discipline,
                          passes=passes, device="cpu")
    np.testing.assert_array_equal(rel.numpy(), np.asarray(want_rel))
    np.testing.assert_array_equal(st.numpy(), np.asarray(want_st))
    for f in ("task_completion", "task_machine", "wait"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("busy_time", "span", "preempted"):
        np.testing.assert_allclose(float(getattr(got, f)),
                                   float(getattr(want, f)), rtol=1e-6,
                                   err_msg=f)

    m = capacity_metrics(table, rel, st, got)
    ref_m = ref_capacity_metrics(ref_table, want_rel, want_st, want)
    for f in m._fields:
        a, b = getattr(m, f).numpy(), np.asarray(getattr(ref_m, f))
        if np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f)
    if slots is not None:
        assert m.depth_hist.sum() == m.n_dispatched


# ---------------------------------------------------------------------------
# 4-5. end to end
# ---------------------------------------------------------------------------


def test_run_cluster_matches_reference(small_jobs):
    """slots 200, every strategy, replayed draws. Starts and releases of a
    shared table are bit-equal (above); here the two frameworks' Pareto
    transforms differ by ulps, which can move a dispatch order at a
    near-tie in release, so the outcomes are held to the tolerances
    above."""
    ref_jobs, jobs = small_jobs
    want, ref_r_min = ref_run_cluster(KEY, ref_jobs, REF_P, slots=200,
                                      theta=1e-3)
    got, r_min = run_cluster(JaxReplay(KEY), jobs, P, slots=200, theta=1e-3,
                             device="cpu")
    assert set(got) == set(want) == set(repro_torch.names())
    assert abs(r_min - ref_r_min) <= 1.0 / jobs.n_jobs
    D = np.asarray(ref_jobs.D)
    for name, w in want.items():
        g = got[name]
        np.testing.assert_array_equal(g.r_opt.numpy(), np.asarray(w.r_opt),
                                      err_msg=name)
        flips = g.result.job_met.numpy() != np.asarray(w.result.job_met)
        ties = deadline_ties(w.result.job_completion, D)
        assert not (flips & ~ties).any(), name
        assert abs(float(g.result.pocd) - float(w.result.pocd)) <= \
            flips.sum() / jobs.n_jobs + 1e-7, name
        for a, b in ((g.result.mean_cost, w.result.mean_cost),
                     (g.queue.mean_wait, w.queue.mean_wait),
                     (g.queue.utilization, w.queue.utilization)):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-4,
                                       err_msg=name)
        assert g.queue.slots == 200


def test_slots_none_matches_run_all(uniform_jobs):
    """slots=None reproduces the port's run_all draw for draw."""
    _, jobs = uniform_jobs
    outs_c, r_c = run_cluster(Philox(0), jobs, P, slots=None, theta=1e-3,
                              device="cpu")
    outs_f, r_f = run_all(Philox(0), jobs, P, theta=1e-3, device="cpu")
    assert r_c == r_f
    for name, f in outs_f.items():
        c = outs_c[name]
        np.testing.assert_array_equal(c.r_opt.numpy(), f.r_opt.numpy())
        assert float(c.result.pocd) == pytest.approx(float(f.result.pocd),
                                                     abs=1e-6), name
        assert float(c.result.mean_cost) == pytest.approx(
            float(f.result.mean_cost), rel=1e-4), name
        assert float(c.queue.mean_wait) == 0.0


# ---------------------------------------------------------------------------
# 6. governor and admission
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slots,window,slack", [(50, 3600.0, 0.1),
                                                (500, 600.0, 1.0)])
def test_offered_load_and_admission_match_reference(slots, window, slack):
    ref = ref_uniform_jobset(200, 10, t_min=10.0, beta=2.0, D=50.0)
    ref = ref._replace(arrival=jnp.asarray(
        np.sort(np.random.default_rng(3).uniform(0, 7200, 200)),
        jnp.float32))
    jobs = port_jobs(ref)
    np.testing.assert_array_equal(offered_load(jobs, slots, window),
                                  ref_offered_load(ref, slots, window))
    np.testing.assert_array_equal(
        admit_jobs(jobs, slots, AdmissionConfig(slack=slack, window=window)),
        ref_admit_jobs(ref, slots, RefAdmission(slack=slack, window=window)))


def test_governor_lowers_r():
    jobs = repro_torch.sim.trace.uniform_jobset(300, 10, t_min=10.0,
                                                beta=2.0, D=50.0,
                                                device="cpu")
    gov = GovernorConfig(util_threshold=0.05, gain=50.0, window=600.0)
    base = run_cluster_strategy(Philox(0), jobs, "clone", P, slots=100,
                                theta=1e-4, device="cpu")
    throttled = run_cluster_strategy(Philox(0), jobs, "clone", P, slots=100,
                                     theta=1e-4, governor=gov, device="cpu")
    assert float(throttled.r_opt.float().mean()) < \
        float(base.r_opt.float().mean())


def test_admission_rejects_hopeless_jobs():
    jobs = repro_torch.sim.trace.uniform_jobset(200, 10, t_min=10.0,
                                                beta=2.0, D=50.0,
                                                device="cpu")
    admitted = admit_jobs(jobs, 50, AdmissionConfig(slack=0.1))
    assert 0 < admitted.sum() < jobs.n_jobs
    o = run_cluster_strategy(Philox(0), jobs, "hadoop_ns", P, slots=50,
                             admitted=admitted, device="cpu")
    assert float(o.queue.admitted_frac) == pytest.approx(admitted.mean(),
                                                         abs=1e-6)
    np.testing.assert_array_equal(o.result.job_cost.numpy()[~admitted], 0.0)
    assert not o.result.job_met.numpy()[~admitted].any()
    outs, _ = run_cluster(Philox(0), jobs, P, slots=50,
                          strategies=("hadoop_ns", "sresume"),
                          admission=AdmissionConfig(slack=0.1),
                          device="cpu")
    for o in outs.values():
        assert float(o.queue.admitted_frac) == pytest.approx(
            admitted.mean(), abs=1e-6)


# ---------------------------------------------------------------------------
# 7. interface
# ---------------------------------------------------------------------------


def test_interface_and_argument_checks(small_jobs):
    _, jobs = small_jobs
    outs, r_min = run_cluster(Philox(0), jobs, P, slots=200, theta=1e-3,
                              reps=2, collect_metrics=True, device="cpu")
    assert set(outs) == set(repro_torch.names())
    assert 0.0 <= r_min <= 1.0
    for o in outs.values():
        assert 0.0 <= float(o.result.pocd) <= 1.0
        assert 0.0 <= float(o.queue.utilization) <= 1.0 + 1e-6
        assert int(o.metrics.reps) == 2
        assert int(o.metrics.depth_hist.sum()) == int(o.metrics.n_dispatched)
        jm = o.result.job_met.numpy()
        assert ((jm >= 0.0) & (jm <= 1.0)).all()
    with pytest.raises(ValueError, match="passes"):
        run_cluster_strategy(Philox(0), jobs, "sresume", P, slots=100,
                             passes=1, device="cpu")
    with pytest.raises(ValueError, match="discipline"):
        run_cluster(Philox(0), jobs, P, slots=100, discipline="lifo",
                    device="cpu")
    with pytest.raises(TypeError):
        run_cluster(Philox(0), jobs, P, slots=100, chunk_jobs=50,
                    device="cpu")


def test_scenario_name_runs():
    outs, _ = run_cluster(Philox(0), "heavy-tail", P, slots=2000,
                          strategies=("hadoop_ns", "sresume"), device="cpu")
    for o in outs.values():
        assert 0.0 <= float(o.result.pocd) <= 1.0
        assert float(o.queue.mean_wait) >= 0.0


def test_budget_gives_run_strategy_r():
    """A binding budget (the midpoint of clone's band from its grids) on a
    small heterogeneous trace: the same r*, lam and spend as the flat
    run's joint solve."""
    jobs = repro_torch.generate(30, seed=4, device="cpu")
    U, E = utility_cost_grids(get("clone"), jobspecs_of(jobs, P, 1e-4), 9)
    cost = E * jobs.C[:, None]
    spend_free = float(torch.gather(cost, 1, U.argmax(1, keepdim=True)).sum())
    B = 0.5 * (float(cost.amin(dim=1).sum()) + spend_free)
    want = run_strategy(Philox(0), jobs, "clone", P, budget=B, device="cpu")
    got = run_cluster_strategy(Philox(0), jobs, "clone", P, slots=200,
                               budget=B, device="cpu")
    np.testing.assert_array_equal(got.r_opt.numpy(), want.r_opt.numpy())
    assert float(got.coupled.lam) == float(want.coupled.lam) > 0.0
    assert float(got.coupled.spend) == float(want.coupled.spend) <= B


@pytest.mark.parametrize("strategy", ["sresume", "hadoop_s"])
def test_tight_slots_monotone(small_jobs, strategy):
    """The reference's test_tight_slots_monotone on its own draws: fewer
    slots never give a better PoCD or a shorter queue."""
    _, jobs = small_jobs
    pocds, waits = [], []
    for slots in (40, 80, 160, 320, None):
        o = run_cluster_strategy(KeyReplay(KEY), jobs, strategy, P,
                                 slots=slots, theta=1e-3, max_r=8,
                                 device="cpu")
        pocds.append(float(o.result.pocd))
        waits.append(float(o.queue.mean_wait))
        assert 0.0 <= float(o.queue.utilization) <= 1.0 + 1e-6
        assert float(o.queue.max_wait) >= 0.0
    for lo, hi in zip(pocds, pocds[1:]):
        assert lo <= hi + 1e-6, (strategy, pocds)
    for hi_w, lo_w in zip(waits, waits[1:]):
        assert hi_w >= lo_w - 1e-6, (strategy, waits)


def test_default_device_is_the_card(small_jobs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    _, jobs = small_jobs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cluster(Philox(0), jobs, P, slots=100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_pool(4)


# ---------------------------------------------------------------------------
# 8. the kernel on the card
# ---------------------------------------------------------------------------


def _kernel_against_plain(slots, discipline, seed=0):
    release, hold, deadline, active = recursion_inputs(seed=seed)
    dev = torch.device("cuda")
    t = torch.from_numpy
    order = repro_torch.cluster.dispatch_key_order(
        discipline, t(release), t(deadline), inactive=~t(active))
    rel, h = t(release)[order], t(hold)[order]
    count = t(active).sum(dtype=torch.int32)
    free = torch.zeros(slots)
    want = ds.dispatch_scan_plain(rel, h, count, free)
    free_k = torch.zeros(slots, device=dev)
    got = ds.dispatch_scan_cuda(rel.to(dev), h.to(dev), count.to(dev),
                                free_k)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(free_k.cpu(), free)


@pytest.mark.cuda
@pytest.mark.parametrize("discipline", ["fifo", "edf"])
@pytest.mark.parametrize("slots", [1, 5, 37, 300, 20_000, 100_000])
def test_cuda_kernel_matches_plain_on_card(slots, discipline):
    """Bit-equal starts and final pools; 20,000 slots keep the pool in
    shared memory, 100,000 in device memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _kernel_against_plain(slots, discipline)
