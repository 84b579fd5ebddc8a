"""Port parity of the workload subsystem (`repro_torch.workloads`), of
`class_summary` and `uniform_jobset`, and of `run_all` by scenario name.

The port draws workload variates through a source (`sim.draws`). Here a
replay source hands it the variates `jax.random` draws under the
reference's own key splits, so the port's transforms (gathers, the
lognormal counts, the Pareto parameters, the arrival processes, the sort)
see the reference's numbers: integer columns must be equal, floats within
rtol 1e-6, arrivals within rtol 1e-5 (the running sums add in another
order), and the arrival order equal. On the port's own Philox draws the
statistics are held at the reference tests' tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sim import SimParams as RefSimParams
from repro.sim import run_strategy as ref_run_strategy
from repro.sim import uniform_jobset as ref_uniform_jobset
from repro.sim.metrics import class_summary as ref_class_summary
from repro.workloads import generators as ref_gen
from repro.workloads import make_trace as ref_make_trace
from repro.workloads import save_trace as ref_save_trace
from repro.workloads import to_jobset as ref_to_jobset

from repro_torch import Philox, SimParams, convert, names, run_all
from repro_torch.sim import SimResult
from repro_torch.sim.draws import WorkloadPhilox
from repro_torch.sim.metrics import class_summary
from repro_torch.sim.strategies import _pareto
from repro_torch.sim.trace import uniform_jobset
from repro_torch.workloads import (ARRIVAL_PROCESSES, PAPER_TRACE_STATS,
                                   JobClass, batch_poisson_arrivals,
                                   diurnal_arrivals, get_scenario,
                                   hill_estimator, list_scenarios, load_trace,
                                   make_jobset, make_trace, poisson_arrivals,
                                   sample_arrivals, sample_classes,
                                   sample_pareto_params, sample_task_counts,
                                   summarize, synthesize, to_jobset)

KEY = jax.random.PRNGKey(0)
RTOL, ARRIVAL_RTOL = 1e-6, 1e-5

MIX_CLASSES = (
    JobClass(name="a", weight=0.6, mean_tasks=50.0, sigma_tasks=0.8,
             t_min_range=(8.0, 12.0), beta_range=(1.5, 1.5),
             deadline_ratio=2.0),
    JobClass(name="b", weight=0.3, mean_tasks=200.0, sigma_tasks=1.0,
             t_min_range=(8.0, 12.0), beta_range=(1.5, 1.5),
             deadline_ratio=2.0),
    JobClass(name="c", weight=0.1, mean_tasks=800.0, sigma_tasks=1.2,
             t_min_range=(8.0, 12.0), beta_range=(1.5, 1.5),
             deadline_ratio=2.0),
)
# a mixture with free beta, prices and theta scales, for the replays
TIER_CLASSES = get_scenario("multi-tenant-sla").classes

# (process, kwargs) at a long-run rate of 0.05 jobs/s
ARRIVALS = (("poisson", {}), ("batch", {"mean_batch": 20.0}),
            ("diurnal", {"amplitude": 0.9, "period": 3600.0}),
            ("mmpp", {"phase_shape": (20.0, 1.0), "mean_dwell": 2000.0}))


class JaxWorkloadReplay:
    """Workload source returning `jax.random`'s own variates, each draw
    name under the key the reference uses for it."""

    def __init__(self, keys: dict):
        self.keys = keys

    @staticmethod
    def arrival_keys(key) -> dict:
        """An arrival process's key, and the halves of its split."""
        first, second = jax.random.split(key)
        return {"arrival": key, "arrival.new_batch": first,
                "arrival.gap": second, "arrival.dwell": first,
                "arrival.unit": second}

    @classmethod
    def for_trace(cls, seed: int):
        """The splits of `synthesize`: PRNGKey(seed) into (mix, counts,
        Pareto parameters, arrivals), the parameter key in two."""
        k_mix, k_cnt, k_par, k_arr = jax.random.split(
            jax.random.PRNGKey(seed), 4)
        k_t, k_b = jax.random.split(k_par)
        return cls({"classes": k_mix, "task_counts": k_cnt, "t_min": k_t,
                    "beta": k_b, **cls.arrival_keys(k_arr)})

    @staticmethod
    def _out(x, device):
        return torch.from_numpy(np.array(x)).to(device)

    def categorical(self, name, logits, shape):
        x = jax.random.categorical(self.keys[name],
                                   jnp.asarray(logits.cpu().numpy()),
                                   shape=tuple(shape))
        return self._out(x.astype(jnp.int32), logits.device)

    def normal(self, name, shape, device):
        return self._out(jax.random.normal(self.keys[name], tuple(shape)),
                         device)

    def uniform(self, name, shape, device):
        return self._out(jax.random.uniform(self.keys[name], tuple(shape)),
                         device)

    def exponential(self, name, shape, device):
        return self._out(jax.random.exponential(self.keys[name],
                                                tuple(shape)), device)

    def bernoulli(self, name, p, shape, device):
        return self._out(jax.random.bernoulli(self.keys[name], p,
                                              tuple(shape)), device)


def ref_classes(classes):
    return np.asarray(ref_gen.sample_classes(KEY, 300, classes))


# ---------------------------------------------------------------------------
# samplers and arrival processes on replayed variates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("classes", [MIX_CLASSES, TIER_CLASSES],
                         ids=["mix", "tiers"])
def test_class_samplers_match_reference(classes):
    want_cls = ref_gen.sample_classes(KEY, 300, classes)
    cls = sample_classes(JaxWorkloadReplay({"classes": KEY}), 300, classes,
                         device="cpu")
    np.testing.assert_array_equal(cls.numpy(), np.asarray(want_cls))
    assert cls.dtype == torch.int32

    k_cnt = jax.random.fold_in(KEY, 1)
    counts = sample_task_counts(JaxWorkloadReplay({"task_counts": k_cnt}),
                                cls, classes)
    np.testing.assert_array_equal(
        counts.numpy(),
        np.asarray(ref_gen.sample_task_counts(k_cnt, want_cls, classes)))

    k_par = jax.random.fold_in(KEY, 2)
    k_t, k_b = jax.random.split(k_par)
    got = sample_pareto_params(JaxWorkloadReplay({"t_min": k_t, "beta": k_b}),
                               cls, classes)
    want = ref_gen.sample_pareto_params(k_par, want_cls, classes)
    for name, g, w in zip(("t_min", "beta", "D"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("process,kw", ARRIVALS,
                         ids=[a for a, _ in ARRIVALS])
def test_arrival_processes_match_reference(process, kw):
    key = jax.random.fold_in(KEY, 7)
    want = np.asarray(ref_gen.sample_arrivals(key, 300, process, 0.05, **kw))
    got = sample_arrivals(JaxWorkloadReplay(
        JaxWorkloadReplay.arrival_keys(key)), 300, process, 0.05,
        device="cpu", **kw).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=ARRIVAL_RTOL)
    np.testing.assert_array_equal(np.argsort(got, kind="stable"),
                                  np.argsort(want, kind="stable"))
    if process == "batch":
        # the crowds are exact ties in both, of the same sizes
        np.testing.assert_array_equal(np.unique(got, return_counts=True)[1],
                                      np.unique(want, return_counts=True)[1])


def test_mmpp_burstiness_matches_reference_live():
    """The reference's own burstiness bound fails under this jax (its
    test_mmpp_arrivals_are_bursty); the port is held to the reference's
    live output on the same draws instead: the gap CV agrees."""
    key = jax.random.fold_in(KEY, 8)
    kw = {"phase_shape": (20.0, 1.0), "mean_dwell": 2000.0}
    want = np.asarray(ref_gen.mmpp_arrivals(key, 4000, 0.105, **kw))
    got = sample_arrivals(JaxWorkloadReplay(
        JaxWorkloadReplay.arrival_keys(key)), 4000, "mmpp", 0.105,
        device="cpu", **kw).numpy()
    cv = lambda a: np.diff(a).std() / np.diff(a).mean()
    assert cv(got) == pytest.approx(cv(want), rel=1e-3)
    assert len(got) / got[-1] == pytest.approx(len(want) / want[-1],
                                               rel=1e-5)


def test_hill_estimator_matches_reference():
    x = np.random.default_rng(0).pareto(1.5, 500).astype(np.float32) + 1.0
    got = float(hill_estimator(torch.from_numpy(x), k=50))
    want = float(ref_gen.hill_estimator(jnp.asarray(x), k=50))
    assert got == pytest.approx(want, rel=RTOL)
    with pytest.raises(ValueError, match="0 < k < n_samples"):
        hill_estimator(torch.from_numpy(x), k=500)


# ---------------------------------------------------------------------------
# traces: synthesize for every scenario, .npz files, to_jobset
# ---------------------------------------------------------------------------


def assert_traces_match(got, want):
    for col in ("n_tasks", "job_class"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col),
                                      err_msg=col)
    for col in ("t_min", "beta", "D", "C", "theta_scale"):
        np.testing.assert_allclose(getattr(got, col), getattr(want, col),
                                   rtol=RTOL, err_msg=col)
    np.testing.assert_allclose(got.arrival, want.arrival, rtol=ARRIVAL_RTOL)
    for col in got._fields[:-1]:
        assert getattr(got, col).dtype == getattr(want, col).dtype, col
    assert got.class_names == want.class_names


@pytest.mark.parametrize("name", sorted(list_scenarios()))
def test_synthesize_every_scenario_matches_reference(name):
    s = get_scenario(name)
    n = min(s.n_jobs, 300)
    want = ref_make_trace(name, n_jobs=n)
    got = synthesize(s.classes, n, seed=s.seed, arrival=s.arrival,
                     hours=s.hours, arrival_kw=s.arrival_kw,
                     source=JaxWorkloadReplay.for_trace(s.seed),
                     device="cpu")
    assert_traces_match(got, want)


def test_reference_trace_file_loads_into_the_same_columns(tmp_path):
    want = ref_make_trace("multi-tenant-sla", n_jobs=200)
    ref_save_trace(want, tmp_path / "trace.npz")
    got = load_trace(tmp_path / "trace.npz")
    for col in want._fields[:-1]:
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
    assert got.class_names == want.class_names
    jobs, ref_jobs = to_jobset(got, device="cpu"), ref_to_jobset(want)
    assert jobs.n_jobs == ref_jobs.n_jobs
    for f in ref_jobs._fields[1:]:
        np.testing.assert_array_equal(getattr(jobs, f).numpy(),
                                      np.asarray(getattr(ref_jobs, f)),
                                      err_msg=f)


def test_port_trace_roundtrip_and_layout(tmp_path):
    from repro_torch.workloads import save_trace
    tr = make_trace("heavy-tail", n_jobs=150, device="cpu")
    save_trace(tr, tmp_path / "t.npz")
    tr2 = load_trace(tmp_path / "t.npz")
    for col in tr._fields[:-1]:
        np.testing.assert_array_equal(getattr(tr, col), getattr(tr2, col))
    jobs = to_jobset(tr, device="cpu")
    assert jobs.total_tasks == tr.total_tasks
    counts = np.bincount(jobs.job_id.numpy(), minlength=jobs.n_jobs)
    np.testing.assert_array_equal(counts, tr.n_tasks)
    assert np.all(np.diff(tr.arrival) >= 0)
    with pytest.raises(KeyError, match="unknown scenario"):
        get_scenario("nope")


# ---------------------------------------------------------------------------
# statistics on the port's own Philox draws (the reference tests' bounds)
# ---------------------------------------------------------------------------


def test_class_mix_matches_weights():
    cls = sample_classes(WorkloadPhilox(0), 6000, MIX_CLASSES,
                         device="cpu").numpy()
    for i, c in enumerate(MIX_CLASSES):
        assert (cls == i).mean() == pytest.approx(c.weight, abs=0.03)


def test_poisson_arrival_rate():
    arr = poisson_arrivals(WorkloadPhilox(0), 4000, 0.05,
                           device="cpu").numpy()
    assert np.all(np.diff(arr) >= 0)
    assert len(arr) / arr[-1] == pytest.approx(0.05, rel=0.1)


def test_batch_arrivals_form_crowds_at_target_rate():
    arr = batch_poisson_arrivals(WorkloadPhilox(0), 4000, 0.05, 20.0,
                                 device="cpu").numpy()
    _, counts = np.unique(arr, return_counts=True)
    assert counts.max() > 5
    assert counts.mean() == pytest.approx(20.0, rel=0.3)
    assert len(arr) / arr[-1] == pytest.approx(0.05, rel=0.2)


def test_diurnal_arrivals_modulate_rate():
    period = 3600.0
    arr = diurnal_arrivals(WorkloadPhilox(0), 6000, 0.05, amplitude=0.9,
                           period=period, device="cpu").numpy()
    assert np.all(np.diff(arr) >= 0)
    assert len(arr) / arr[-1] == pytest.approx(0.05, rel=0.15)
    phase = (arr % period) / period
    peak = ((phase > 0.1) & (phase < 0.4)).sum()
    trough = ((phase > 0.6) & (phase < 0.9)).sum()
    assert peak > 2.0 * trough


def test_pareto_tail_index_recovered():
    tr = synthesize(MIX_CLASSES, n_jobs=2000, seed=3, device="cpu")
    t_min = torch.from_numpy(tr.t_min)
    gen = torch.Generator().manual_seed(0)
    u = torch.rand(t_min.shape, generator=gen).clamp_(min=1e-7)
    draws = _pareto(u, t_min, torch.from_numpy(tr.beta))
    alpha = float(hill_estimator(draws / t_min, k=200))
    assert alpha == pytest.approx(1.5, rel=0.15)


def test_paper_hadoop_calibration():
    s = summarize(make_trace("paper-hadoop", n_jobs=2000, device="cpu"))
    assert s["mean_tasks"] == pytest.approx(
        PAPER_TRACE_STATS["mean_tasks"], rel=0.25)
    lo, hi = PAPER_TRACE_STATS["beta_range"]
    assert lo <= s["beta_range"][0] and s["beta_range"][1] <= hi
    assert s["hours"] == pytest.approx(PAPER_TRACE_STATS["hours"], rel=0.25)


def test_scenarios_resolve_and_repeat():
    assert set(list_scenarios()) == {
        "paper-hadoop", "heavy-tail", "diurnal-burst", "multi-tenant-sla",
        "flash-crowd", "pod-loss-flash-crowd", "request-storm"}
    assert set(ARRIVAL_PROCESSES) == {"poisson", "batch", "diurnal", "mmpp"}
    for name in list_scenarios():
        a = make_jobset(name, n_jobs=30, device="cpu")
        b = make_jobset(name, n_jobs=30, device="cpu")
        assert a.n_jobs == 30
        for f in a._fields[1:]:
            assert torch.equal(getattr(a, f), getattr(b, f)), (name, f)


# ---------------------------------------------------------------------------
# metrics, uniform_jobset, run_all by name
# ---------------------------------------------------------------------------


def test_class_summary_matches_reference():
    ref_jobs = ref_to_jobset(ref_make_trace("multi-tenant-sla", n_jobs=90))
    want_out = ref_run_strategy(KEY, ref_jobs, "sresume", RefSimParams(),
                                theta=1e-4, reps=3)
    jobs = convert.jobset(ref_jobs.n_jobs, {
        f: np.asarray(getattr(ref_jobs, f)) for f in ref_jobs._fields[1:]},
        device="cpu")
    res = SimResult(*(torch.from_numpy(np.array(x))
                      for x in want_out.result))
    got, want = class_summary(jobs, res), ref_class_summary(ref_jobs,
                                                            want_out.result)
    assert got == want and len(got) == 3


def test_uniform_jobset_matches_reference():
    want = ref_uniform_jobset(20, 7, t_min=10.0, beta=2.0, D=50.0, C=0.5)
    got = uniform_jobset(20, 7, t_min=10.0, beta=2.0, D=50.0, C=0.5,
                         device="cpu")
    assert got.n_jobs == want.n_jobs
    for f in want._fields[1:]:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_run_all_accepts_a_scenario_name():
    """By name, run_all resolves the scenario at its default size on the
    run's device and gives the bits of the same run on its JobSet."""
    by_name, r_min = run_all(Philox(0), "multi-tenant-sla", SimParams(),
                             device="cpu")
    jobs = make_jobset("multi-tenant-sla", device="cpu")
    by_set, r_min2 = run_all(Philox(0), jobs, SimParams(), device="cpu")
    assert list(by_name) == list(names()) and r_min == r_min2
    for name, o in by_name.items():
        assert o.result.job_met.shape == (jobs.n_jobs,)
        assert 0.0 <= float(o.result.pocd) <= 1.0
        assert torch.equal(o.result.job_cost, by_set[name].result.job_cost)
        assert torch.equal(o.r_opt, by_set[name].r_opt)
        assert o.coupled is None
    # the gold tier (cheap speculation) gets a larger r* than bronze
    cls = jobs.job_class.numpy()
    r = by_name["sresume"].r_opt.numpy()
    assert r[cls == 0].mean() > r[cls == 2].mean()
