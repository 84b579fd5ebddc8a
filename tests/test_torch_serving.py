"""Port parity of hedged online serving (`repro_torch.serve`,
`repro_torch.obs.tail`, `sim.metrics.request_result` /
`latency_summary`).

Draws are the reference's `jax.random` draws replayed into the port
(`ServeReplay`): a request's key is fold_in(fold_in(key, index_of(stream)),
rid), the key `run_serve` gives a strategy's stream and the fold
`serve_window` gives a request, then each sim's own split for "k1"/"k2";
the reference's 1-request JobSet draws (1, ...), and its row 0 is the
request's.

What is held, and how tightly:
* r* and the adaptive choice of every known-tail solve and of every
  online epoch's solve (each side at its own fit) equal, except near-ties:
  lanes whose reference U at the two levels agree within rtol 1e-5,
  counted and printed;
* completion and machine time within f32 rtol 1e-5 (the CPU's pow may
  differ by an ulp), except at the counted near-ties; job_met equal but
  deadline ties; latency_summary within rtol 1e-5;
* n_probes, n_refits and epoch_strategies equal; every fit within rtol
  1e-5 (t_min, beta, beta_hill) with n and k equal;
* port-only properties of tests/test_serve.py on `Philox`, bit for bit:
  window invariance, subset reproduction, online hadoop_ns = known-tail,
  streamed = monolithic, the cadence error, every registered strategy,
  the r_override baseline, `HedgedScheduler.execute` against the stream.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import tail as ref_tail
from repro.serve import make_requests as ref_make_requests
from repro.serve import run_serve as ref_run_serve
from repro.serve import loop as ref_loop
from repro.sim import metrics as ref_metrics
from repro.sim.strategies import SimParams as RefSimParams
from repro.strategies import get as ref_get
from repro.strategies import index_of as ref_index_of
from repro.strategies.spec import utility_of as ref_utility_of

from repro_torch import Philox, SimParams, names
from repro_torch.fleet import fleet_mesh
from repro_torch.obs import tail
from repro_torch.serve import (HedgedScheduler, ReplicaPool, Request,
                               RequestTrace, run_serve, serve_trace,
                               uniform_requests)
from repro_torch.serve import loop
from repro_torch.sim import metrics
from repro_torch.sim.draws import DRAW_NAMES, SERVE_TAG
from repro_torch.sim.metrics import StreamCombiner

KEY = jax.random.PRNGKey(11)
P = SimParams()
REF_P = RefSimParams()
RTOL = 1e-5
N_REQ = 600
KNOWN = ("hadoop_ns", "sresume", "hedge", "adaptive")
ONLINE = ("hadoop_ns", "sresume", "adaptive", "auto")
ONLINE_KW = dict(window=256, refit_every=200, probe_every=10)


@functools.partial(jax.jit, static_argnames=("name", "rest"))
def _replay_draw(base, rids, *, name: int, rest: tuple):
    def one(rid):
        k = jax.random.fold_in(base, rid)
        if name:
            k = jax.random.split(k)[name - 1]
        return jax.random.uniform(k, (1,) + rest, minval=1e-7,
                                  maxval=1.0)[0]
    return jax.vmap(one)(rids)


class ServeReplay:
    """Replays the reference's serving draws (see the module doc)."""

    def __init__(self, key):
        self.key = key

    def uniform_rows(self, strategy, rep, name, cells, rows, rest, device,
                     tag=SERVE_TAG):
        assert tag == SERVE_TAG and rep == 0 and rows == 0
        base = jax.random.fold_in(self.key, ref_index_of(strategy))
        u = _replay_draw(base, jnp.asarray(cells.cpu().numpy(), jnp.int32),
                         name=DRAW_NAMES.index(name), rest=tuple(rest))
        return torch.from_numpy(np.array(u)).to(device)


def port_requests(ref):
    return RequestTrace(*(np.asarray(c) for c in ref[:-1]),
                        class_names=ref.class_names)


def cols(out):
    r = out.result
    return tuple(np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
                 for x in (r.job_met, r.job_completion, r.job_cost))


def same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(cols(a), cols(b)))


@pytest.fixture(scope="module")
def reqs():
    ref = ref_make_requests("request-storm", n_requests=N_REQ, seed=0)
    return ref, port_requests(ref)


@pytest.fixture(scope="module")
def known(reqs):
    ref_reqs, port_reqs = reqs
    want, ref_r_min = ref_run_serve(KEY, ref_reqs, strategies=KNOWN,
                                    window=256)
    got, r_min = run_serve(ServeReplay(KEY), port_reqs, strategies=KNOWN,
                           window=256, device="cpu")
    return want, ref_r_min, got, r_min


@pytest.fixture(scope="module")
def online(reqs):
    ref_reqs, port_reqs = reqs
    want, ref_r_min = ref_run_serve(KEY, ref_reqs, strategies=ONLINE,
                                    **ONLINE_KW)
    got, r_min = run_serve(ServeReplay(KEY), port_reqs, strategies=ONLINE,
                           device="cpu", **ONLINE_KW)
    return want, ref_r_min, got, r_min


def solve_flips(strategy, ref_fit, port_fit, ref_reqs, port_reqs, r_min,
                width):
    """(r, choice) of one epoch solve, each side at its own tail belief;
    asserts every difference is a near-tie of the reference's own U and
    returns the lanes that differ."""
    rr, rc = ref_loop._solve_epoch(strategy, *ref_fit, ref_reqs, REF_P,
                                   1e-3, r_min, 8, width)
    dev = port_reqs.to("cpu")
    pf = tuple(torch.from_numpy(np.asarray(x, np.float32))
               if isinstance(x, np.ndarray) else x for x in port_fit)
    pr, pc = loop._solve_epoch(strategy, *pf, dev, P, 1e-3, r_min, 8, width)
    pr, pc = pr.numpy(), pc.numpy()
    flips = (pr != rr) | (pc != rc)
    if flips.any():
        specs = ref_loop._epoch_jobspecs(*ref_fit, ref_reqs, REF_P, 1e-3,
                                         r_min, width)
        U = np.asarray(jax.vmap(lambda job: ref_utility_of(
            ref_get(strategy), jnp.arange(9, dtype=jnp.float32), job))(
                specs))[:len(rr)]
        i = np.flatnonzero(flips)
        a, b = U[i, rr[i]], U[i, pr[i]]
        assert np.all(np.abs(a - b) <= RTOL * np.abs(a)), (strategy, i)
        print(f"{strategy}: {i.size} r* near-tie flip(s) at {i.tolist()}")
    return flips


def assert_outcomes_close(got, want, D, skip):
    """completion and machine within rtol 1e-5 but at `skip`; met equal
    but deadline ties (and `skip`)."""
    met, comp, cost = cols(got)
    wmet, wcomp, wcost = cols(want)
    keep = ~skip
    np.testing.assert_allclose(comp[keep], wcomp[keep], rtol=RTOL)
    np.testing.assert_allclose(cost[keep], wcost[keep], rtol=RTOL)
    ties = np.abs(wcomp - D) <= RTOL * D
    assert not ((met != wmet) & keep & ~ties).any()
    return int(((met != wmet) & keep).sum())


def assert_latency_close(got, want):
    for k in ("p50", "p95", "p99", "mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


# ---------------------------------------------------------------------------
# 1. parity with the reference on replayed draws
# ---------------------------------------------------------------------------


def test_run_serve_known_tail_matches_reference(reqs, known):
    """run_serve (known tail: one solve at each request's own tail):
    r_min, r* per request, outcomes, latency and utilities."""
    ref_reqs, port_reqs = reqs
    want, ref_r_min, got, r_min = known
    assert set(got) == set(want)
    D = np.asarray(port_reqs.D)
    ties = assert_outcomes_close(got["hadoop_ns"], want["hadoop_ns"], D,
                                 np.zeros(N_REQ, bool))
    assert abs(r_min - ref_r_min) <= ties / N_REQ + 1e-7
    for name in KNOWN:
        flips = np.zeros(N_REQ, bool)
        if ref_get(name).optimized:
            flips = solve_flips(name, (ref_reqs.t_min, ref_reqs.beta),
                                (port_reqs.t_min, port_reqs.beta), ref_reqs,
                                port_reqs, ref_r_min, N_REQ)
        n_ties = assert_outcomes_close(got[name], want[name], D, flips)
        print(f"{name}: {int(flips.sum())} r* flips, {n_ties} deadline "
              f"ties")
        assert_latency_close(got[name].latency, want[name].latency)
        if not flips.any():
            assert got[name].mean_r == pytest.approx(want[name].mean_r,
                                                     rel=1e-12)
            if not n_ties:
                np.testing.assert_allclose(got[name].utility,
                                           want[name].utility, rtol=1e-4,
                                           atol=1e-5)
        assert got[name].n_probes == want[name].n_probes == 0
        assert got[name].epoch_strategies == want[name].epoch_strategies


def test_serve_trace_online_matches_reference(reqs, online):
    """run_serve online (epochs of 200, a probe every 10th rid): probes,
    refits, epoch strategies, fits, each epoch's r* at each side's own fit,
    outcomes and latency."""
    ref_reqs, port_reqs = reqs
    want, ref_r_min, got, r_min = online
    D = np.asarray(port_reqs.D)
    for name in ONLINE:
        g, w = got[name], want[name]
        assert (g.n_probes, g.n_refits) == (w.n_probes, w.n_refits), name
        assert g.epoch_strategies == w.epoch_strategies, name
        assert g.n_refits >= 2
        for fg, fw in zip(g.fits, w.fits):
            np.testing.assert_allclose(
                [fg.t_min, fg.beta, fg.beta_hill],
                [fw.t_min, fw.beta, fw.beta_hill], rtol=RTOL)
            assert (fg.n, fg.k) == (fw.n, fw.k)
        flips = np.zeros(N_REQ, bool)
        for e, strat in enumerate(w.epoch_strategies):
            lo, hi = e * 200, min(e * 200 + 200, N_REQ)
            if strat == "hadoop_ns" or not ref_get(strat).optimized:
                continue
            fw, fg = w.fits[e - 1], g.fits[e - 1]
            f = solve_flips(strat, (fw.t_min, fw.beta), (fg.t_min, fg.beta),
                            ref_reqs.slice(lo, hi), port_reqs.slice(lo, hi),
                            ref_r_min if name != "hadoop_ns" else 0.0, 200)
            flips[lo:hi] = f & (np.asarray(port_reqs.rid[lo:hi]) % 10 != 0)
        n_ties = assert_outcomes_close(g, w, D, flips)
        print(f"online {name}: {int(flips.sum())} r* flips, {n_ties} "
              f"deadline ties, epochs {g.epoch_strategies}")
        assert_latency_close(g.latency, w.latency)
        if not flips.any():
            assert g.mean_r == pytest.approx(w.mean_r, rel=1e-12)


def test_tail_window_and_governor_match_reference():
    """TailWindow.fit on the same samples gives the reference's fit
    exactly (the same float64 numpy); the governor's decision matches,
    its U within the grid solve's tolerances."""
    xs = 0.2 * (1.0 - np.random.default_rng(3).random(300)) ** (-1 / 1.4)
    got = tail.TailGovernor(deadline=0.6, n_tasks=1, theta=1e-3,
                            cadence=50, min_samples=16, device="cpu")
    want = ref_tail.TailGovernor(deadline=0.6, n_tasks=1, theta=1e-3,
                                 cadence=50, min_samples=16)
    for x in xs:
        a, b = got.observe(float(x)), want.observe(float(x))
        assert (a is None) == (b is None)
        if a is not None:
            assert got.last_fit == want.last_fit
            assert (a.strategy, a.r_opt) == (b.strategy, b.r_opt)
            # U as the grid solve holds it (tests/test_grid_solve.py's
            # kernel tolerances): U here is a difference near 0
            np.testing.assert_allclose(a.utility, b.utility, rtol=1e-4,
                                       atol=1e-5)
    win = tail.TailWindow(capacity=64)
    for x in xs[:10]:
        win.observe(float(x))
    assert win.quantile(0.9) == float(np.quantile(xs[:10], 0.9))
    with pytest.raises(ValueError, match="capacity"):
        tail.DurationWindow(capacity=0)


def test_request_result_and_latency_summary_match_reference(reqs):
    ref_reqs, port_reqs = reqs
    rng = np.random.default_rng(1)
    comp = (0.3 * rng.random(N_REQ) + 0.1).astype(np.float32)
    mach = (0.4 * rng.random(N_REQ) + 0.1).astype(np.float32)
    want = ref_metrics.request_result(ref_reqs, comp, mach)
    got = metrics.request_result(port_reqs, torch.from_numpy(comp),
                                 torch.from_numpy(mach))
    for f in ("job_met", "job_completion", "job_cost"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert float(got.pocd) == float(want.pocd)
    np.testing.assert_allclose(float(got.mean_cost), float(want.mean_cost),
                               rtol=RTOL)
    assert metrics.latency_summary(got) == ref_metrics.latency_summary(want)


# ---------------------------------------------------------------------------
# 2. the port's own properties, on Philox
# ---------------------------------------------------------------------------


def serve(reqs, **kw):
    return serve_trace(Philox(0), reqs, device="cpu", **kw)


def test_window_size_invariance_bitwise(reqs):
    _, port_reqs = reqs
    a = serve(port_reqs, strategy="clone", window=64)
    for w in (96, 256, 1024):
        assert same(a, serve(port_reqs, strategy="clone", window=w)), w


def test_subset_of_stream_reproduces_outcomes(reqs):
    _, port_reqs = reqs
    full = serve(port_reqs.slice(0, 256), strategy="srestart", window=64)
    part = serve(port_reqs.slice(96, 160), strategy="srestart", window=64)
    for x, y in zip(cols(part), cols(full)):
        assert np.array_equal(x, y[96:160])


def test_online_hadoop_ns_equals_known_tail_bitwise(reqs):
    _, port_reqs = reqs
    on = serve(port_reqs, strategy="hadoop_ns", window=64, refit_every=128,
               probe_every=8)
    off = serve(port_reqs, strategy="hadoop_ns", window=64)
    assert same(on, off)
    assert on.n_probes == N_REQ // 8 and on.n_refits >= 1


def test_streamed_equals_monolithic_via_combiner(reqs):
    _, port_reqs = reqs
    sub = port_reqs.slice(0, 200)
    mono = serve(sub, strategy="clone", window=256)
    acc = StreamCombiner()
    for lo in range(0, 200, 50):
        part = serve(sub.slice(lo, lo + 50), strategy="clone", window=256,
                     combiner=acc)
    assert acc.n_chunks == 4
    assert same(part, mono)


def test_refit_cadence_must_align_with_probes():
    reqs = uniform_requests(64, t_min=1.0, beta=1.5, D=4.0)
    with pytest.raises(ValueError, match="multiple of"):
        serve(reqs, refit_every=100, probe_every=8)


def test_every_registered_strategy_serves_via_registry():
    reqs = uniform_requests(48, t_min=1.0, beta=1.4, D=4.0)
    outs, _ = run_serve(Philox(0), reqs, window=64, strategies=names(),
                        device="cpu")
    assert set(outs) == set(names())
    for name, out in outs.items():
        assert np.isfinite(float(out.result.pocd)), name
        assert np.isfinite(float(out.result.mean_cost)), name


def test_fixed_r_override_baseline():
    reqs = uniform_requests(128, t_min=1.0, beta=1.3, D=4.0)
    out = serve(reqs, strategy="clone", window=64, r_override=2)
    assert out.mean_r == pytest.approx(2.0)
    base = serve(reqs, strategy="hadoop_ns", window=64)
    assert float(out.result.pocd) > float(base.result.pocd)
    with pytest.raises(ValueError, match="auto"):
        serve(reqs, strategy="auto", window=64, r_override=2)


def test_scheduler_execute_consistent_with_stream():
    """execute is deterministic and equals the stream's outcome of the
    same rid served at the plan's (strategy, r) under the scheduler's
    stream; run_workload serves the scheduler's strategy."""
    pool = ReplicaPool(n_replicas=8, beta=1.5)
    sched = HedgedScheduler(pool, theta=1e-2, strategy="adaptive",
                            source=Philox(3), device="cpu")
    req = Request(deadline=0.5, rid=17, n_tokens=64)
    o1, o2 = sched.execute(req), sched.execute(req)
    assert o1 == o2
    trace = sched._trace_of([req])
    out = serve_trace(Philox(3), trace, sched.p, strategy=o1.strategy,
                      r_override=o1.r, stream="adaptive", theta=1e-2,
                      device="cpu")
    assert float(out.result.job_completion[0]) == o1.latency
    assert float(out.result.job_cost[0]) == o1.machine_time
    res = sched.run_workload([req, Request(deadline=0.6, rid=18)])
    assert res["output"].result.job_met.shape == (2,)


def test_one_card_mesh_only(reqs, monkeypatch):
    """A one-point mesh and a two-point host mesh serve the bits of no
    mesh; two points with one visible card raise."""
    _, port_reqs = reqs
    sub = port_reqs.slice(0, 64)
    a = serve(sub, strategy="sresume", window=64,
              mesh=fleet_mesh(devices=1, device="cpu"))
    assert same(a, serve(sub, strategy="sresume", window=64))
    b = serve(sub, strategy="sresume", window=64,
              mesh=fleet_mesh(devices=2, device="cpu"))
    assert same(a, b)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 are visible"):
        run_serve(Philox(0), sub, strategies=("hadoop_ns",), devices=2)
