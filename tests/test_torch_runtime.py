"""Port parity of the rest of `repro.core` (Pareto model and fit,
estimator, multi-wave), the data pipeline and the runtime (telemetry,
StepGovernor, SpeculativeTaskRunner), on the CPU.

Both packages get the same numpy inputs. The closed forms and the fit
are f32 in both, within 1e-6 relative: the frameworks round the same f32
operations, but their pow, log and sums may differ in the last bit.
Multi-wave is the same float64 numpy, so it is compared exactly, and the
pipeline's batches come from the same numpy SeedSequence, bit for bit.
The runner tests keep the reference's scenarios (tests/test_runtime.py)
without its wall-clock bound, at shorter durations.
"""
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimator as r_est
from repro.core import multiwave as r_mw
from repro.core import pareto as r_par
from repro.core import JobSpec as RJobSpec
from repro.data import pipeline as r_pipe
from repro.runtime import GovernorConfig as RGovernorConfig
from repro.runtime import StepGovernor as RStepGovernor

from repro_torch.core import JobSpec, estimator, multiwave, pareto
from repro_torch.data import pipeline
from repro_torch.runtime import (GovernorConfig, SpeculativeTaskRunner,
                                 StepGovernor, Telemetry)
from repro_torch.runtime.governor import WARM_DECISIONS

RTOL = 1e-6


def close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0)


def t32(a):
    return torch.tensor(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# Pareto
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def grid():
    rng = np.random.default_rng(3)
    t_min = rng.uniform(0.5, 20.0, 64).astype(np.float32)
    beta = rng.uniform(1.05, 6.0, 64).astype(np.float32)
    t = (t_min * rng.uniform(0.5, 30.0, 64)).astype(np.float32)
    return t, t_min, beta


@pytest.mark.parametrize("name", ["pdf", "cdf", "sf", "log_sf"])
def test_pareto_functions(grid, name):
    t, t_min, beta = grid
    want = getattr(r_par, name)(t, t_min, beta)
    close(getattr(pareto, name)(t32(t), t32(t_min), t32(beta)), want)
    # Python numbers are f32, as the reference's jnp makes them
    close(getattr(pareto, name)(float(t[3]), float(t_min[3]),
                                float(beta[3])), want[3])


@pytest.mark.parametrize("name", ["mean", "min_of_n_mean",
                                  "truncated_mean_above",
                                  "truncated_mean_below", "quantile"])
def test_pareto_moments(grid, name):
    t, t_min, beta = grid
    third = {"mean": None, "min_of_n_mean": np.float32(3.0),
             "truncated_mean_above": t, "truncated_mean_below": t,
             "quantile": np.linspace(0.01, 0.99, 64, dtype=np.float32)}[name]
    if name == "mean":
        args, targs = (t_min, beta), (t32(t_min), t32(beta))
    elif name == "quantile":
        args, targs = (third, t_min, beta), (t32(third), t32(t_min),
                                             t32(beta))
    else:
        args = (t_min, beta, third)
        targs = (t32(t_min), t32(beta), t32(third))
    want = getattr(r_par, name)(*(jnp.asarray(a) for a in args))
    close(getattr(pareto, name)(*targs), want)


@pytest.mark.parametrize("masked", [False, True])
def test_fit_mle(masked):
    rng = np.random.default_rng(11)
    x = (2.5 * rng.uniform(size=300) ** (-1 / 2.2)).astype(np.float32)
    mask = rng.uniform(size=300) < 0.7 if masked else None
    want = r_par.fit_mle(x, None if mask is None else jnp.asarray(mask))
    got = pareto.fit_mle(t32(x), None if mask is None
                         else torch.from_numpy(mask))
    assert isinstance(got, pareto.ParetoParams)
    close(got.t_min, want.t_min)
    close(got.beta, want.beta)
    assert got.t_min.dtype == got.beta.dtype == torch.float32


def test_fit_mle_clips_beta():
    x = np.full(16, 3.0, np.float32)          # no spread: beta -> 20
    close(pareto.fit_mle(t32(x)).beta, r_par.fit_mle(x).beta)
    x = np.array([1.0, 1e6], np.float32)      # heavy: beta -> 1.01
    close(pareto.fit_mle(t32(x)).beta, r_par.fit_mle(x).beta)


def test_sample_on_replayed_uniforms():
    key = jax.random.PRNGKey(5)
    shape, t_min, beta = (4096,), 2.0, 1.7
    want = r_par.sample(key, t_min, beta, shape)
    # the reference's own uniforms, replayed through the port's transform
    u = jax.random.uniform(key, shape=shape,
                           minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)
    got = pareto.from_uniform(t32(u), torch.tensor(t_min),
                              torch.tensor(beta))
    close(got, want)
    g = torch.Generator().manual_seed(0)
    draws = pareto.sample(g, t_min, beta, (20000,))
    assert draws.dtype == torch.float32 and bool((draws >= t_min).all())
    # E[T] = t_min beta / (beta - 1) = 4.857; the tail is heavy (beta < 2)
    assert float(torch.median(draws)) == pytest.approx(
        t_min * 2 ** (1 / beta), rel=0.03)


# ---------------------------------------------------------------------------
# Estimator
# ---------------------------------------------------------------------------


def reports(n=64, seed=2):
    rng = np.random.default_rng(seed)
    t_lau = rng.uniform(0, 5, n).astype(np.float32)
    t_fp = (t_lau + rng.uniform(0.1, 3, n)).astype(np.float32)
    fp = rng.uniform(0.01, 0.3, n).astype(np.float32)
    t_now = (t_fp + rng.uniform(0.1, 10, n)).astype(np.float32)
    cp = np.minimum(fp + rng.uniform(0.0, 0.7, n), 1.0).astype(np.float32)
    return t_lau, t_fp, fp, t_now, cp


@pytest.mark.parametrize("name", ["estimate_completion_chronos",
                                  "estimate_completion_naive"])
def test_estimators(name):
    cols = reports()
    want = getattr(r_est, name)(r_est.ProgressReport(*map(jnp.asarray,
                                                          cols)))
    close(getattr(estimator, name)(estimator.ProgressReport(*map(t32,
                                                                  cols))),
          want)
    one = [float(c[7]) for c in cols]
    close(getattr(estimator, name)(estimator.ProgressReport(*one)),
          getattr(r_est, name)(r_est.ProgressReport(*one)))


def test_is_straggler_and_handoff_offset():
    cols = reports(seed=4)
    rep = r_est.ProgressReport(*map(jnp.asarray, cols))
    trep = estimator.ProgressReport(*map(t32, cols))
    for naive in (False, True):
        np.testing.assert_array_equal(
            estimator.is_straggler(trep, 9.0, naive=naive).numpy(),
            np.asarray(r_est.is_straggler(rep, 9.0, naive=naive)))
    rng = np.random.default_rng(6)
    b_start, b_est = (rng.uniform(0, 100, 64).astype(np.float32)
                      for _ in range(2))
    t_lau, t_fp, _, t_now, _ = cols
    want = r_est.handoff_offset(b_start, b_est, t_now, t_fp, t_lau)
    close(estimator.handoff_offset(t32(b_start), t32(b_est), t32(t_now),
                                   t32(t_fp), t32(t_lau)), want)
    # on Python floats, as the runner calls it
    args = (0.0, 7.0, 0.35, 0.12, 0.02)
    close(estimator.handoff_offset(*args), r_est.handoff_offset(*args))


# ---------------------------------------------------------------------------
# Multi-wave
# ---------------------------------------------------------------------------


def test_multiwave_exact():
    job = dict(t_min=10.0, beta=2.0, D=120.0, N=25, tau_est=3.0,
               tau_kill=8.0, phi_est=0.5, C=1.0, theta=1e-4, R_min=0.1)
    rjob = RJobSpec.make(**job)
    tjob = JobSpec.make(**job, device="cpu")
    for r in range(4):
        assert multiwave.multiwave_pocd(r, 10.0, 2.0, 120.0, 25, 10) == \
            r_mw.multiwave_pocd(r, 10.0, 2.0, 120.0, 25, 10)
        assert multiwave.multiwave_cost(r, 10.0, 2.0, 25, 8.0) == \
            r_mw.multiwave_cost(r, 10.0, 2.0, 25, 8.0)
        assert multiwave.multiwave_utility(r, tjob, 10) == \
            r_mw.multiwave_utility(r, rjob, 10)
    ts = np.linspace(0, 300, 257)
    np.testing.assert_array_equal(multiwave.wave_cdf(ts, 10.0, 2.0, 1, 7),
                                  r_mw.wave_cdf(ts, 10.0, 2.0, 1, 7))
    assert multiwave.solve_multiwave(tjob, 10) == \
        r_mw.solve_multiwave(rjob, 10)


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------


def test_pipeline_batches_bit_equal_with_seek():
    kw = dict(vocab_size=97, seq_len=12, global_batch=8, n_shards=4,
              seed=3, cycle=3)
    ref = r_pipe.DataPipeline(r_pipe.PipelineConfig(**kw))
    port = pipeline.DataPipeline(pipeline.PipelineConfig(**kw))
    try:
        for _ in range(5):
            (rs, rb), (ps, pb) = next(ref), next(port)
            assert rs == ps
            assert rb.keys() == pb.keys()
            for k in rb:
                assert rb[k].dtype == pb[k].dtype
                np.testing.assert_array_equal(rb[k], pb[k])
    finally:
        ref.close()
        port.close()
    assert not port._thread.is_alive()
    # a seek replays the stream from the step
    seek = pipeline.DataPipeline(pipeline.PipelineConfig(**kw),
                                 start_step=4)
    s, b = next(seek)
    seek.close()
    assert s == 4
    np.testing.assert_array_equal(
        b["tokens"], r_pipe.assemble(r_pipe.PipelineConfig(**kw), [
            r_pipe.make_shard(r_pipe.PipelineConfig(**kw), 4, i)
            for i in range(4)])["tokens"])


def test_pipeline_host_sharding_bit_equal():
    for rank in (0, 1):
        kw = dict(vocab_size=50, seq_len=4, global_batch=8, n_shards=2,
                  n_hosts=2, host_rank=rank)
        rcfg, pcfg = r_pipe.PipelineConfig(**kw), pipeline.PipelineConfig(**kw)
        want = r_pipe.assemble(rcfg, [r_pipe.make_shard(rcfg, 5, s)
                                      for s in range(2)])
        got = pipeline.assemble(pcfg, [pipeline.make_shard(pcfg, 5, s)
                                       for s in range(2)])
        assert got["tokens"].shape == (4, 4)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# Telemetry and StepGovernor
# ---------------------------------------------------------------------------


def test_telemetry_windows_counters_timer():
    tel = Telemetry()
    assert tel.window("a", capacity=3) is tel.window("a")
    for x in range(5):
        tel.window("a").record(x)
    assert tel.window("a").snapshot() == [2.0, 3.0, 4.0]
    tel.bump("n")
    tel.bump("n", by=4)
    assert tel.counters == {"n": 5}
    with tel.timer("t"):
        time.sleep(0.01)
    (secs,) = tel.window("t").snapshot()
    assert 0.005 < secs < 5.0


def test_telemetry_under_threads():
    """Counters and windows shared by the pipeline's producer thread and
    the trainer: no update may be lost under contention."""
    import threading
    tel = Telemetry()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(2000):
                tel.bump("n")
                tel.window("w", capacity=100_000).record(i)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert tel.counters["n"] == 16 * 2000
    assert len(tel.window("w")) == 16 * 2000


@pytest.mark.parametrize("deadline,seed", [(30.0, 1), (12.0, 2), (7.0, 3)])
def test_governor_matches_reference(deadline, seed):
    rng = np.random.default_rng(seed)
    obs = 5.0 * rng.uniform(size=256) ** (-1 / 2.0)
    cfg = dict(deadline=deadline, n_tasks=16, theta=1e-3)
    ref = RStepGovernor(RGovernorConfig(**cfg))
    port = StepGovernor(GovernorConfig(**cfg), device="cpu")
    # cold: r = 0 / sresume, no solve
    assert port.decide() == ref.decide()
    assert port.telemetry.counters == {}
    for x in obs:
        ref.observe(x)
        port.observe(x)
    close(port.fit(), ref.fit())
    rs, ps = ref.jobspec(), port.jobspec()
    for f in RJobSpec._fields:
        close(getattr(ps, f), getattr(rs, f))
    want, got = ref.decide(), port.decide()
    assert (got.strategy, got.r_opt) == (want.strategy, want.r_opt)
    close([got.utility, got.pocd, got.cost],
          [want.utility, want.pocd, want.cost], rtol=1e-5)
    assert port.telemetry.counters == {WARM_DECISIONS: 1}
    np.testing.assert_array_equal(port.backup_mask(8, 2, {3, 7}),
                                  ref.backup_mask(8, 2, {3, 7}))


def test_governor_below_floor_is_cold():
    port = StepGovernor(GovernorConfig(deadline=1.0, n_tasks=4),
                        device="cpu")
    for _ in range(8):
        port.observe(2.0)
    assert port.jobspec() is None
    assert port.decide().r_opt == 0


# ---------------------------------------------------------------------------
# SpeculativeTaskRunner (the reference's scenarios, tests/test_runtime.py)
# ---------------------------------------------------------------------------


def _make_task(durations, work_units=20, seen=None):
    """Sleeps durations[idx] in work_units increments, reporting progress;
    a resumed attempt skips the units already done. `seen` collects the
    (idx, resume_from) of every attempt."""
    def task(idx, board, resume_from):
        if seen is not None:
            seen.append((idx, resume_from))
        total = durations[idx]
        for u in range(int(resume_from), work_units):
            if board.cancelled:
                return None
            time.sleep(total / work_units)
            board.report((u + 1) / work_units, offset=float(u + 1))
        return ("ok", idx)
    return task


def test_clone_strategy_races_attempts():
    seen = []
    runner = SpeculativeTaskRunner(max_workers=24)
    res = runner.run(_make_task([0.05] * 6, seen=seen), 6, strategy="clone",
                     r=1, deadline=5.0, tau_est=0.1, tau_kill=0.3)
    assert all(r.value == ("ok", r.index) for r in res)
    assert all(r.attempts >= 1 for r in res)
    assert sorted(i for i, _ in seen) == sorted(list(range(6)) * 2)


def test_srestart_speculates_on_straggler():
    seen = []
    runner = SpeculativeTaskRunner(max_workers=16)
    res = runner.run(_make_task([0.02, 0.02, 0.6, 0.02], seen=seen), 4,
                     strategy="srestart", r=1, deadline=0.3, tau_est=0.15,
                     tau_kill=0.25)
    assert all(r.value == ("ok", r.index) for r in res)
    assert res[2].speculated and not res[0].speculated
    # S-Restart relaunches from scratch
    assert [rf for i, rf in seen if i == 2] == [0.0, 0.0]


def test_sresume_hands_off_offset():
    seen = []
    runner = SpeculativeTaskRunner(max_workers=16)
    res = runner.run(_make_task([0.02, 0.8, 0.02, 0.02], seen=seen), 4,
                     strategy="sresume", r=1, deadline=0.4, tau_est=0.3,
                     tau_kill=0.45)
    assert all(r.value == ("ok", r.index) for r in res)
    assert res[1].speculated
    resumed = [rf for i, rf in seen if i == 1][1:]
    # r + 1 attempts resume past the original's progress at tau_est (about
    # 7 of 20 units), plus the Eq. 31 startup allowance
    assert len(resumed) == 2 and resumed[0] == resumed[1]
    assert 3.0 <= resumed[0] < 20.0


def test_failed_task_is_relaunched():
    calls = {"n": 0}

    def flaky(idx, board, resume_from):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom")
        board.report(1.0)
        return "recovered"

    runner = SpeculativeTaskRunner(max_workers=4)
    res = runner.run(flaky, 1, strategy="srestart", r=0, deadline=10.0,
                     tau_est=0.05, tau_kill=0.1)
    assert res[0].value == "recovered"
    assert calls["n"] >= 2


# ---------------------------------------------------------------------------
# Imports
# ---------------------------------------------------------------------------


def test_training_imports_load_no_jax():
    code = ("import sys; import repro_torch.train, repro_torch.runtime, "
            "repro_torch.launch.train, repro_torch.data; "
            "from repro_torch.runtime import StepGovernor; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "raise SystemExit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
