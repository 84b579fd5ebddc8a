"""Port parity of the Monte-Carlo sims (`repro_torch.sim`) and of the
uniform sources.

The port draws through a uniform source (`repro_torch.sim.draws`). Here a
replay source hands it the uniforms that `jax.random` draws under the
reference's own keys, so each port sim sees the reference sim's numbers
and the two agree up to f32 rounding of the Pareto transform: per-task
times within rtol 1e-5, job_met equal except for jobs whose completion
lies within that tolerance of the deadline.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sim import SimParams as RefSimParams
from repro.sim import generate as ref_generate
from repro.sim import metrics as ref_metrics
from repro.sim import strategies as ref_sims
from repro.strategies import get as ref_get
from repro.strategies import index_of as ref_index_of
from repro.strategies import names as ref_names

from repro_torch import Philox, convert, generate
from repro_torch.sim import metrics
from repro_torch.sim import strategies as sims
from repro_torch.sim.draws import DRAW_NAMES, to_uniform
from repro_torch.strategies import get

RTOL = 1e-5


class JaxReplay:
    """Uniform source replaying the reference's draws: the key of
    (strategy, rep, name) is derived as the reference derives it,
    fold_in(key, index_of(strategy)) (sim/runner.py), then split(., reps)
    when reps > 1, then each sim's own split for "k1"/"k2"."""

    def __init__(self, key, reps: int = 1):
        self.key, self.reps = key, reps

    def key_of(self, strategy, rep, name):
        k = jax.random.fold_in(self.key, ref_index_of(strategy))
        if self.reps > 1:
            k = jax.random.split(k, self.reps)[rep]
        if name != "key":
            k = jax.random.split(k)[DRAW_NAMES.index(name) - 1]
        return k

    def uniform(self, strategy, rep, name, shape, device):
        u = jax.random.uniform(self.key_of(strategy, rep, name), tuple(shape),
                               minval=1e-7, maxval=1.0)
        return torch.from_numpy(np.array(u)).to(device)


def deadline_ties(completion, D, rtol=RTOL):
    return np.abs(np.asarray(completion) - np.asarray(D)) <= rtol * \
        np.asarray(D)


def assert_met_equal_but_ties(met, ref_met, completion, D):
    """job_met equal except where the completion ties with the deadline;
    returns the number of tie flips."""
    flips = np.asarray(met) != np.asarray(ref_met)
    assert not (flips & ~deadline_ties(completion, D)).any()
    return int(flips.sum())


@pytest.fixture(scope="module")
def both_jobs():
    ref = ref_generate(n_jobs=24, seed=5)
    port = convert.jobset(ref.n_jobs, {f: np.asarray(getattr(ref, f))
                                       for f in ref._fields[1:]},
                          device="cpu")
    return ref, port


CASES = [(s, True) for s in ref_names()] + \
    [(s, False) for s in ("srestart", "sresume", "adaptive")]


@pytest.mark.parametrize("strategy,oracle", CASES)
def test_sim_and_aggregate_match_reference(both_jobs, strategy, oracle):
    ref_jobs, jobs = both_jobs
    max_r = 5
    rng = np.random.default_rng(7)
    r_job = rng.integers(0, max_r + 1, jobs.n_jobs).astype(np.int32)
    choice_job = rng.integers(0, 3, jobs.n_jobs).astype(np.int32)
    job_id = jobs.job_id.numpy()
    key = jax.random.PRNGKey(3)
    ref_c, ref_m = ref_get(strategy).draw(
        jax.random.fold_in(key, ref_index_of(strategy)), ref_jobs,
        jnp.asarray(r_job[job_id]), jnp.asarray(choice_job[job_id]),
        RefSimParams(), max_r=max_r, oracle=oracle)
    source = JaxReplay(key)
    c, m = get(strategy).draw(
        lambda name, shape: source.uniform(strategy, 0, name, shape, "cpu"),
        jobs, torch.from_numpy(r_job[job_id]),
        torch.from_numpy(choice_job[job_id]),
        convert.simparams(RefSimParams()._asdict()), max_r=max_r,
        oracle=oracle)
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), rtol=RTOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), rtol=RTOL)

    got = metrics.aggregate(jobs, c, m)
    want = ref_metrics.aggregate(ref_jobs, ref_c, ref_m)
    n_flips = assert_met_equal_but_ties(got.job_met.numpy(), want.job_met,
                                        want.job_completion, ref_jobs.D)
    np.testing.assert_allclose(got.job_completion.numpy(),
                               np.asarray(want.job_completion), rtol=RTOL)
    np.testing.assert_allclose(got.job_cost.numpy(),
                               np.asarray(want.job_cost), rtol=RTOL)
    assert abs(float(got.pocd) - float(want.pocd)) <= \
        n_flips / jobs.n_jobs + 1e-7
    np.testing.assert_allclose(float(got.mean_cost), float(want.mean_cost),
                               rtol=RTOL)


def test_rank_among_job_matches_reference_with_ties():
    """Descending rank within each job; equal values go to the lower index,
    as the reference's stable lexsort and its serial scan oracle do."""
    rng = np.random.default_rng(8)
    job_id = np.sort(rng.integers(0, 9, 400)).astype(np.int32)
    values = rng.integers(0, 12, 400).astype(np.float32)   # many ties
    got = sims._rank_among_job(torch.from_numpy(values),
                               torch.from_numpy(job_id.astype(np.int64)), 9)
    want = ref_sims._rank_among_job(jnp.asarray(values), jnp.asarray(job_id),
                                    9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_sims._rank_among_job_scan(
            jnp.asarray(values), jnp.asarray(job_id), 9)))


def test_net_utility_matches_reference():
    pocd = np.asarray([0.0, 0.03, 0.5, 0.999, 1.0], np.float32)
    cost = np.asarray([9e3, 1.2e4, 8e3, 7.5e3, 0.0], np.float32)
    for r_min in (0.0, 0.029, 0.5):
        for p, c in zip(pocd, cost):
            got = metrics.net_utility(torch.tensor(p), torch.tensor(c),
                                      r_min, 1e-4)
            want = ref_metrics.net_utility(jnp.float32(p), jnp.float32(c),
                                           jnp.float32(r_min),
                                           jnp.float32(1e-4))
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_to_uniform_matches_jax_mapping():
    """The map from [0, 1) to [1e-7, 1) is jax.random.uniform's: an affine
    map in f32, then a max with minval."""
    u01 = np.asarray([0.0, 2.0**-24, 1e-7, 0.25, 0.5, 1.0 - 2.0**-24],
                     np.float32)
    lo = jnp.float32(1e-7)
    want = jnp.maximum(lo, jnp.asarray(u01) * (jnp.float32(1.0) - lo) + lo)
    got = to_uniform(torch.from_numpy(u01.copy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_philox_streams_are_keyed_by_strategy_rep_and_name():
    src = Philox(seed=0)
    u = src.uniform("clone", 0, "key", (4096,), "cpu")
    assert u.dtype == torch.float32
    assert float(u.min()) >= 1e-7 and float(u.max()) < 1.0
    assert torch.equal(u, Philox(seed=0).uniform("clone", 0, "key", (4096,),
                                                 "cpu"))
    others = [Philox(seed=1).uniform("clone", 0, "key", (4096,), "cpu"),
              src.uniform("clone_prop", 0, "key", (4096,), "cpu"),
              src.uniform("clone", 1, "key", (4096,), "cpu"),
              src.uniform("clone", 0, "k1", (4096,), "cpu")]
    for v in others:
        assert not torch.equal(u, v)


def test_generate_matches_reference_column_for_column():
    ref = ref_generate(n_jobs=50, seed=9)
    port = generate(50, seed=9, device="cpu")
    assert port.n_jobs == ref.n_jobs and port.total_tasks == ref.total_tasks
    for f in ref._fields[1:]:
        np.testing.assert_array_equal(
            getattr(port, f).numpy(),
            np.asarray(getattr(ref, f)).astype(getattr(port, f).numpy().dtype),
            err_msg=f)
