"""Port parity: the closed forms of `repro_torch.core` (paper Thms 1-6),
the Pareto moments and the competitive allocation policies against the
JAX reference on the same random inputs, made with numpy from a seed.

Tolerances are the reference kernel tests' (tests/test_grid_solve.py):
utility rtol 1e-4 / atol 1e-5, PoCD rtol 1e-5 / atol 1e-7, cost rtol 1e-4
/ atol 1e-5. The two frameworks round transcendentals differently in the
last f32 bits, so floats are compared within these, never bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost as ref_cost
from repro.core import pareto as ref_pareto
from repro.core import pocd as ref_pocd
from repro.core.utility import JobSpec as RefJobSpec
from repro.core.utility import cost_of as ref_cost_of
from repro.core.utility import pocd_of as ref_pocd_of
from repro.core.utility import utility as ref_utility
from repro.strategies import competitive as ref_competitive
from repro.strategies import names as ref_names

from repro_torch import convert
from repro_torch.core import cost as port_cost
from repro_torch.core import pareto as port_pareto
from repro_torch.core import pocd as port_pocd
from repro_torch.core.utility import cost_of, pocd_of, utility
from repro_torch.strategies import competitive

OPTIMIZED = ref_names(kind="optimized")


def random_columns(J: int, seed: int) -> dict:
    """JobSpec columns spanning the trace's regimes, deadlines tight and
    loose (tight ones put D - tau_est below t_min, the clamped branches)."""
    rng = np.random.default_rng(seed)
    t_min = rng.uniform(8.0, 15.0, J)
    beta = rng.uniform(1.1, 2.0, J)
    D = rng.uniform(1.05, 3.0, J) * t_min * beta / (beta - 1.0)
    D[: J // 8] = rng.uniform(1.05, 1.25, J // 8) * t_min[: J // 8]
    tau_est = 0.3 * t_min
    return {"t_min": t_min, "beta": beta, "D": D,
            "N": rng.integers(10, 5000, J).astype(np.float64),
            "tau_est": tau_est, "tau_kill": tau_est + 0.5 * t_min,
            "phi_est": np.full(J, 0.25), "C": rng.uniform(0.5, 2.0, J),
            "theta": rng.uniform(1e-5, 1e-3, J),
            "R_min": rng.uniform(0.0, 0.6, J)}


def both_specs(J: int, seed: int, as_column: bool):
    cols = {k: np.asarray(v, np.float32) for k, v in
            random_columns(J, seed).items()}
    port = convert.jobspec(cols, device="cpu")
    ref = RefJobSpec(**{k: jnp.asarray(v) for k, v in cols.items()})
    if as_column:
        port = type(port)(*(x[:, None] for x in port))
        ref = RefJobSpec(*(x[:, None] for x in ref))
    return port, ref


R_GRID = np.arange(12, dtype=np.float32)[None, :]


@pytest.mark.parametrize("strategy", OPTIMIZED)
def test_closed_forms_match_reference(strategy):
    port, ref = both_specs(96, seed=11, as_column=True)
    r_t, r_j = torch.from_numpy(R_GRID), jnp.asarray(R_GRID)
    np.testing.assert_allclose(
        pocd_of(strategy, r_t, port).numpy(),
        np.asarray(ref_pocd_of(strategy, r_j, ref)), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        cost_of(strategy, r_t, port).numpy(),
        np.asarray(ref_cost_of(strategy, r_j, ref)), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        utility(strategy, r_t, port).numpy(),
        np.asarray(ref_utility(strategy, r_j, ref)), rtol=1e-4, atol=1e-5)


def test_log_task_fail_forms_match_reference():
    port, ref = both_specs(96, seed=12, as_column=True)
    r_t, r_j = torch.from_numpy(R_GRID), jnp.asarray(R_GRID)
    pairs = [
        (port_pocd.log_task_fail_clone(r_t, port.t_min, port.beta, port.D),
         ref_pocd.log_task_fail_clone(r_j, ref.t_min, ref.beta, ref.D)),
        (port_pocd.log_task_fail_srestart(r_t, port.t_min, port.beta,
                                          port.D, port.tau_est),
         ref_pocd.log_task_fail_srestart(r_j, ref.t_min, ref.beta, ref.D,
                                         ref.tau_est)),
        (port_pocd.log_task_fail_sresume(r_t, port.t_min, port.beta, port.D,
                                         port.tau_est, port.phi_est),
         ref_pocd.log_task_fail_sresume(r_j, ref.t_min, ref.beta, ref.D,
                                        ref.tau_est, ref.phi_est)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_job_pocd_keeps_reference_f32_clip():
    """The reference clips P_fail at 1.0 - 1e-12, which is 1.0f: a certain
    task failure gives R == 0 exactly, and tiny failures keep full f32
    resolution."""
    lf = np.asarray([0.0, 1.0, -1e-30, -1e-8, -2.0, -80.0], np.float32)
    N = np.asarray([1.0, 10.0, 100.0, 5000.0, 37.0, 1e4], np.float32)
    got = port_pocd._job_pocd_from_log_fail(torch.from_numpy(lf),
                                            torch.from_numpy(N)).numpy()
    want = np.asarray(ref_pocd._job_pocd_from_log_fail(jnp.asarray(lf),
                                                       jnp.asarray(N)))
    assert got[0] == want[0] == 0.0 and got[1] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_quadrature_constants_equal_reference():
    np.testing.assert_array_equal(port_cost.GL_U.numpy(),
                                  np.asarray(ref_cost._GL_U))
    np.testing.assert_array_equal(port_cost.GL_W.numpy(),
                                  np.asarray(ref_cost._GL_W))


def test_pareto_moments_match_reference():
    rng = np.random.default_rng(13)
    t_min = rng.uniform(5.0, 15.0, 64).astype(np.float32)
    beta = rng.uniform(1.05, 3.0, 64).astype(np.float32)
    beta[:4] = 1.0                          # the beta == 1 limit
    D = (t_min * rng.uniform(1.1, 5.0, 64)).astype(np.float32)
    tt = [torch.from_numpy(x) for x in (t_min, beta, D)]
    jj = [jnp.asarray(x) for x in (t_min, beta, D)]
    np.testing.assert_allclose(
        port_pareto.truncated_mean_below(*tt).numpy(),
        np.asarray(ref_pareto.truncated_mean_below(*jj)), rtol=1e-5)
    np.testing.assert_allclose(
        port_pareto.mean(*tt[:2]).numpy()[4:],
        np.asarray(ref_pareto.mean(*jj[:2]))[4:], rtol=1e-6)
    np.testing.assert_allclose(
        port_pareto.quantile(0.95, *tt[:2]).numpy(),
        np.asarray(ref_pareto.quantile(0.95, *jj[:2])), rtol=1e-5)


@pytest.mark.parametrize("policy", ["allocate_proportional", "allocate_sjf"])
def test_competitive_allocations_match_reference(policy):
    """Same (J, r_max) utility and priced-cost grids -> same r per job."""
    port, ref = both_specs(80, seed=14, as_column=False)
    rng = np.random.default_rng(15)
    U = rng.normal(size=(80, 9)).astype(np.float32)
    cost = rng.uniform(1e3, 1e5, (80, 9)).astype(np.float32)
    budget = np.float32(0.6 * cost.min(axis=1).sum() + 0.4 * cost.sum() / 9)
    got = getattr(competitive, policy)(port, torch.from_numpy(U),
                                       torch.from_numpy(cost), float(budget))
    want = getattr(ref_competitive, policy)(ref, jnp.asarray(U),
                                            jnp.asarray(cost), budget)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
