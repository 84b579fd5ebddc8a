"""Port parity of the paper's Algorithm 1 (`repro_torch.core.optimizer.
solve_algorithm1`): gradient ascent with backtracking above the Thm-8
threshold, exhaustive search below it, with `torch.autograd` in place of
`jax.grad`. Same jobs, near-tie rule and tolerances as
test_torch_optimizer.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import optimizer as ref_opt
from repro.core.utility import utility as ref_utility

from repro_torch.core import optimizer, solve_algorithm1

from test_torch_optimizer import PAPER, assert_solution, jobs, trace_cols  # noqa: F401


@pytest.mark.parametrize("strategy", PAPER)
def test_solve_algorithm1_matches_reference_and_grid(jobs, strategy):
    """The paper's solver: against the reference's own on the quickstart
    job and the first trace job (the reference runs it op by op, seconds
    per job), and on every job against the reference's grid solve, whose
    r* it must reach (Theorem 9)."""
    for k, (ref_job, job) in enumerate(jobs):
        got = solve_algorithm1(strategy, job, device="cpu")
        if k < 2:
            assert_solution(got, ref_opt.solve_algorithm1(strategy, ref_job),
                            ref_job, f"job {k}")
        assert_solution(got, ref_opt.solve_grid(strategy, ref_job), ref_job,
                        f"job {k}, algorithm 1 against the grid")


@pytest.mark.parametrize("strategy", PAPER)
def test_utility_gradient_matches_reference(jobs, strategy):
    """dU/dr by torch.autograd: finite exactly where jax.grad's is, and
    then close (rtol 1e-4: a derivative of f32 closed forms)."""
    ref_du = jax.grad(lambda r, job: ref_utility(strategy, r, job))
    for k, (ref_job, job) in enumerate(jobs):
        for r in (0.0, 0.5, 1.0, 2.25, 4.0):
            got = optimizer.utility_grad(strategy, r, job)
            want = float(ref_du(jnp.float32(r), ref_job))
            assert np.isfinite(got) == np.isfinite(want), (k, r, got, want)
            if np.isfinite(want):
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
