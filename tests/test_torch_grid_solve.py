"""Port parity of the Algorithm-1 grid solve (`repro_torch.kernels.
grid_solve`).

On the CPU the wrapper runs the plain PyTorch version; it is held against
the reference's Pallas kernel (interpret mode, as tests/test_grid_solve.py
runs it here) and its XLA path, on the reference's own inputs converted to
the port's tensors: r*, choice and sat equal, floats within the reference
kernel tests' tolerances. The CUDA kernel itself is held against the plain
version by the `cuda`-marked test, which skips without a card, and by
chip_smoke.py on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sim import SimParams as RefSimParams
from repro.sim import generate as ref_generate
from repro.sim.runner import jobspecs_of as ref_jobspecs_of
from repro.strategies import names as ref_names
from repro.strategies import solve_jobs_jit as ref_solve_jobs
from repro.workloads import make_jobset

from repro_torch import SimParams, convert, generate
from repro_torch.kernels import grid_solve as gs
from repro_torch.sim.runner import jobspecs_of
from repro_torch.strategies import get, solve_jobs

OPTIMIZED = ref_names(kind="optimized")
FLOATS = {2: (1e-4, 1e-5), 3: (1e-5, 1e-7), 4: (1e-4, 1e-5)}


def port_specs(ref_specs):
    return convert.jobspec({f: np.asarray(getattr(ref_specs, f))
                            for f in ref_specs._fields}, device="cpu")


def assert_solves_equal(got, want):
    got = [x.numpy() for x in got]
    want = [np.asarray(x) for x in want]
    for i in (0, 1, 5):                         # r*, choice, sat
        np.testing.assert_array_equal(got[i], want[i])
        assert got[i].dtype == np.int32
    for i, (rtol, atol) in FLOATS.items():      # utility, pocd, cost
        np.testing.assert_allclose(got[i], want[i], rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def paper_specs():
    return {n: ref_jobspecs_of(make_jobset("paper-hadoop", n_jobs=n,
                                           seed=2),
                               RefSimParams(), jnp.float32(1e-4),
                               jnp.float32(0.0))
            for n in (37, 64)}


@pytest.mark.parametrize("strategy", OPTIMIZED)
@pytest.mark.parametrize("n_jobs,r_max", [(37, 9), (64, 33)])
def test_plain_matches_reference_pallas_and_xla(paper_specs, strategy,
                                                n_jobs, r_max):
    """J=37 is a ragged tile for every tile size; (64, 33) a wider grid."""
    ref = paper_specs[n_jobs]
    got = solve_jobs(strategy, port_specs(ref), r_max, device="cpu")
    assert_solves_equal(got, ref_solve_jobs(strategy, ref, r_max,
                                            backend="pallas"))
    assert_solves_equal(got, ref_solve_jobs(strategy, ref, r_max,
                                            backend="xla"))


def test_saturation_and_all_infeasible_rows_match_reference():
    """A too-small grid pins r* to its last point (sat marks exactly those
    jobs), and an unreachable SLA floor makes every U -inf, where the first
    argmax is r* = 0 with U = -inf."""
    ref = ref_jobspecs_of(ref_generate(n_jobs=40, seed=1), RefSimParams(),
                          jnp.float32(1e-4), jnp.float32(0.0))
    ref = ref._replace(R_min=ref.R_min.at[:7].set(1.0))
    got = solve_jobs("adaptive", port_specs(ref), 2, device="cpu")
    assert_solves_equal(got, ref_solve_jobs("adaptive", ref, 2,
                                            backend="xla"))
    for strategy, r_max in (("adaptive", 2), ("sresume", 2),
                            ("srestart", 9)):
        got = solve_jobs(strategy, port_specs(ref), r_max, device="cpu")
        r, u, sat = got[0].numpy(), got[2].numpy(), got[5].numpy()
        assert (r[:7] == 0).all() and np.isneginf(u[:7]).all()
        np.testing.assert_array_equal(sat, (r == r_max - 1).astype(np.int32))
        assert (sat.sum() > 0) == (r_max == 2), strategy


def test_wrapper_uses_plain_version_for_cpu_tensors():
    job = jobspecs_of(generate(30, seed=4, device="cpu"), SimParams(), 1e-4,
                      0.03)
    before = gs.launches
    got = gs.grid_solve(get("adaptive"), job, 9)
    want = gs.grid_solve_plain(get("adaptive"), job, 9)
    assert gs.launches == before           # no kernel launch on the CPU
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrapper_raises_on_devices_without_a_kernel():
    job = jobspecs_of(generate(8, seed=4, device="cpu"), SimParams(), 1e-4)
    meta = type(job)(*(x.to("meta") for x in job))
    with pytest.raises(ValueError, match="no kernel"):
        gs.grid_solve(get("clone"), meta, 9)


def test_forms_mask_orders_composite_choice_ids():
    assert gs.forms_mask(get("clone")) == 0b001
    assert gs.forms_mask(get("clone_sjf")) == 0b001
    assert gs.forms_mask(get("srestart")) == 0b010
    assert gs.forms_mask(get("sresume")) == 0b100
    assert gs.forms_mask(get("adaptive")) == 0b111


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", OPTIMIZED)
def test_cuda_kernel_matches_plain_on_card(strategy):
    """The CUDA kernel against its plain version, on the card, at a ragged
    job count and a grid wider than one warp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    job = jobspecs_of(generate(101, seed=6, device="cuda"), SimParams(),
                      1e-4, 0.03)
    before = gs.launches
    got = gs.grid_solve(get(strategy), job, 40)
    want = gs.grid_solve_plain(get(strategy), job, 40)
    torch.cuda.synchronize()
    assert gs.launches == before + 1
    for i in (0, 1, 5):
        assert torch.equal(got[i], want[i])
    for i, (rtol, atol) in FLOATS.items():
        torch.testing.assert_close(got[i], want[i], rtol=rtol, atol=atol)
