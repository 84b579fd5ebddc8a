"""Port parity of the quickstart path: `JobSpec.make`, the Thm 1/3/5 PoCD
forms, the Thm-8 thresholds, the Algorithm-1 solvers, the Theorem 7
orderings, and the whole path (solve, then the Monte-Carlo cross-check)
against the JAX reference on the same inputs.

`solve_algorithm1` and its gradient are held in test_torch_algorithm1.py.

Jobs: the quickstart's job and the first 16 jobs of the reference's
`jobspecs_of(generate(64, seed=0))`, converted to the port's tensors.
r* is equal, except at a near-tie, where the two r's utilities under the
reference differ by at most 1e-5 |U| (the frameworks round log/exp in the
last f32 bit differently; ROADMAP.md section C shows such ties inside the
reference itself); each near-tie is printed. Floats are within rtol 1e-5,
Monte-Carlo met exact and cost within rtol 2e-5 (the reference kernel
tests' tolerance).

The training optimizer's streamed Adafactor update
(`repro_torch.train.Adafactor` with a forced slice size) is held here
too: against its own unsliced update, every statistic bit for bit, and
against the reference's `Adafactor`, statistics and parameters within
1e-6 (XLA and torch add a row's mean in other orders: ~1e-7 relative).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import JobSpec as RefJobSpec
from repro.train import optimizer as ref_train_opt
from repro.core import gamma as ref_gamma
from repro.core import pocd as ref_pocd
from repro.core import optimizer as ref_opt
from repro.core import theory as ref_theory
from repro.core.utility import utility as ref_utility
from repro.kernels import ops as ref_ops
from repro.sim import SimParams as RefSimParams
from repro.sim import generate as ref_generate
from repro.sim.runner import jobspecs_of as ref_jobspecs_of
from repro.strategies import names as ref_names

from repro_torch import convert
from repro_torch.core import (JobSpec, gamma, pocd_clone,
                              pocd_srestart, pocd_sresume, r_upper_bound,
                              solve, solve_algorithm1, solve_batch,
                              solve_grid, theory)
from repro_torch.core.utility import utility
from repro_torch.ckpt.checkpoint import tree_leaves_with_paths
from repro_torch.kernels import ops
from repro_torch.train import Adafactor
from repro_torch.train.optimizer import leaf_slices

from test_torch_pocd_mc import assert_mc_equal, near_deadline

QUICKSTART = dict(t_min=10.0, beta=2.0, D=50.0, N=10, tau_est=3.0,
                  tau_kill=8.0, phi_est=0.25, C=1.0, theta=1e-3, R_min=0.0)
PAPER = ("clone", "srestart", "sresume")      # the strategies with a gamma
OPTIMIZED = ref_names(kind="optimized")
FIELDS = RefJobSpec._fields
N_TRACE = 16


@pytest.fixture(scope="module")
def trace_cols():
    ref = ref_jobspecs_of(ref_generate(n_jobs=64, seed=0), RefSimParams(),
                          jnp.float32(1e-4), jnp.float32(0.0))
    return {f: np.array(getattr(ref, f))[:N_TRACE] for f in FIELDS}


@pytest.fixture(scope="module")
def jobs(trace_cols):
    """[(reference JobSpec, port JobSpec)] of 0-dim fields: the quickstart
    job, then the trace's."""
    pairs = [(RefJobSpec.make(**QUICKSTART),
              JobSpec.make(**QUICKSTART, device="cpu"))]
    for i in range(N_TRACE):
        col = {f: trace_cols[f][i] for f in FIELDS}
        pairs.append((RefJobSpec(*(jnp.asarray(col[f]) for f in FIELDS)),
                      convert.jobspec(col, device="cpu")))
    return pairs


def same_r(strategy, ref_job, r_port, r_ref, where):
    """True if r* is equal; at a near-tie the reference's utilities at the
    two r's agree within 1e-5 |U|, the tie is printed, and False is
    returned (the floats at r* are then not comparable)."""
    if r_port == r_ref:
        return True
    u_p, u_r = (float(ref_utility(strategy, jnp.float32(r), ref_job))
                for r in (r_port, r_ref))
    assert abs(u_p - u_r) <= 1e-5 * abs(u_r), (strategy, where, r_port,
                                               r_ref, u_p, u_r)
    print(f"near-tie {strategy} {where}: port r*={r_port} U={u_p}, "
          f"reference r*={r_ref} U={u_r}")
    return False


def assert_solution(got, want, ref_job, where):
    assert got.strategy == want.strategy
    if same_r(got.strategy, ref_job, got.r_opt, int(want.r_opt), where):
        np.testing.assert_allclose(
            [got.utility, got.pocd, got.cost],
            [float(want.utility), float(want.pocd), float(want.cost)],
            rtol=1e-5)


def test_jobspec_make_defaults():
    """tau_est = 0.3 t_min, tau_kill = tau_est + 0.5 t_min in f32, phi 0.5,
    C 1, theta 1e-4, R_min 0: bit for bit the reference's."""
    for kw in (dict(t_min=10.0, beta=2.0, D=50.0, N=10),
               dict(t_min=12.7, beta=1.37, D=61.3, N=338), QUICKSTART):
        got = JobSpec.make(**kw, device="cpu")
        want = RefJobSpec.make(**kw)
        for f in FIELDS:
            g = getattr(got, f)
            assert g.dtype == torch.float32 and g.shape == ()
            assert g.item() == float(getattr(want, f)), f
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            JobSpec.make(10.0, 2.0, 50.0, 10)


@pytest.mark.parametrize("r", [0, 1, 2, 5])
def test_pocd_closed_forms_match_reference(trace_cols, r):
    t = {f: torch.from_numpy(trace_cols[f]) for f in FIELDS}
    j = {f: jnp.asarray(trace_cols[f]) for f in FIELDS}
    pairs = [
        (pocd_clone(r, t["t_min"], t["beta"], t["D"], t["N"]),
         ref_pocd.pocd_clone(r, j["t_min"], j["beta"], j["D"], j["N"])),
        (pocd_srestart(r, t["t_min"], t["beta"], t["D"], t["N"],
                       t["tau_est"]),
         ref_pocd.pocd_srestart(r, j["t_min"], j["beta"], j["D"], j["N"],
                                j["tau_est"])),
        (pocd_sresume(r, t["t_min"], t["beta"], t["D"], t["N"],
                      t["tau_est"], t["phi_est"]),
         ref_pocd.pocd_sresume(r, j["t_min"], j["beta"], j["D"], j["N"],
                               j["tau_est"], j["phi_est"])),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("strategy", PAPER)
def test_gamma_and_grid_bound_match_reference(jobs, strategy):
    for k, (ref_job, job) in enumerate(jobs):
        np.testing.assert_allclose(float(gamma(strategy, job)),
                                   float(ref_gamma(strategy, ref_job)),
                                   rtol=1e-5)
        u0 = float(ref_utility(strategy, jnp.float32(0.0), ref_job))
        assert r_upper_bound(strategy, job, u0) == \
            ref_opt.r_upper_bound(strategy, ref_job, u0), k


@pytest.mark.parametrize("strategy", OPTIMIZED)
def test_solve_grid_matches_reference(jobs, strategy):
    """Certified r_max (r_max=None) and a fixed grid."""
    for k, (ref_job, job) in enumerate(jobs):
        for r_max in (None, 9):
            assert_solution(solve_grid(strategy, job, r_max, device="cpu"),
                            ref_opt.solve_grid(strategy, ref_job, r_max),
                            ref_job, f"job {k} r_max {r_max}")


def test_solve_matches_reference(jobs):
    for k, (ref_job, job) in enumerate(jobs):
        got, want = solve(job, device="cpu"), ref_opt.solve(ref_job)
        if got.strategy != want.strategy:   # a near-tie across strategies
            assert abs(got.utility - want.utility) <= \
                1e-5 * abs(want.utility), (k, got, want)
            print(f"near-tie in solve, job {k}: port {got}, reference "
                  f"{want}")
            continue
        assert_solution(got, want, ref_job, f"job {k}")


@pytest.mark.parametrize("strategy", OPTIMIZED)
def test_solve_batch_matches_reference(trace_cols, strategy):
    job = convert.jobspec(trace_cols, device="cpu")
    ref_job = RefJobSpec(*(jnp.asarray(trace_cols[f]) for f in FIELDS))
    r, u, p, c = solve_batch(strategy, job, 64, device="cpu")
    want = ref_opt.solve_batch(strategy, ref_job, 64)
    ties = [k for k in range(N_TRACE)
            if not same_r(strategy, ref_job._replace(
                **{f: getattr(ref_job, f)[k] for f in FIELDS}),
                int(r[k]), int(want[0][k]), f"batch job {k}")]
    keep = np.setdiff1d(np.arange(N_TRACE), ties)
    assert r.dtype == torch.int32
    for got, w in zip((u, p, c), want[1:]):
        np.testing.assert_allclose(got.numpy()[keep], np.asarray(w)[keep],
                                   rtol=1e-5)


def test_solve_batch_warns_on_saturation_as_reference(trace_cols):
    """A grid too small for r* warns with the saturated count."""
    job = convert.jobspec(trace_cols, device="cpu")
    ref_job = RefJobSpec(*(jnp.asarray(trace_cols[f]) for f in FIELDS))
    with pytest.warns(RuntimeWarning, match="saturated") as got:
        solve_batch("clone", job, 2, device="cpu")
    with pytest.warns(RuntimeWarning, match="saturated") as want:
        ref_opt.solve_batch("clone", ref_job, 2)
    assert str(got[0].message) == str(want[0].message)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        solve_batch("clone", job, 64, device="cpu")


@pytest.mark.parametrize("r", [0, 1, 2, 3])
def test_theory_orderings_match_reference(jobs, r):
    for k, (ref_job, job) in enumerate(jobs):
        for name in ("clone_beats_srestart", "sresume_beats_srestart",
                     "clone_beats_sresume"):
            assert bool(getattr(theory, name)(job, r)) == \
                bool(getattr(ref_theory, name)(ref_job, r)), (k, name)
        np.testing.assert_allclose(
            float(theory.clone_vs_sresume_threshold(job)),
            float(ref_theory.clone_vs_sresume_threshold(ref_job)),
            rtol=1e-5)


def test_quickstart_path_matches_reference():
    """examples/quickstart.py through both packages at (J, N, R) =
    (256, 10, 4): r* per strategy from both solvers, then the Monte-Carlo
    cross-check of clone and sresume and the fused sweep on one set of
    numpy uniforms."""
    J, N, R = 256, 10, 4
    ref_job = RefJobSpec.make(**QUICKSTART)
    job = JobSpec.make(**QUICKSTART, device="cpu")
    r_star = {}
    for s in PAPER:
        got = solve_grid(s, job, device="cpu")
        assert_solution(got, ref_opt.solve_grid(s, ref_job), ref_job, s)
        assert solve_algorithm1(s, job, device="cpu").r_opt == got.r_opt
        r_star[s] = got.r_opt
    u = np.random.default_rng(0).uniform(1e-7, 1.0, (J, N, R)).astype(
        np.float32)
    cols = [np.full(J, v, np.float32) for v in (10.0, 2.0, 50.0)]
    t_in = [torch.from_numpy(x) for x in (u, *cols)]
    j_in = [jnp.asarray(x) for x in (u, *cols)]
    rm = np.stack([np.full(J, r_star[s], np.int32) for s in ops.MODES])
    for m, s in enumerate(ops.MODES):
        got = ops.pocd_mc(*t_in, torch.from_numpy(rm[m]), mode=s)
        want = ref_ops.pocd_mc(*j_in, jnp.asarray(rm[m]), mode=s)
        near = near_deadline(*t_in, torch.from_numpy(rm[m]), s)
        assert_mc_equal(got, want, near)
        assert not near.any()
    got = ops.pocd_mc_all(*t_in, torch.from_numpy(rm))
    want = ref_ops.pocd_mc_all(*j_in, jnp.asarray(rm))
    for m in range(len(ops.MODES)):
        assert_mc_equal((got[0][m], got[1][m]), (want[0][m], want[1][m]),
                        np.zeros(J, bool))
    # clone's Monte-Carlo PoCD estimates Theorem 1 (quickstart's claim)
    assert float(got[0][0].mean()) == pytest.approx(
        float(pocd_clone(r_star["clone"], job.t_min, job.beta, job.D,
                         job.N)), abs=0.05)
    assert float(utility("clone", torch.tensor(float(r_star["clone"])),
                         job)) == pytest.approx(
        float(ref_utility("clone", jnp.float32(r_star["clone"]), ref_job)),
        rel=1e-5)


# ---------------------------------------------------------------------------
# The training optimizer: Adafactor's update, streamed a slice at a time
# ---------------------------------------------------------------------------

#: 4 layers whose block leaves share a clip group two by two
#: (stack_period 2: the reference stacks layers 0 and 2, 1 and 3), with a
#: stacked (E, rows, cols) leaf, a factored matrix and a vector; outside
#: the blocks a factored matrix and a vector
ADA_LAYERS, ADA_PERIOD = 4, 2
ADA_BLOCK = {"moe": {"wi": (3, 160, 144)}, "w": (150, 130), "norm": (144,)}
ADA_TOP = {"embed": (200, 136), "b": (9,)}
#: cuts the expert leaf into its 3 matrices and the norm into 100 + 44
ADA_SLICE = 100


def nest_map(fn, tree):
    return {k: nest_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def ada_trees(seed):
    """(port tree, reference tree) of the same seeded f32 values: the
    port's one dict a layer, the reference's block leaves stacked over
    the layers of each of the ADA_PERIOD pattern positions."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    layers = [nest_map(draw, ADA_BLOCK) for _ in range(ADA_LAYERS)]
    top = nest_map(draw, ADA_TOP)
    port = dict(blocks=[nest_map(torch.from_numpy, x) for x in layers],
                **nest_map(torch.from_numpy, top))
    ref = dict(blocks=tuple(
        jax.tree.map(lambda *a: jnp.asarray(np.stack(a)),
                     *layers[i::ADA_PERIOD]) for i in range(ADA_PERIOD)),
        **nest_map(jnp.asarray, top))
    return port, ref


def port_of_ref(tree):
    """A reference-layout tree (block leaves stacked; a state's 0-dim
    placeholders are not) in the port's."""
    tree = jax.tree.map(np.asarray, tree)
    layers = [jax.tree.map(lambda a: torch.from_numpy(
        (a[i // ADA_PERIOD] if a.ndim else a).copy()),
        tree["blocks"][i % ADA_PERIOD]) for i in range(ADA_LAYERS)]
    return dict(blocks=layers, **{k: torch.from_numpy(v.copy())
                                  for k, v in tree.items() if k != "blocks"})


def ada_pairs(got, want):
    """(path, tensor, tensor) of two port-layout trees, leaf by leaf."""
    w = dict(tree_leaves_with_paths(want))
    return [(path, g, w[path]) for path, g in tree_leaves_with_paths(got)]


def ada_run(slice_elems):
    """Two updates of the port's Adafactor from the seeded trees; returns
    (params, state, the elements of the largest f32 tensor an op of the
    updates allocated: not a view, not written in place)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class LargestF32(TorchDispatchMode):
        most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            given = {a.untyped_storage().data_ptr() for a in
                     jax.tree.leaves((args, kwargs or {}))
                     if isinstance(a, torch.Tensor)}
            for x in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(x, torch.Tensor) and \
                        x.dtype == torch.float32 and not x._is_view() and \
                        x.untyped_storage().data_ptr() not in given:
                    self.most = max(self.most, x.numel())
            return out

    params, _ = ada_trees(0)
    opt = Adafactor(lr=1e-2, weight_decay=0.1, stack_period=ADA_PERIOD,
                    slice_elems=slice_elems)
    state = opt.init(params)
    watch = LargestF32()
    for seed in (1, 2):
        grads, _ = ada_trees(seed)
        with watch:
            params, state = opt.update(grads, state, params,
                                       lr_scale=torch.tensor(0.7))
    return params, state, watch.most


def test_leaf_slices_cover_the_leaf_in_whole_units():
    x = torch.arange(5 * 6 * 7, dtype=torch.float32).reshape(5, 6, 7)
    for n, inner, want in ((1000, 2, [5]), (84, 2, [2, 2, 1]),
                           (10, 2, [1] * 5), (100, 0, [100, 100, 10]),
                           (14, 1, [2] * 15)):
        parts = leaf_slices(x, n, inner)
        assert [len(p) for p in parts] == want, (n, inner)
        assert all(p.untyped_storage().data_ptr() ==
                   x.untyped_storage().data_ptr() for p in parts)  # views
        assert torch.equal(torch.cat([p.reshape(-1) for p in parts]),
                           x.reshape(-1))
    with pytest.raises(RuntimeError):           # no flat view to cut
        leaf_slices(x.transpose(1, 2), 10)


def test_streamed_adafactor_matches_unsliced_and_reference():
    """Two updates in ADA_SLICE-element slices against the unsliced
    update (every statistic bit-equal; the parameters within 1e-6 of
    each tensor's largest value, as each clip group's sum of squares is
    added in another order) and against the reference's Adafactor on
    the stacked tree (statistics and parameters within 1e-6). The
    streamed update forms no f32 tensor larger than one slice, where a
    slice holds at least one (rows, cols) matrix: the embedding's
    (200, 136), where the expert leaf is (3, 160, 144)."""
    params, state, most = ada_run(ADA_SLICE)
    whole, whole_state, whole_most = ada_run(1 << 28)
    assert most == 200 * 136 < whole_most == 3 * 160 * 144
    for f in ("vr", "vc", "v"):
        for path, a, b in ada_pairs(getattr(state, f),
                                    getattr(whole_state, f)):
            assert torch.equal(a, b), (f, path)
    for path, a, b in ada_pairs(params, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()),
                                   err_msg=str(path))

    ropt = ref_train_opt.Adafactor(lr=1e-2, weight_decay=0.1)
    _, rparams = ada_trees(0)
    rstate = ropt.init(rparams)
    for seed in (1, 2):
        _, rgrads = ada_trees(seed)
        rparams, rstate = ropt.update(rgrads, rstate, rparams,
                                      lr_scale=jnp.float32(0.7))
    assert int(state.step) == int(rstate.step) == 2
    for f in ("vr", "vc", "v"):
        for path, a, b in ada_pairs(getattr(state, f),
                                    port_of_ref(getattr(rstate, f))):
            assert a.shape == b.shape, (f, path)
            np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=0,
                atol=1e-6 * max(float(b.abs().max()), 1e-30),
                err_msg=f"{f} {path}")
    for path, a, b in ada_pairs(params, port_of_ref(rparams)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()),
                                   err_msg=str(path))
