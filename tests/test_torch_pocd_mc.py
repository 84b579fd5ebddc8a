"""Port parity of the Monte-Carlo kernels (`repro_torch.kernels.pocd_mc`).

On the CPU the wrappers run the plain PyTorch versions; they are held
against the reference's Pallas kernels (interpret mode, as
tests/test_kernels.py runs them here) and its `ref.py` oracles, on the
same uniforms made with numpy from a seed. met is exact (atol 1e-6, the
reference test's) except for jobs with a task whose completion lies
within f32 rtol 1e-5 of the deadline, where the two frameworks' last-ulp
log/exp may fall on either side; cost is within rtol 2e-5 (the reference
kernel test's). The CUDA kernel is held against the plain version by the
`cuda`-marked test, which skips without a card, and by chip_smoke.py.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle


# the module (its launch counts); `repro_torch.kernels.pocd_mc` is the
# wrapper function, as in the reference's package
pm = importlib.import_module("repro_torch.kernels.pocd_mc")

# the oracles jitted: eager jnp compiles every op anew for each shape
pocd_mc_ref = jax.jit(ref_oracle.pocd_mc_ref, static_argnames=("mode",))
pocd_mc_all_ref = jax.jit(ref_oracle.pocd_mc_all_ref)

SHAPES = [(256, 16, 6), (128, 64, 4), (200, 8, 4), (129, 8, 4)]


def mc_inputs(J, N, R, seed, r_high=None):
    """(numpy, torch) inputs in tests/test_kernels.py's ranges; r in
    [0, R-1) unless `r_high` widens it past the slots."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    cols = (rng.uniform(1e-6, 1.0, (J, N, R)).astype(f32),
            rng.uniform(5.0, 20.0, J).astype(f32),
            rng.uniform(1.2, 3.0, J).astype(f32),
            rng.uniform(40.0, 120.0, J).astype(f32),
            rng.integers(0, r_high or R - 1, J).astype(np.int32))
    return cols, tuple(torch.from_numpy(c) for c in cols)


def r_rows(r, R):
    """One r row per mode, as tests/test_kernels.py builds them."""
    return np.stack([r, np.maximum(r - 1, 0), np.minimum(r + 1, R - 2)])


def near_deadline(u, t_min, beta, D, r, mode):
    return pm.near_deadline(u, t_min, beta, D, r, mode=mode).numpy()


def assert_mc_equal(got, want, near):
    met, cost = (x.numpy() for x in got)
    met_w, cost_w = (np.asarray(x) for x in want)
    assert met.dtype == cost.dtype == np.float32
    np.testing.assert_allclose(met[~near], met_w[~near], rtol=0, atol=1e-6)
    np.testing.assert_allclose(cost, cost_w, rtol=2e-5)


def test_modes_equal_reference():
    assert pm.MODES == ref_ops.MODES == ("clone", "srestart", "sresume")


@pytest.mark.parametrize("mode", ["clone", "srestart", "sresume"])
@pytest.mark.parametrize("shape", SHAPES)
def test_pocd_mc_matches_reference(mode, shape):
    J, N, R = shape
    np_in, t_in = mc_inputs(J, N, R, seed=J + R)
    got = pm.pocd_mc(*t_in, mode=mode)
    near = near_deadline(*t_in, mode)
    assert_mc_equal(got, ref_ops.pocd_mc(*map(jnp.asarray, np_in),
                                         mode=mode), near)
    assert_mc_equal(got, pocd_mc_ref(*map(jnp.asarray, np_in),
                                                mode=mode), near)
    print(f"{mode} {shape}: {int(near.sum())} jobs at the deadline")


@pytest.mark.parametrize("shape", SHAPES)
def test_pocd_mc_all_matches_reference(shape):
    J, N, R = shape
    np_in, t_in = mc_inputs(J, N, R, seed=J)
    rm = r_rows(np_in[4], R)
    got = pm.pocd_mc_all(*t_in[:4], torch.from_numpy(rm))
    want_k = ref_ops.pocd_mc_all(*map(jnp.asarray, np_in[:4]),
                                 jnp.asarray(rm))
    want_r = pocd_mc_all_ref(*map(jnp.asarray, np_in[:4]),
                                        jnp.asarray(rm))
    assert got[0].shape == got[1].shape == (3, J)
    for m, mode in enumerate(pm.MODES):
        near = near_deadline(*t_in[:4], torch.from_numpy(rm[m]), mode)
        row = (got[0][m], got[1][m])
        assert_mc_equal(row, (want_k[0][m], want_k[1][m]), near)
        assert_mc_equal(row, (want_r[0][m], want_r[1][m]), near)
        # row m of the fused sweep is the single-mode result, bit for bit
        one = pm.pocd_mc(*t_in[:4], torch.from_numpy(rm[m]), mode=mode)
        assert torch.equal(row[0], one[0]) and torch.equal(row[1], one[1])


def test_r_past_the_slots_activates_every_slot():
    """r >= R - 1 is allowed: every slot runs, as in the reference."""
    J, N, R = 96, 8, 4
    np_in, t_in = mc_inputs(J, N, R, seed=5, r_high=R + 3)
    assert (np_in[4] >= R - 1).any()
    for mode in pm.MODES:
        near = near_deadline(*t_in, mode)
        assert_mc_equal(pm.pocd_mc(*t_in, mode=mode),
                        pocd_mc_ref(*map(jnp.asarray, np_in),
                                               mode=mode), near)


MODE_SETS = [("clone",), ("srestart",), ("sresume",), pm.MODES]


def mode_rows(r, R):
    """One r row per mode, as test_pocd_mc_all_matches_reference builds
    them, as tensors."""
    return dict(zip(pm.MODES, map(torch.from_numpy, r_rows(r, R))))


@pytest.mark.parametrize("modes", MODE_SETS, ids="+".join)
@pytest.mark.parametrize("r_past", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_slots_read_covers_every_slot_an_outcome_reads(shape, r_past,
                                                       modes):
    """The kernel reads a task's leading `slots_read` slots (the largest
    count over the launch's modes) and nothing else. Every other slot made
    NaN leaves the plain version's met and cost bit for bit: a NaN that
    reached a minimum would propagate (torch.amin does)."""
    J, N, R = shape
    _, t_in = mc_inputs(J, N, R, seed=J + 7 * R + r_past,
                        r_high=R + 3 if r_past else None)
    u, t_min, beta, D, r = t_in
    rows = {m: row for m, row in mode_rows(r.numpy(), R).items()
            if m in modes}
    if r_past:      # r at or past the slots for every mode
        rows = {m: row + R for m, row in rows.items()}
    count = torch.stack(list(pm.slots_read(u, t_min, beta, D, rows)
                             .values())).amax(dim=0)
    skipped = torch.arange(R)[None, None, :] >= count[:, :, None]
    poisoned = torch.where(skipped, torch.nan, u)
    for m, row in rows.items():
        want = pm.pocd_mc_plain(u, t_min, beta, D, row, mode=m)
        got = pm.pocd_mc_plain(poisoned, t_min, beta, D, row, mode=m)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if not r_past:
        assert bool(skipped.any())    # the rule skips something here


def range_minima_outcome(u, t_min, beta, D, r, mode, tau_est_frac=0.3,
                         tau_kill_gap_frac=0.5, phi=0.25):
    """The kernel's rule in plain torch: each mode's minimum of attempt
    times over its slot range taken as the attempt time of the range's
    largest uniform (clone slots 0..r, srestart 1..r, sresume 1..r+1, cut
    at R-1), so one Pareto transform per range. Returns (met, cost)."""
    R = u.shape[2]
    k = torch.arange(R)

    def att(x):                     # the plain version's transform
        return t_min[:, None] * torch.exp(-torch.log(x) / beta[:, None])

    def range_att(lo, hi):          # att of the largest u of slots lo..hi
        inside = (k >= lo) & (k[None, :] <= hi[:, None])[:, None, :]
        a = att(torch.where(inside, u, 0.0).amax(dim=2))
        return torch.where((hi >= lo)[:, None], a, torch.inf)

    T1 = att(u[:, :, 0])
    strag = T1 > D[:, None]
    tau_est = tau_est_frac * t_min[:, None]
    tau_kill = tau_est + tau_kill_gap_frac * t_min[:, None]
    rf = r[:, None].to(torch.float32)
    if mode == "clone":
        best = torch.where((r >= 0)[:, None], range_att(0, r.clamp(max=R - 1)),
                           torch.inf)
        comp, mach = best, rf * tau_kill + best
    elif mode == "srestart":
        extra = range_att(1, r.clamp(max=R - 1))
        w_all = torch.minimum(T1 - tau_est, extra)
        use = strag & (r[:, None] > 0)
        comp = torch.where(use, tau_est + w_all, T1)
        mach = torch.where(use, tau_est + rf * (tau_kill - tau_est) + w_all,
                           T1)
    else:
        a = range_att(1, (r + 1).clamp(max=R - 1))
        w = torch.where(a < torch.inf, torch.maximum(t_min[:, None],
                                                     (1.0 - phi) * a),
                        torch.inf)
        comp = torch.where(strag, tau_est + w, T1)
        mach = torch.where(strag, tau_est + rf * (tau_kill - tau_est) + w, T1)
    return (torch.all(comp <= D[:, None], dim=1).to(torch.float32),
            torch.sum(mach, dim=1))


@pytest.mark.parametrize("mode", ["clone", "srestart", "sresume"])
@pytest.mark.parametrize("r_past", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_range_minima_give_the_plain_version_bit_for_bit(shape, r_past,
                                                         mode):
    """att(u) is non-increasing in u, so one transform per slot range (the
    kernel's rule) gives the plain version's met and cost bit for bit, r
    below and past the slots. The card checks the monotonicity it rests on
    with the kernel's own logf and expf (test_monotone_premise_on_card)."""
    J, N, R = shape
    _, t_in = mc_inputs(J, N, R, seed=3 * J + R + r_past,
                        r_high=R + 3 if r_past else None)
    got = range_minima_outcome(*t_in, mode=mode)
    want = pm.pocd_mc_plain(*t_in, mode=mode)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wrappers_route_by_device():
    """CPU tensors take the plain version (no launch is counted); a device
    with no kernel raises; so do a bad mode and too few slots."""
    _, t_in = mc_inputs(16, 4, 3, seed=1)
    before = (pm.launches, pm.launches_all)
    got = pm.pocd_mc(*t_in, mode="sresume")
    want = pm.pocd_mc_plain(*t_in, mode="sresume")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    rm = torch.stack([t_in[4]] * 3)
    got = pm.pocd_mc_all(*t_in[:4], rm)
    want = pm.pocd_mc_all_plain(*t_in[:4], rm)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (pm.launches, pm.launches_all) == before
    meta = tuple(x.to("meta") for x in t_in)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pm.pocd_mc(*meta)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pm.pocd_mc_all(*meta[:4], rm.to("meta"))
    with pytest.raises(ValueError, match="unknown mode"):
        pm.pocd_mc(*t_in, mode="hedge")
    with pytest.raises(ValueError, match="attempt slots"):
        pm.pocd_mc(t_in[0][:, :, :1], *t_in[1:], mode="srestart")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1001, 37, 5), (67, 338, 5), (50, 3, 4),
                                   (129, 40, 8), (9, 0, 3)])
def test_kernel_matches_plain_on_card(shape):
    """The CUDA kernels against the plain versions on the card, single
    mode and fused, r past the slots: a ragged last block (1001, 129),
    job blocks that start off 16-byte boundaries (67 x 338 x 5 floats), a
    job smaller than one warp's load (3 x 4), an even R and no tasks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    J, N, R = shape
    _, t_in = mc_inputs(J, N, R, seed=3, r_high=R + 1)
    t_in = tuple(x.cuda() for x in t_in)
    for mode in pm.MODES:
        near = near_deadline(*(x.cpu() for x in t_in), mode)
        got = pm.pocd_mc(*t_in, mode=mode)
        assert_mc_equal(tuple(x.cpu() for x in got),
                        tuple(x.cpu() for x in pm.pocd_mc_plain(
                            *t_in, mode=mode)), near)
    rm = torch.stack([t_in[4]] * 3)
    got = pm.pocd_mc_all(*t_in[:4], rm)
    for m, mode in enumerate(pm.MODES):
        one = pm.pocd_mc(*t_in, mode=mode)
        assert torch.equal(got[0][m], one[0])
        assert torch.equal(got[1][m], one[1])


@pytest.mark.cuda
def test_monotone_premise_on_card():
    """The kernel's range minima rest on logf and expf being
    non-decreasing over every f32 input they get; its build checks that
    with its own logf and expf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert pm.monotone_violations("cuda") == (0, 0)
