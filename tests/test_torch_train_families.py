"""Port parity of training the moe, vlm, audio, ssm and hybrid families
(olmoe-1b-7b, paligemma-3b, hubert-xlarge, mamba2-2.7b, zamba2-7b) on
the CPU, at reduced size: `loss_fn`'s gradients, one `make_train_step`
update on both gradient paths, and the `Trainer`.

The port's seeded weights are carried to the reference's layout and
back (`repro_torch.convert.model_params`, bit for bit); both packages run
the same numpy batches (`make_batch` gives the reference's arrays). f32
compute, so that bf16 rounding at other points in the two frameworks
does not set the tolerance. (The reference's own `PRNGKey(0)` weights
give reduced zamba2-7b NaN gradients in the reference: its SSD takes
`where(tri, exp(diff), 0)`, and an upper-triangle exp that overflows
sends inf * 0 into the backward. The port masks before the exp.)

Tolerances (tests/test_torch_train.py's): losses and gradients within
1e-5 of each tensor's largest value; the update within 1e-6 of the
reference's AdamW applied to the port's gradients (a few f32 operations
a leaf). With "bf16_grads" the gradients are bf16 in both, and one may
round the other way (one ulp, up to 2^-7 relative): gradients and their
norm are held within 2^-7 of the largest value.

hubert-xlarge's `embed` is not used by its loss (frames enter through
`frame_proj`): `jax.grad` gives it a zero gradient, so the reference's
AdamW moves it by weight decay alone; the port's train step must do the
same on both paths (it raised before).

The reference's `Trainer` feeds token batches only
(`PipelineConfig(family="dense")`), so it raises KeyError for the vlm
and audio families, and the port's does too; those two train through
`make_train_step`.

arctic-480b (moe, bf16 parameters but its f32 router, Adafactor) takes
the step with 1 and 2 microbatches on the default path and on
"bf16_grads": the reference accumulates a bf16 parameter's gradient in
f32 unless "bf16_grads" is asked for, and so must the port. Each
microbatch's gradient of a bf16 parameter is rounded to bf16 in both
frameworks, from f32 values that differ by ~1e-7, so an element near a
rounding boundary rounds the other way (one ulp; a sum of two such
microbatch gradients may cancel to a value far smaller than that ulp):
the loss and the gradient norm are held at 1e-5, each gradient within
2^-7 of its tensor's largest value (the one-ulp rule above), and at most
one element in ARCTIC_FLIPS of the whole model past 1e-5 (22-32 of
177,472 here; bf16 accumulation, the fault this holds, put the norm
1.5e-3 off). The update is held against the reference's Adafactor (with
a factoring threshold the reduced widths reach) applied to the port's
gradients: each bf16 parameter within 1e-6 of its tensor's largest value
and one bf16 ulp of its own (the f32 value rounds once).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.models.inputs import make_batch as ref_make_batch
from repro.models import transformer as RT
from repro.train import Trainer as RTrainer
from repro.train import TrainerConfig as RTrainerConfig
from repro.train import optimizer as r_opt
from repro.train import train_step as r_ts
from repro.train import trainer as r_trainer

from repro_torch.ckpt.checkpoint import tree_leaves_with_paths, tree_map
from repro_torch.configs import get_config
from repro_torch.convert import model_params
from repro_torch.models import model as model_lib
from repro_torch.models.inputs import make_batch
from repro_torch.train import (Adafactor, AdamW, Trainer, TrainerConfig,
                               TrainState, make_train_step)

TOL = 1e-5
OPT_TOL = 1e-6
LR, WD = 3e-3, 0.1
ARCHS = ("olmoe-1b-7b", "paligemma-3b", "hubert-xlarge", "mamba2-2.7b",
         "zamba2-7b")
TRAINER_ARCHS = ("olmoe-1b-7b", "mamba2-2.7b", "zamba2-7b")
# (batch, sequence) of the gradient and step batches: 16 tokens (two
# reduced SSD chunks), paligemma 4 patches + 12 text tokens, 16 frames
BATCH, SEQ, N_MICRO = 4, 16, 2
OPTS = {"in_place": frozenset(), "bf16_grads": frozenset({"bf16_grads"})}
#: Adafactor's settings for reduced arctic-480b (d_model 64, expert
#: d_ff 32): its matrices are factored from 32 rows and columns
ADA_KW = dict(lr=LR, weight_decay=WD, min_dim_size_to_factor=32)
ARCTIC_CASES = (("in_place", 1), ("in_place", 2), ("bf16_grads", 2))
ARCTIC_FLIPS = 1000


def configs(name):
    """(reference, port) reduced config in f32 compute."""
    kw = dict(compute_dtype="float32")
    return (dataclasses.replace(ref_get_config(name).reduced(), **kw),
            dataclasses.replace(get_config(name).reduced(), **kw))


def np_leaf(t):
    """A port tensor as numpy (bf16 widened to f32, exactly) and its jax
    type."""
    dt = str(t.dtype).split(".")[-1]
    return t.detach().to(torch.float32).numpy() if dt == "bfloat16" \
        else t.detach().numpy(), getattr(jnp, dt)


def stacked(*ts):
    arrs = [np_leaf(t) for t in ts]
    return jnp.asarray(np.stack([a for a, _ in arrs]), arrs[0][1])


def reference_tree(tparams, rcfg):
    """The port's parameters in the reference's layout (the inverse of
    `model_params`, tests/test_torch_families.py's and
    tests/test_torch_ssm.py's): transformer layer l's leaves stacked as
    step l // n of spec l % n; ssm "blocks" (L, ...); hybrid "groups"
    (n_groups, inner, ...), "shared_attn", "tail" (tail, ...)."""
    jx = lambda t: jnp.asarray(*np_leaf(t))
    if rcfg.family in ("ssm", "hybrid"):
        out = {k: jx(tparams[k]) for k in ("embed", "final_norm", "lm_head")}
        if rcfg.family == "ssm":
            out["blocks"] = jax.tree.map(stacked, *tparams["blocks"])
            return out
        groups = [jax.tree.map(stacked, *g) for g in tparams["groups"]]
        out["groups"] = jax.tree.map(lambda *a: jnp.stack(a), *groups)
        out["shared_attn"] = jax.tree.map(jx, tparams["shared_attn"])
        out["tail"] = jax.tree.map(stacked, *tparams["tail"]) \
            if tparams["tail"] else None
        return out
    n = len(RT.block_pattern(rcfg).specs)
    out = {k: jx(v) for k, v in tparams.items() if k != "blocks"}
    out["blocks"] = tuple(jax.tree.map(stacked, *tparams["blocks"][i::n])
                          for i in range(n))
    return out


@functools.lru_cache(maxsize=None)
def setup(name):
    """The configs, the port's seeded weights in the reference's layout
    (numpy) and a training batch; one init per architecture for the
    module."""
    rcfg, tcfg = configs(name)
    tparams = model_lib.build(tcfg).init(seed=0, device="cpu")
    rparams = jax.tree.map(np.asarray, reference_tree(tparams, rcfg))
    return dict(rcfg=rcfg, tcfg=tcfg, rparams=rparams,
                rbatch=ref_make_batch(rcfg, BATCH, SEQ, "train", seed=7))


def port_batch(s):
    return make_batch(s["tcfg"], BATCH, SEQ, "train", seed=7, device="cpu")


def port_tree(tree, s):
    """A reference-layout tree as the port's parameters."""
    return model_params(jax.tree.map(np.asarray, tree), s["tcfg"],
                        device="cpu")


def port_params(s):
    return port_tree(s["rparams"], s)


def held(got, want, tol, what, atol=0.0):
    """|got - want| <= tol * max |want| + atol, elementwise."""
    g = got.detach().to(torch.float32).numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float64)
    w = np.asarray(want.detach().to(torch.float32).numpy()
                   if isinstance(want, torch.Tensor) else want, np.float64)
    assert g.shape == w.shape, what
    err = np.abs(g - w).max() if g.size else 0.0
    scale = max(np.abs(w).max(), 1e-30)
    assert err <= tol * scale + atol, \
        f"{what}: {err:.3g} > {tol} x {scale:.3g} + {atol:.3g}"


def bf16_ulp(w):
    """One bf16 ulp of each element of the numpy array w."""
    mag = np.maximum(np.abs(w), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def past_tol(got, want, tol):
    """(elements past tol x their tensor's largest |want|, elements) of
    two port-layout trees."""
    want = dict(tree_leaves_with_paths(want))
    past = total = 0
    for path, g in tree_leaves_with_paths(got):
        g = g.detach().to(torch.float32).numpy().astype(np.float64)
        w = want[path].detach().to(torch.float32).numpy().astype(np.float64)
        past += int((np.abs(g - w) > tol * max(np.abs(w).max(), 1e-30))
                    .sum())
        total += g.size
    return past, total


def held_trees(got, want, tol, what, atol=0.0):
    want = dict(tree_leaves_with_paths(want))
    pairs = tree_leaves_with_paths(got)
    assert len(pairs) == len(want), what
    for path, g in pairs:
        held(g, want[path], tol, f"{what} {path}", atol)


@pytest.fixture(params=ARCHS)
def family(request):
    return setup(request.param)


# ---------------------------------------------------------------------------
# loss_fn gradients against jax.grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "mamba2-2.7b", "zamba2-7b",
                                  "hubert-xlarge"])
def test_loss_grads_match_jax_grad(name):
    """`loss.backward()` through the port's `loss_fn` (per-block remat)
    against `jax.grad` of the reference's; a leaf the loss does not use
    (hubert's `embed`) gets no .grad, and a zero gradient there."""
    s = setup(name)
    rm = ref_model.build(s["rcfg"])
    (rloss, rmetrics), rgrads = jax.jit(jax.value_and_grad(
        rm.loss_fn, has_aux=True))(s["rparams"], s["rbatch"])
    params = port_params(s)
    for _, p in tree_leaves_with_paths(params):
        p.requires_grad_(True)
    loss, metrics = model_lib.build(s["tcfg"]).loss_fn(params, port_batch(s))
    loss.backward()
    held(loss, rloss, TOL, "loss")
    held(metrics["aux_loss"], rmetrics["aux_loss"], TOL, "aux_loss")
    want = dict(tree_leaves_with_paths(port_tree(rgrads, s)))
    unused = []
    for path, p in tree_leaves_with_paths(params):
        if p.grad is None:
            unused.append(path)
            assert not want[path].any(), path
        else:
            held(p.grad, want[path], TOL, f"grad {path}")
    assert unused == ([("embed",)] if name == "hubert-xlarge" else [])


# ---------------------------------------------------------------------------
# One make_train_step update against the reference's jitted step
# ---------------------------------------------------------------------------


class Recording:
    """An optimizer that returns the gradients it was given beside its
    state (through the reference's jit too), then updates as `inner`."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        return self.inner.init(params), None

    def update(self, grads, state, params, lr_scale=1.0):
        params, state = self.inner.update(grads, state[0], params,
                                          lr_scale=lr_scale)
        return params, (state, grads)


REF_ADAMW = r_opt.AdamW(lr=LR, weight_decay=WD)
#: one compile for each tree of shapes, shared by both gradient paths
reference_adamw = jax.jit(REF_ADAMW.update)
REF_ADAFACTOR = r_opt.Adafactor(**ADA_KW)


def optimizers(s):
    """(reference, port) optimizer of the module's steps: AdamW with
    weight decay, or Adafactor (ADA_KW) for a config that trains with it;
    the port's shares each clip among the layers the reference stacks."""
    if s["tcfg"].optimizer == "adafactor":
        return REF_ADAFACTOR, Adafactor(
            **ADA_KW, stack_period=len(RT.block_pattern(s["rcfg"]).specs))
    return REF_ADAMW, AdamW(lr=LR, weight_decay=WD)


@functools.lru_cache(maxsize=None)
def reference_step(name, path, n_micro=N_MICRO):
    """The reference's jitted step (`optimizers`, no schedule, every
    shard kept) on the module's batch: (its gradients in the port's
    layout, its metrics); one compile for the module."""
    s = setup(name)
    ropt = Recording(optimizers(s)[0])
    step = jax.jit(r_ts.make_train_step(ref_model.build(s["rcfg"]), ropt,
                                        n_micro, None, OPTS[path]))
    state = r_ts.TrainState(s["rparams"], ropt.init(s["rparams"]),
                            jnp.zeros((), jnp.int32))
    state, metrics = step(state, s["rbatch"], jnp.ones((n_micro,)))
    return (port_tree(state.opt_state[1], s),
            {k: float(v) for k, v in metrics.items()})


def port_step(s, path, n_micro=N_MICRO):
    """The port's step from the same weights: (state, its gradients,
    metrics)."""
    opt = Recording(optimizers(s)[1])
    step = make_train_step(model_lib.build(s["tcfg"]), opt, n_micro,
                           opts=OPTS[path])
    params = port_params(s)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    state, metrics = step(state, port_batch(s), torch.ones((n_micro,)))
    grads = tree_map(lambda g: g.clone(), state.opt_state[1])
    return state, grads, {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("path", OPTS)
def test_train_step_update_matches_reference(family, path):
    """The loss, the accumulated gradients and their norm against the
    reference's step; the update against the reference's AdamW applied
    to the port's gradients. (Against the reference's own update an
    element whose gradient is near 0 may move by up to 2 lr either way:
    AdamW's first step is lr g / (|g| + eps).)"""
    s = family
    want_grads, want = reference_step(s["tcfg"].name.removesuffix(
        "-reduced"), path)
    state, grads, got = port_step(s, path)
    assert int(state.step) == 1
    held(got["loss"], want["loss"], TOL, "loss")
    assert got["active_shards"] == want["active_shards"] == N_MICRO
    gtol = 2 ** -7 if path == "bf16_grads" else TOL
    held(got["grad_norm"], want["grad_norm"], gtol, "grad_norm")
    held_trees(grads, want_grads, gtol, "grad")
    rgrads = reference_tree(grads, s["rcfg"])
    new, _ = reference_adamw(rgrads, REF_ADAMW.init(s["rparams"]),
                             s["rparams"])
    held_trees(state.params, port_tree(new, s), OPT_TOL, "params")


@pytest.mark.parametrize("path,n_micro", ARCTIC_CASES)
def test_bf16_parameter_step_matches_reference(path, n_micro):
    """Reduced arctic-480b, bf16 parameters: the loss, the gradient norm
    and every gradient against the reference's step, with 1 and 2
    microbatches on the default path (the reference's f32 accumulation)
    and with "bf16_grads" (bf16 in both: 2^-7, one ulp, as above); the
    bf16 parameters after the update against the reference's Adafactor
    applied to the port's gradients (in f32, as the reference's step
    hands them over)."""
    s = setup("arctic-480b")
    assert s["tcfg"].param_dtype == "bfloat16"
    want_grads, want = reference_step("arctic-480b", path, n_micro)
    state, grads, got = port_step(s, path, n_micro)
    assert int(state.step) == 1
    held(got["loss"], want["loss"], TOL, "loss")
    assert got["active_shards"] == want["active_shards"] == n_micro
    held(got["grad_norm"], want["grad_norm"],
         2 ** -7 if path == "bf16_grads" else TOL, "grad_norm")
    held_trees(grads, want_grads, 2 ** -7, "grad")
    past, total = past_tol(grads, want_grads, TOL)
    assert past * ARCTIC_FLIPS <= total, f"{past} of {total} past {TOL}"
    rgrads = jax.tree.map(lambda a: a.astype(jnp.float32),
                          reference_tree(grads, s["rcfg"]))
    new, _ = jax.jit(REF_ADAFACTOR.update)(
        rgrads, REF_ADAFACTOR.init(s["rparams"]), s["rparams"])
    want_params = dict(tree_leaves_with_paths(port_tree(new, s)))
    for p_path, p in tree_leaves_with_paths(state.params):
        w = want_params[p_path].to(torch.float32).numpy()
        err = np.abs(p.detach().to(torch.float32).numpy() - w)
        assert (err <= OPT_TOL * np.abs(w).max() + (
            bf16_ulp(w) if p.dtype == torch.bfloat16 else 0.0)).all(), \
            f"params {p_path}: {err.max():.3g}"


@pytest.mark.parametrize("path", OPTS)
def test_unused_parameter_gets_a_zero_gradient(path):
    """hubert-xlarge's `embed` (no gradient: frames enter through
    `frame_proj`) through both gradient paths: the step runs, its
    gradient is zero as the reference's, and AdamW moves `embed` by
    weight decay alone, as the reference's does on a zero gradient
    (m = v = 0, so the step is lr (0 / (0 + eps) + wd w))."""
    s = setup("hubert-xlarge")
    want_grads, want = reference_step("hubert-xlarge", path)
    state, grads, got = port_step(s, path)
    assert not want_grads["embed"].any() and not grads["embed"].any()
    embed0 = torch.from_numpy(s["rparams"]["embed"].copy())
    torch.testing.assert_close(state.params["embed"],
                               embed0 - LR * (WD * embed0), rtol=0, atol=0)
    held(got["grad_norm"], want["grad_norm"],
         2 ** -7 if path == "bf16_grads" else TOL, "grad_norm")


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizers_on_a_zero_gradient_match_reference(kind):
    """Two updates of a tree with zero-gradient leaves (a factored matrix
    and a vector): finite, and the reference's (no division by a zero
    second moment)."""
    rng = np.random.default_rng(3)
    p = {"w": rng.standard_normal((160, 144)).astype(np.float32),
         "b": rng.standard_normal((9,)).astype(np.float32)}
    zeros = {k: np.zeros_like(v) for k, v in p.items()}
    if kind == "adamw":
        ropt, opt = (r_opt.AdamW(lr=LR, weight_decay=WD),
                     AdamW(lr=LR, weight_decay=WD))
    else:
        ropt, opt = (r_opt.Adafactor(lr=LR, weight_decay=WD),
                     Adafactor(lr=LR, weight_decay=WD))
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    rs = ropt.init(rp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    ts = opt.init(tp)
    for _ in range(2):
        rp, rs = ropt.update({k: jnp.asarray(v) for k, v in zeros.items()},
                             rs, rp)
        tp, ts = opt.update({k: torch.from_numpy(v) for k, v in
                             zeros.items()}, ts, tp)
    for k in p:
        assert bool(torch.isfinite(tp[k]).all())
        held(tp[k], np.asarray(rp[k]), 1e-6, k)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


TRAINER_KW = dict(n_steps=3, global_batch=4, seq_len=SEQ, n_micro=2, lr=5e-3,
                  data_cycle=1, log_every=1000)


def reference_trainer(s, monkeypatch, **kw):
    """The reference's Trainer, its model's init handing it the module's
    weights (its own init of a reduced model compiles op by op for
    seconds)."""
    rm = ref_model.build(s["rcfg"])
    weights = jax.tree.map(jnp.asarray, s["rparams"])
    monkeypatch.setattr(r_trainer.model_lib, "build", lambda cfg: (
        dataclasses.replace(rm, init=lambda key: weights)))
    return RTrainer(s["rcfg"], RTrainerConfig(**kw), key=jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", TRAINER_ARCHS)
def test_trainer_matches_reference(name, monkeypatch):
    """Three steps (the schedule's warm-up gives step 0 a zero rate) of
    the reference's Trainer and of the port's (the speculative pipeline
    and governor on, on the CPU) from the same weights, on one repeated
    batch: the losses, falling."""
    s = setup(name)
    rt = reference_trainer(s, monkeypatch, **TRAINER_KW,
                           speculative_input=False)
    want = [h["loss"] for h in rt.run()]
    t = Trainer(s["tcfg"], TrainerConfig(**TRAINER_KW), seed=9, device="cpu")
    params = port_params(s)
    t.state = TrainState(params, t.optimizer.init(params),
                         torch.zeros((), dtype=torch.int32))
    got = [h["loss"] for h in t.run()]
    held(np.asarray(got), np.asarray(want), TOL, "losses")
    assert got[-1] < got[0]
    assert not t.pipeline._thread.is_alive()


@pytest.mark.parametrize("name,key", [("paligemma-3b", "patch_embeds"),
                                      ("hubert-xlarge", "frames")])
def test_trainer_raises_for_vlm_and_audio_like_reference(name, key,
                                                         monkeypatch):
    s = setup(name)
    kw = dict(TRAINER_KW, n_steps=1, speculative_input=False)
    rt = reference_trainer(s, monkeypatch, **kw)
    with pytest.raises(KeyError, match=key):
        rt.run()
    rt.pipeline.close()
    t = Trainer(s["tcfg"], TrainerConfig(**kw), seed=0, device="cpu")
    with pytest.raises(KeyError, match=key):
        t.run()
    t.pipeline.close()
