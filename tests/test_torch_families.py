"""Port parity of the moe, vlm and audio families (`repro_torch.models`
with `moe.py`, the stub front ends and the prefix-LM and bidirectional
masks), on reduced configs: the port's seeded weights, the same values
in the reference's layout (`model_params` carries them back bit for
bit), and the same numpy inputs.

f32 compute, so that bf16 rounding at other points in the two
frameworks does not set the tolerance: logits within 1e-4 (two layers
of f32 products summed in other orders), the loss and the moe aux loss
within 1e-5 relative, gradients within 1e-5 of each tensor's largest
value (tests/test_torch_train.py's). `Engine.generate` on reduced
paligemma in f32 gives the reference engine's tokens. The inputs of
`make_batch` are the reference's arrays, bit for bit.

The moe routing picks experts in `jax.lax.top_k`'s order, which breaks
ties to the lower index where `torch.topk` does not: a router with
duplicated columns makes every token's logits tie in pairs.
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
from repro.models import moe as RMOE
from repro.models import transformer as RT
from repro.models.inputs import make_batch as ref_make_batch
from repro.models.param import values_of
from repro.serve.engine import Engine as RefEngine

from repro_torch.configs import get_config
from repro_torch.convert import model_params
from repro_torch.models import model as model_lib
from repro_torch.models import moe as MOE
from repro_torch.models.inputs import make_batch
from repro_torch.serve import Engine

LOGITS_TOL = 1e-4
TOL = 1e-5
ARCHS = ("olmoe-1b-7b", "arctic-480b", "paligemma-3b", "hubert-xlarge")


def configs(name, **kw):
    """(reference, port) reduced config in f32 compute."""
    kw = dict(compute_dtype="float32", **kw)
    return (dataclasses.replace(ref_get_config(name).reduced(), **kw),
            dataclasses.replace(get_config(name).reduced(), **kw))


def np_leaf(t):
    """A port tensor as numpy (bf16 widened to f32, exactly) and its
    jax type."""
    dt = str(t.dtype).split(".")[-1]
    return t.detach().to(torch.float32).numpy() if dt == "bfloat16" \
        else t.detach().numpy(), getattr(jnp, dt)


def reference_tree(tparams, rcfg):
    """The port's parameters in the reference's layout: layer l's leaves
    stacked as step l // n of spec l % n (the inverse of
    `model_params`), each in its own type."""
    def leaf(*ts):
        arrs = [np_leaf(t) for t in ts]
        return jnp.asarray(np.stack([a for a, _ in arrs]), arrs[0][1])

    n = len(RT.block_pattern(rcfg).specs)
    blocks = tuple(jax.tree.map(leaf, *tparams["blocks"][i::n])
                   for i in range(n))
    out = {k: jnp.asarray(*np_leaf(v)) for k, v in tparams.items()
           if k != "blocks"}
    out["blocks"] = blocks
    return out


@functools.lru_cache(maxsize=None)
def setup(name):
    """The reduced configs, the port's seeded weights and the same values
    in the reference's layout; one init per architecture for the
    module."""
    rcfg, tcfg = configs(name)
    tparams = model_lib.build(tcfg).init(seed=0, device="cpu")
    rparams = reference_tree(tparams, rcfg)
    return dict(rcfg=rcfg, tcfg=tcfg, rparams=rparams, tparams=tparams)


@pytest.fixture(params=ARCHS)
def family(request):
    return setup(request.param)


def held(got, want, tol, what):
    g = got.detach().to(torch.float32).numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, what
    err = np.abs(g - w).max() if g.size else 0.0
    assert err <= tol * max(np.abs(w).max(), 1.0), f"{what}: {err:.3g}"


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_make_batch_equals_reference(name, kind):
    rcfg, tcfg = configs(name)
    rb = ref_make_batch(rcfg, 2, 12, kind, seed=5)
    tb = make_batch(tcfg, 2, 12, kind, seed=5, device="cpu")
    assert tb.keys() == rb.keys()
    for k, want in rb.items():
        got = tb[k]
        assert str(got.dtype).split(".")[-1] == str(want.dtype), k
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      np.asarray(want, np.float32))


def test_weights_carry_across(family):
    """The port's init has the reference init's leaves, shapes and types
    (the moe router f32 whatever param_dtype is, `vision_proj`,
    `frame_proj`), and `model_params` carries the reference's layout
    back to the port's bit for bit."""
    rcfg, tcfg = family["rcfg"], family["tcfg"]
    shapes = jax.eval_shape(lambda k: values_of(
        ref_model.build(rcfg).init(k)), jax.random.PRNGKey(0))
    got = jax.tree.map(lambda a: (a.shape, a.dtype), family["rparams"])
    assert got == jax.tree.map(lambda a: (a.shape, a.dtype), shapes)
    back = model_params(jax.tree.map(np.asarray, family["rparams"]), tcfg,
                        device="cpu")
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(
            family["tparams"]), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if tcfg.moe is not None:
        assert family["tparams"]["blocks"][0]["moe"]["router"].dtype == \
            torch.float32


def test_forward_and_loss_match_reference(family):
    """Logits, the aux loss and the loss at S 16 (vlm: 4 patches and 12
    text tokens under the prefix-LM mask; audio: bidirectional)."""
    rcfg, tcfg = family["rcfg"], family["tcfg"]
    rb = ref_make_batch(rcfg, 2, 16, "train", seed=16)
    tb = make_batch(tcfg, 2, 16, "train", seed=16, device="cpu")
    model = model_lib.build(tcfg)
    with torch.no_grad():
        logits, aux = model.forward(family["tparams"], tb)
        loss, metrics = model.loss_fn(family["tparams"], tb)
    rm = ref_model.build(rcfg)
    (rlogits, raux), (rloss, rmetrics) = jax.jit(
        lambda p, b: (rm.forward(p, b), rm.loss_fn(p, b)))(
            family["rparams"], rb)
    assert logits.dtype == torch.float32
    held(logits, rlogits, LOGITS_TOL, "logits")
    held(aux, raux, TOL, "aux")
    held(loss, rloss, TOL, "loss")
    held(metrics["ce"], rmetrics["ce"], TOL, "ce")
    assert (float(aux) > 0) == (tcfg.moe is not None)


def test_paligemma_loss_grads_match_jax_grad():
    """The prefix-LM mask's gradient through `loss_fn` (prefix 4 of S 12)
    against `jax.grad` of the reference's."""
    pali = setup("paligemma-3b")
    rcfg, tcfg, rparams = pali["rcfg"], pali["tcfg"], pali["rparams"]
    rb = ref_make_batch(rcfg, 2, 12, "train", seed=2)
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        lambda p: RT.loss_fn(p, rb, rcfg), has_aux=True))(rparams)
    params = model_params(jax.tree.map(np.asarray, rparams), tcfg,
                          device="cpu")
    leaves = jax.tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = model_lib.build(tcfg).loss_fn(
        params, make_batch(tcfg, 2, 12, "train", seed=2, device="cpu"))
    loss.backward()
    held(loss, rloss, TOL, "loss")
    want = jax.tree.leaves(model_params(jax.tree.map(np.asarray, rgrads),
                                        tcfg, device="cpu"))
    for i, (p, w) in enumerate(zip(leaves, want, strict=True)):
        held(p.grad, w.numpy(), TOL, f"grad {i}")


def test_top_k_breaks_ties_as_jax():
    """Probabilities from 4 levels over 64 experts, every row full of
    ties: the stable sort picks `jax.lax.top_k`'s experts in its order."""
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 4, (512, 64)).astype(np.float32) / 4
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 8)
    got_v, got_i = MOE.top_k(torch.from_numpy(probs), 8)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "arctic-480b"])
def test_moe_layer_on_tied_router(name):
    """apply_moe with every router column duplicated (expert 2e+1 a copy
    of 2e, so the logits tie in pairs): output and aux against the
    reference's, and the capacity drops taken on the same tokens."""
    rcfg, tcfg = configs(name)
    moe = dataclasses.replace(tcfg.moe, capacity_factor=0.5)
    rmoe = dataclasses.replace(rcfg.moe, capacity_factor=0.5)
    rng = np.random.default_rng(1)
    D, E = tcfg.d_model, moe.n_experts
    half = rng.standard_normal((D, E // 2)).astype(np.float32)
    router = np.repeat(half, 2, axis=1)
    p = {"router": router,
         "wi_gate": 0.1 * rng.standard_normal((E, D, moe.d_ff)),
         "wi_up": 0.1 * rng.standard_normal((E, D, moe.d_ff)),
         "wo": 0.1 * rng.standard_normal((E, moe.d_ff, D))}
    if moe.dense_residual:
        p["dense"] = {k: 0.1 * rng.standard_normal(s) for k, s in (
            ("wi_gate", (D, moe.dense_d_ff)), ("wi_up", (D, moe.dense_d_ff)),
            ("wo", (moe.dense_d_ff, D)))}
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    x = rng.standard_normal((2, 24, D)).astype(np.float32)
    want, waux = jax.jit(lambda p, x: RMOE.apply_moe(
        p, x, rmoe, tcfg.activation))(p, x)
    got, aux = MOE.apply_moe(jax.tree.map(torch.from_numpy, p),
                             torch.from_numpy(x), moe, tcfg.activation)
    held(got, want, TOL, "out")
    held(aux, waux, TOL, "aux")
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(router), -1)
    _, _, keep, _ = MOE.route(probs, moe, 24)
    assert 0 < int((~keep).sum()) < keep.numel()  # some slots dropped
    assert MOE._capacity(24, moe) == RMOE._capacity(24, rmoe)


def test_paligemma_engine_generate_matches_reference():
    """Greedy tokens after 4 patches and 8 text tokens, f32 compute, the
    reference's weights: the reference engine's tokens; the cache holds
    the patches."""
    pali = setup("paligemma-3b")
    rcfg, tcfg = pali["rcfg"], pali["tcfg"]
    ref = RefEngine.build(rcfg, max_seq=18, params=pali["rparams"])
    port = Engine.build(tcfg, max_seq=18, device="cpu",
                        params=pali["tparams"])
    rb = ref_make_batch(rcfg, 2, 12, "prefill", seed=3)
    tb = make_batch(tcfg, 2, 12, "prefill", seed=3, device="cpu")
    np.testing.assert_array_equal(port.generate(tb, 6), ref.generate(rb, 6))
    with pytest.raises(ValueError, match="max_seq"):
        port.generate(tb, 7)  # 4 patches + 8 tokens + 7 > 18


def test_encoder_has_no_engine():
    _, tcfg = configs("hubert-xlarge")
    with pytest.raises(ValueError, match="has_decode"):
        Engine.build(tcfg, device="cpu")
