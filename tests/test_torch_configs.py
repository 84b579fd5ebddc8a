"""Port parity of the registered configs that no other test builds:
chatglm3-6b, mistral-nemo-12b, deepseek-coder-33b and arctic-480b, on
the CPU, reduced but each with its own grouped-query attention: 16 query
heads over 1 kv head for chatglm3-6b (its 32 over 2), 7 over 1 for
deepseek-coder-33b and arctic-480b (56 over 8), 8 over 2 for
mistral-nemo-12b (32 over 8). `ArchConfig.reduced()` keeps 4 query
heads, where none of these groups occurs. chatglm3-6b rotates half of
each head dim (`rope_fraction` 0.5), in the prefill and in decode;
arctic-480b keeps its bf16 parameters (its router f32).

The port's seeded weights go to the reference's layout (the inverse of
`repro_torch.convert.model_params`), and both packages run the same
numpy batches, in f32 compute: the forward's logits within 1e-4 of
their largest value; one decode step from the reference's own prefill
cache (carried to the port's layout) within 1e-4; the loss within 1e-5
and each gradient within 1e-5 of its tensor's largest value. A bf16
gradient is rounded once from f32 values that differ by ~1e-7 in the
two frameworks, so an element near a rounding boundary may round the
other way: one bf16 ulp of its own value more.
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
from repro.models import transformer as RT
from repro.models.inputs import make_batch as ref_make_batch

from repro_torch.ckpt.checkpoint import tree_leaves_with_paths
from repro_torch.configs import get_config
from repro_torch.convert import model_params
from repro_torch.models import model as model_lib
from repro_torch.models.inputs import make_batch

LOGITS_TOL = 1e-4
TOL = 1e-5
#: (query heads, kv heads) of each reduced config: its own group
HEADS = {"chatglm3-6b": (16, 1), "mistral-nemo-12b": (8, 2),
         "deepseek-coder-33b": (7, 1), "arctic-480b": (7, 1)}
ARCHS = tuple(HEADS)
B, PROMPT, MAX_SEQ = 2, 12, 16


def configs(name):
    """(reference, port) reduced config with the arch's own kv group, in
    f32 compute."""
    H, K = HEADS[name]
    kw = dict(n_heads=H, n_kv_heads=K, compute_dtype="float32")
    full = get_config(name)
    assert full.n_heads // full.n_kv_heads == H // K
    return (dataclasses.replace(ref_get_config(name).reduced(), **kw),
            dataclasses.replace(full.reduced(), **kw))


def np_leaf(t):
    """A port tensor as numpy (bf16 widened exactly) and its jax type."""
    dt = str(t.dtype).split(".")[-1]
    return t.detach().to(torch.float32).numpy(), getattr(jnp, dt)


def reference_tree(tparams, rcfg):
    """The port's parameters in the reference's layout: layer l's leaves
    stacked as step l // n of spec l % n, each in its own type."""
    def leaf(*ts):
        arrs = [np_leaf(t) for t in ts]
        return jnp.asarray(np.stack([a for a, _ in arrs]), arrs[0][1])

    n = len(RT.block_pattern(rcfg).specs)
    out = {k: jnp.asarray(*np_leaf(v)) for k, v in tparams.items()
           if k != "blocks"}
    out["blocks"] = tuple(jax.tree.map(leaf, *tparams["blocks"][i::n])
                          for i in range(n))
    return out


@functools.lru_cache(maxsize=None)
def setup(name):
    rcfg, tcfg = configs(name)
    tparams = model_lib.build(tcfg).init(seed=0, device="cpu")
    return dict(rcfg=rcfg, tcfg=tcfg, tparams=tparams,
                rparams=reference_tree(tparams, rcfg))


def held(got, want, tol, what, bf16=False):
    """|got - want| <= tol x max |want| elementwise, plus one bf16 ulp of
    the element where `bf16`."""
    g = got.detach().to(torch.float32).numpy().astype(np.float64)
    w = np.asarray(want.astype(jnp.float32) if hasattr(want, "astype")
                   else want, np.float64)
    assert g.shape == w.shape, what
    limit = tol * max(np.abs(w).max(), 1e-30)
    if bf16:
        mag = np.maximum(np.abs(w), np.finfo(np.float32).tiny)
        limit = limit + np.exp2(np.floor(np.log2(mag)) - 7)
    err = np.abs(g - w)
    assert (err <= limit).all(), f"{what}: {err.max():.3g} (tol {tol})"


def test_configs_keep_their_groups_and_rope():
    for name in ARCHS:
        rcfg, tcfg = configs(name)
        assert tcfg.q_per_kv == rcfg.n_heads // rcfg.n_kv_heads
        assert tcfg.rope_fraction == rcfg.rope_fraction
        assert tcfg.param_dtype == rcfg.param_dtype
    assert configs("chatglm3-6b")[1].rope_fraction == 0.5
    assert configs("arctic-480b")[1].param_dtype == "bfloat16"


@pytest.mark.parametrize("name", ARCHS)
def test_forward_logits_match_reference(name):
    s = setup(name)
    rb = ref_make_batch(s["rcfg"], B, 16, "prefill", seed=3)
    tb = make_batch(s["tcfg"], B, 16, "prefill", seed=3, device="cpu")
    with torch.no_grad():
        logits, _ = model_lib.build(s["tcfg"]).forward(s["tparams"], tb)
    rlogits, _ = jax.jit(ref_model.build(s["rcfg"]).forward)(s["rparams"],
                                                             rb)
    assert logits.dtype == torch.float32
    held(logits, rlogits, LOGITS_TOL, f"{name} logits")


def port_cache(rcache, tcfg):
    """The reference's prefill cache (a stacked (steps, B, S, K, Dh) k
    and v a pattern position) in the port's layout (one dict a layer)."""
    kv = rcache["kv"]
    n = len(kv)

    def t(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
            torch.bfloat16)

    return {"kv": [{k: t(kv[i % n][k][i // n]) for k in ("k", "v")}
                   for i in range(tcfg.n_layers)],
            "lengths": torch.from_numpy(np.asarray(rcache["lengths"]))}


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_from_the_reference_cache(name):
    """The prefill's logits, then one decode step of the greedy token
    from the reference's own cache: the port's decode applies RoPE (on
    half of each head dim for chatglm3-6b) at the cached length and
    attends over the grouped kv heads."""
    s = setup(name)
    rm, tm = ref_model.build(s["rcfg"]), model_lib.build(s["tcfg"])
    rb = ref_make_batch(s["rcfg"], B, PROMPT, "prefill", seed=5)
    tb = make_batch(s["tcfg"], B, PROMPT, "prefill", seed=5, device="cpu")
    rlogits, rcache = jax.jit(rm.prefill, static_argnums=2)(
        s["rparams"], rb, MAX_SEQ)
    with torch.no_grad():
        logits, _ = tm.prefill(s["tparams"], tb, MAX_SEQ)
    held(logits, rlogits, LOGITS_TOL, f"{name} prefill logits")
    V = s["tcfg"].vocab_size
    tok = jnp.argmax(rlogits[:, -1:, :V], axis=-1).astype(jnp.int32)
    rnext, _ = jax.jit(rm.decode_step)(s["rparams"], tok, rcache)
    with torch.no_grad():
        nxt, cache = tm.decode_step(
            s["tparams"], torch.from_numpy(np.asarray(tok)),
            port_cache(rcache, s["tcfg"]))
    assert cache["lengths"].tolist() == [PROMPT + 1] * B
    held(nxt, rnext, LOGITS_TOL, f"{name} decode logits")


@pytest.mark.parametrize("name", ARCHS)
def test_loss_grads_match_jax_grad(name):
    s = setup(name)
    rb = ref_make_batch(s["rcfg"], B, 16, "train", seed=7)
    tb = make_batch(s["tcfg"], B, 16, "train", seed=7, device="cpu")
    rm = ref_model.build(s["rcfg"])
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        rm.loss_fn, has_aux=True))(s["rparams"], rb)
    params = model_params(jax.tree.map(np.asarray, s["rparams"]),
                          s["tcfg"], device="cpu")
    for _, p in tree_leaves_with_paths(params):
        p.requires_grad_(True)
    loss, _ = model_lib.build(s["tcfg"]).loss_fn(params, tb)
    loss.backward()
    held(loss, rloss, TOL, f"{name} loss")
    want = dict(tree_leaves_with_paths(model_params(
        jax.tree.map(np.asarray, rgrads), s["tcfg"], device="cpu")))
    for path, p in tree_leaves_with_paths(params):
        assert p.grad is not None, path
        held(p.grad, want[path].to(torch.float32).numpy(), TOL,
             f"{name} grad {path}", bf16=p.dtype == torch.bfloat16)
