"""The reference's last two training levers in the port, on the CPU at
reduced sizes against the JAX package.

`remat="dots"`: the reference checkpoints each block under
`jax.checkpoint_policies.dots_with_no_batch_dims_saveable`, which keeps
the outputs of the weight products. The port runs each transformer block
under a selective checkpoint (`models/transformer.py`, `dots_policy`)
that keeps the outputs of `aten.mm` and `aten.addmm` and recomputes the
rest. What a block keeps is held against the residuals that
`jax.ad_checkpoint.print_saved_residuals` names for the reference's
block (types and element counts), and the losses and gradients under
"full", "dots" and "none" are the same bits, within the train tests'
1e-5 (loss) / 1e-4 (gradients, of each tensor's largest value) of the
reference's under "dots" (f32 compute).

`attn_impl="blocked"`: the reference's `_attend_blocked` is a scan over
key blocks; the port's attention is blocked on both passes whatever
`attn_impl` says (the flash kernels, and on the CPU their plain
versions). Logits and gradients are held within 3e-3 (absolute and
relative, tests/test_blocked_attention.py's tolerance) of the reference's
blocked model on that test's four mask cases, in f32 compute: in bf16 the
reference's blocked form rounds P to bf16 before its product with V and
the two frameworks round activations at other points, which alone moves
logits by about 4e-3.

The reference's weights are drawn with numpy over `jax.eval_shape` of
its init (a jitted init would cost seconds a config) and carried across
with `convert.model_params`; each reference computation is one jit.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.ad_checkpoint import print_saved_residuals
from torch.utils.checkpoint import CheckpointPolicy

from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.models import transformer as RT
from repro.models.inputs import make_batch as ref_make_batch
from repro.models.param import values_of

from repro_torch import convert
from repro_torch.ckpt.checkpoint import tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as T
from repro_torch.models.inputs import make_batch

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
BLOCKED_TOL = 3e-3


def ref_block_residuals(name, capsys) -> list:
    """(type, elements) of each product output the reference's block
    saves under "dots", from `print_saved_residuals` (a 2 x 32 input, the
    first block of the pattern, in the reduced config's compute type)."""
    cfg = ref_get_config(name).reduced()
    model = ref_model.build(cfg)
    blocks = jax.eval_shape(lambda k: values_of(model.init(k)),
                            jax.random.PRNGKey(0))["blocks"]
    blocks = blocks[0] if isinstance(blocks, (tuple, list)) else blocks
    block = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype), blocks)
    spec = RT.block_pattern(cfg).specs[0]
    B, S = 2, 32
    x = jax.ShapeDtypeStruct((B, S, cfg.d_model), jnp.dtype(cfg.compute_dtype))
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    f = jax.checkpoint(
        lambda p, x: RT.apply_block(p, x, pos, cfg, spec)[0],
        policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
    capsys.readouterr()
    print_saved_residuals(f, block, x)
    out = []
    for line in capsys.readouterr().out.splitlines():
        if " output of " in line:
            dtype, shape = re.match(r"(\w+)\[([\d,]*)\]", line).groups()
            out.append((dtype, int(np.prod([int(n) for n in shape.split(",")
                                            if n]))))
    return sorted(out)


def _product_output(op, args):
    """(type, elements) of an `mm` or `addmm` output from its operands."""
    a, b = (args[0], args[1]) if op == torch.ops.aten.mm.default \
        else (args[1], args[2])
    dtype = {torch.bfloat16: "bf16", torch.float32: "f32"}[a.dtype]
    return dtype, a.shape[0] * b.shape[1]


@pytest.mark.parametrize("name", ["gemma2-2b", "olmoe-1b-7b"])
def test_dots_keeps_the_references_residuals(name, capsys, monkeypatch):
    """Each block's kept tensors under "dots", read off the policy's
    MUST_SAVE decisions in the forward, are the reference block's saved
    product outputs: seven a gemma2 block (q, k, v, o, gate, up, down),
    five an olmoe block (q, k, v, o and the router; the experts' batched
    products are recomputed on both sides)."""
    want = ref_block_residuals(name, capsys)
    assert len(want) == {"gemma2-2b": 7, "olmoe-1b-7b": 5}[name]
    kept, policy, context = [], T.dots_policy, T.dots_context

    def spy_policy(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            kept[-1].append(_product_output(op, args))
        return out

    def spy_context():
        kept.append([])
        return context()

    monkeypatch.setattr(T, "dots_policy", spy_policy)
    monkeypatch.setattr(T, "dots_context", spy_context)
    cfg = dataclasses.replace(get_config(name).reduced(), remat="dots")
    model = model_lib.build(cfg)
    params = model.init(seed=0, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss, _ = model.loss_fn(params, make_batch(cfg, 2, 32, "train",
                                               device="cpu"))
    loss.backward()
    assert len(kept) == cfg.n_layers
    for block in kept:
        assert sorted(block) == want


def ref_params(rcfg, seed):
    """Weights in the reference's layout, of its init's shapes and types,
    drawn with numpy (std 0.05)."""
    model = ref_model.build(rcfg)
    shapes = jax.eval_shape(lambda k: values_of(model.init(k)),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        0.05 * rng.standard_normal(a.shape), a.dtype), shapes)


def _port_step(cfg, rparams, batch):
    params = convert.model_params(jax.tree.map(np.asarray, rparams), cfg,
                                  device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss, _ = model_lib.build(cfg).loss_fn(params, batch)
    loss.backward()
    return loss.detach(), tree_map(lambda p: p.grad, params)


@pytest.mark.parametrize("name", ["gemma2-2b", "olmoe-1b-7b"])
def test_remat_modes_same_bits_and_match_reference(name):
    """Reduced configs in f32 compute (gemma2 with 2 kv heads and 16
    tokens, so that its local layers' window of 8 is in force): the loss
    and every gradient the same bits under "full", "dots" and "none";
    gemma2's within 1e-5 / 1e-4 of the reference's loss and gradients
    under "dots"."""
    kw = dict(compute_dtype="float32", remat="dots")
    if name == "gemma2-2b":
        kw["n_kv_heads"] = 2
    rcfg = dataclasses.replace(ref_get_config(name).reduced(), **kw)
    cfg = dataclasses.replace(get_config(name).reduced(), **kw)
    rparams = ref_params(rcfg, seed=1)
    batch = make_batch(cfg, 2, 16, "train", seed=3, device="cpu")
    runs = {r: _port_step(dataclasses.replace(cfg, remat=r), rparams, batch)
            for r in ("dots", "full", "none")}
    for r in ("full", "none"):
        torch.testing.assert_close(runs[r][0], runs["dots"][0], rtol=0,
                                   atol=0)
        for a, b in zip(tree_leaves(runs[r][1]), tree_leaves(runs["dots"][1]),
                        strict=True):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    if name != "gemma2-2b":
        return

    rmodel = ref_model.build(rcfg)
    jb = ref_make_batch(rcfg, 2, 16, "train", seed=3)
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p: rmodel.loss_fn(p, jb)[0]))(rparams)
    loss, grads = runs["dots"]
    assert abs(float(loss) - float(rloss)) <= LOSS_TOL * abs(float(rloss))
    want = convert.model_params(jax.tree.map(np.asarray, rgrads), cfg,
                                device="cpu")
    for g, w in zip(tree_leaves(grads), tree_leaves(want), strict=True):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= GRAD_TOL * scale


# tests/test_blocked_attention.py's cases: plain causal GQA, local/global
# with softcaps, a bidirectional encoder, the prefix-LM mask
BLOCKED_CASES = ["mistral-nemo-12b", "gemma2-2b", "hubert-xlarge",
                 "paligemma-3b"]


@pytest.mark.parametrize("name", BLOCKED_CASES)
def test_blocked_attention_matches_reference(name):
    """The reference's model with attn_impl="blocked" and the port's
    (whose attention is blocked on both passes whatever attn_impl says)
    on the same weights and the reference's 2 x 32 batch, f32 compute:
    logits and the loss's gradients within 3e-3."""
    kw = dict(attn_impl="blocked", compute_dtype="float32")
    rcfg = dataclasses.replace(ref_get_config(name).reduced(), **kw)
    cfg = dataclasses.replace(get_config(name).reduced(), **kw)
    rmodel = ref_model.build(rcfg)
    rparams = ref_params(rcfg, seed=0)
    jb = ref_make_batch(rcfg, 2, 32, "train")

    def logits_and_grads(p):
        return (rmodel.forward(p, jb)[0],
                jax.grad(lambda p: rmodel.loss_fn(p, jb)[0])(p))

    rlogits, rgrads = jax.jit(logits_and_grads)(rparams)
    model = model_lib.build(cfg)
    params = convert.model_params(jax.tree.map(np.asarray, rparams), cfg,
                                  device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = make_batch(cfg, 2, 32, "train", device="cpu")
    logits, _ = model.forward(params, batch)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(rlogits),
                               atol=BLOCKED_TOL, rtol=BLOCKED_TOL)
    loss, _ = model.loss_fn(params, batch)
    loss.backward()
    want = convert.model_params(jax.tree.map(np.asarray, rgrads), cfg,
                                device="cpu")
    for p, w in zip(tree_leaves(params), tree_leaves(want), strict=True):
        # hubert's unused embedding table: no gradient here, zeros there
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=BLOCKED_TOL,
                                   rtol=BLOCKED_TOL)
