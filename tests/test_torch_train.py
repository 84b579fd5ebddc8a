"""Port parity of the training path (`repro_torch.kernels.flash_attention`'s
backward, `models` loss, `train`, `launch.train`) on the CPU.

The reference's weights and optimizer state are carried across with
`repro_torch.convert` (`model_params`, `adamw_state`, `adafactor_state`),
and both packages run on the same numpy inputs. Model, step and trainer
tests use f32 compute, so that bf16 rounding, which the two frameworks
do at other points, does not set the tolerance.

Tolerances. The attention backward and the loss and its gradients:
1e-5 of each tensor's largest value (f32 products summed in other orders
over two layers). The optimizers: 1e-6 (a few f32 operations a leaf).
The train step and the trainer: 1e-5 on losses and parameters; AdamW's
first steps move each weight by about lr * sign(g), so gradient rounding
hardly reaches the parameters. With "bf16_params" or "bf16_grads" the
gradients are bf16 in both, and one that rounds the other way (one ulp,
up to 2^-7 relative) moves AdamW's second update by up to about 2^-7 of
lr: parameters are held within 1e-5 relative plus lr * 2^-6 absolute.

The config is gemma2-2b reduced with 2 kv heads (grouped-query
attention). Attention goes through the autograd Function the card runs
at every length: at sequence length 8 (its sliding window) every
layer's mask is plain causal; at 16 the local layers pass window 8.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import model as ref_model
from repro.models import transformer as RT
from repro.models.param import values_of
from repro.train import Trainer as RTrainer
from repro.train import TrainerConfig as RTrainerConfig
from repro.train import train_step as r_ts
from repro.train import optimizer as r_opt

from repro_torch import convert
from repro_torch.ckpt.checkpoint import tree_map
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as T
from repro_torch.train import (Adafactor, AdamW, Trainer, TrainerConfig,
                               TrainState, cosine_schedule, make_optimizer,
                               make_train_step)

TOL = 1e-5
OPT_TOL = 1e-6


def configs(**kw):
    """(reference, port) reduced gemma2, 2 kv heads, f32 compute."""
    kw = dict(n_kv_heads=2, compute_dtype="float32", **kw)
    return (dataclasses.replace(ref_get_config("gemma2-2b").reduced(), **kw),
            dataclasses.replace(get_config("gemma2-2b").reduced(), **kw))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def ref_params(rcfg, seed=0):
    return values_of(ref_model.build(rcfg).init(jax.random.PRNGKey(seed)))


def port_tree(tree, cfg):
    """A reference parameter-shaped numpy tree in the port's layout."""
    return convert.model_params(np_tree(tree), cfg, device="cpu")


def held(got, want, tol, what="", atol=0.0):
    """|got - want| <= tol * max |want| + atol, elementwise."""
    g, w = (np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                       else x, np.float64) for x in (got, want))
    assert g.shape == w.shape, what
    scale = max(np.abs(w).max(), 1e-30)
    err = np.abs(g - w).max() if g.size else 0.0
    assert err <= tol * scale + atol, \
        f"{what}: {err:.3g} > {tol} x {scale:.3g} + {atol:.3g}"


def held_trees(got, want, tol, what="", atol=0.0):
    def leaf(path, g, w):
        held(g, w, tol, f"{what}{path}", atol)

    def walk(g, w, path):
        if isinstance(g, dict):
            assert g.keys() == w.keys()
            for k in g:
                walk(g[k], w[k], f"{path}.{k}")
        elif isinstance(g, (list, tuple)):
            for i, (a, b) in enumerate(zip(g, w, strict=True)):
                walk(a, b, f"{path}[{i}]")
        else:
            leaf(path, g, w)
    walk(got, want, "")


def batch_np(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# attention_backward
# ---------------------------------------------------------------------------


ATTN_CASES = [
    # B, H, K, S, D, causal, softcap, q scale[, window, prefix_len]
    (2, 4, 2, 33, 16, True, 50.0, 1.0),
    (1, 4, 4, 20, 32, True, None, 1.0),
    (2, 6, 2, 17, 16, False, 30.0, 1.0),
    (1, 4, 1, 24, 16, True, 30.0, 16.0),   # scores past the softcap
    (2, 4, 2, 33, 16, True, 50.0, 1.0, 8, 0),        # sliding window
    (1, 4, 1, 29, 32, True, None, 1.0, None, 11),    # prefix-LM
    (2, 6, 2, 23, 16, False, 30.0, 1.0, 7, 0),       # bidirectional window
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_attention_backward_matches_jax_and_autograd(case):
    B, H, K, S, D, causal, cap, scale, *mask = case
    window, prefix = mask or (None, 0)
    masks = dict(causal=causal, window=window, prefix_len=prefix)
    rng = np.random.default_rng(sum(case[:5]))
    q = (scale * rng.standard_normal((B, S, H, D))).astype(np.float32)
    k, v = (rng.standard_normal((B, S, K, D)).astype(np.float32)
            for _ in range(2))
    dout = rng.standard_normal((B, S, H, D)).astype(np.float32)

    # the reference: jax.grad of its einsum attention, (B, S, heads, D)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    bias = RA._mask_bias(pos, pos, RA.MaskSpec(causal=causal, window=window,
                                               prefix_len=prefix))

    def ref_loss(q, k, v):
        out = RA._attend(q, k, v, bias, K, H // K, cap)
        return jnp.sum(out * dout)

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(q, k, v)
    bhsd = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)]
    got = fa.attention_backward(*bhsd, torch.from_numpy(dout).transpose(1, 2),
                                softcap=cap, **masks)
    for g, w, n in zip(got, want, "qkv"):
        held(g.transpose(1, 2), w, TOL, f"d{n} vs jax.grad")

    # autograd through the plain version, and the Function's own backward
    leaves = [x.clone().requires_grad_(True) for x in bhsd]
    out = fa.attention_plain(*leaves, softcap=cap, **masks)
    plain = torch.autograd.grad(out, leaves,
                                torch.from_numpy(dout).transpose(1, 2))
    leaves2 = [x.clone().requires_grad_(True) for x in bhsd]
    out2 = fa.attention(*leaves2, softcap=cap, **masks)
    torch.testing.assert_close(out2, out, rtol=0, atol=0)
    fn = torch.autograd.grad(out2, leaves2,
                             torch.from_numpy(dout).transpose(1, 2))
    for g, p, f, n in zip(got, plain, fn, "qkv"):
        held(g, p.numpy(), TOL, f"d{n} vs autograd through the plain version")
        torch.testing.assert_close(f, g, rtol=0, atol=0)


@pytest.mark.parametrize("causal,cap", [(True, 50.0), (False, 30.0)])
def test_attention_backward_bf16_on_hot_scores(causal, cap):
    """bf16 inputs with scores past the softcap (q scaled by 16), where
    dP - D cancels: within the card's bf16 criteria (mean |err| <= 2^-8
    mean |want|, max |err| <= 2^-6 max |want|) of autograd through the
    plain version, and nonzero wherever it is."""
    g = torch.Generator().manual_seed(7)
    q = (16 * torch.randn(1, 8, 96, 64, generator=g)).to(torch.bfloat16)
    k, v = (torch.randn(1, 4, 96, 64, generator=g).to(torch.bfloat16)
            for _ in range(2))
    dout = torch.randn(1, 8, 96, 64, generator=g).to(torch.bfloat16)
    got = fa.attention_backward(q, k, v, dout, causal=causal, softcap=cap)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(fa.attention_plain(*leaves, causal=causal,
                                                  softcap=cap), leaves, dout)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        err = (a.float() - b.float()).abs()
        assert float(err.mean()) <= 2 ** -8 * float(b.float().abs().mean())
        assert float(err.max()) <= 2 ** -6 * float(b.float().abs().max())
        assert not bool(((a == 0) & (b != 0)).any())


def test_attention_without_grad_records_nothing():
    q, k, v = (torch.randn(1, 2, 8, 16) for _ in range(3))
    with torch.no_grad():
        out = fa.attention(q, k, v)
    assert out.grad_fn is None
    torch.testing.assert_close(out, fa.attention_plain(q, k, v), rtol=0,
                               atol=0)


# ---------------------------------------------------------------------------
# cross_entropy and loss_fn
# ---------------------------------------------------------------------------


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = rng.uniform(size=(3, 7)) < 0.6
    for m in (None, mask):
        want = RL.cross_entropy(logits, labels,
                                None if m is None else jnp.asarray(m))
        got = L.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              None if m is None else torch.from_numpy(m))
        held(got, want, 1e-6)


@pytest.fixture(scope="module")
def loss_setup():
    rcfg, tcfg = configs()
    rparams = ref_params(rcfg)
    return rcfg, tcfg, rparams


@pytest.mark.parametrize("seq", [8, 16], ids=["kernel_mask", "window_lt_S"])
def test_loss_fn_value_and_grads_match_reference(loss_setup, seq,
                                                 monkeypatch):
    rcfg, tcfg, rparams = loss_setup
    batch = batch_np(tcfg, 2, seq, seed=seq)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        lambda p: RT.loss_fn(p, jb, rcfg), has_aux=True))(rparams)
    params = port_tree(rparams, tcfg)
    leaves = [p.requires_grad_(True) for p in
              jax.tree.leaves(params)]
    model = model_lib.build(tcfg)
    windows = []

    def spy(*args, **mask):
        windows.append(mask["window"])
        return fa.attention(*args, **mask)

    monkeypatch.setattr(ops, "attention", spy)
    loss, metrics = model.loss_fn(params, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    # both layers through the differentiable kernel call, the local one
    # with its window
    assert windows == [8, None]
    loss.backward()
    held(loss, rloss, TOL, "loss")
    assert float(metrics["aux_loss"]) == 0.0
    want = port_tree(rgrads, tcfg)
    grads = tree_map(lambda p: p.grad, params)
    held_trees(grads, want, TOL, "grad")
    assert all(p.grad is not None for p in leaves)


def test_loss_fn_remat_equals_no_remat(loss_setup):
    _, tcfg, rparams = loss_setup
    batch = {k: torch.from_numpy(v) for k, v in batch_np(tcfg, 2, 8,
                                                          seed=1).items()}
    out = []
    for remat in (True, False):
        params = port_tree(rparams, tcfg)
        for p in jax.tree.leaves(params):
            p.requires_grad_(True)
        before = fa.launches  # CPU: the plain version, never counted
        loss, _ = T.loss_fn(params, batch, tcfg, remat=remat)
        loss.backward()
        assert fa.launches == before
        out.append((loss.detach(), tree_map(lambda p: p.grad, params)))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    for a, b in zip(jax.tree.leaves(out[0][1]), jax.tree.leaves(out[1][1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Optimizers and the schedule
# ---------------------------------------------------------------------------


def grads_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        0.01 * rng.standard_normal(p.shape), p.dtype), tree)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_update_matches_reference(loss_setup, kind):
    rcfg, tcfg, rparams = loss_setup
    if kind == "adamw":
        ropt = r_opt.AdamW(lr=1e-2, weight_decay=0.1)
        opt = AdamW(lr=1e-2, weight_decay=0.1)
        to_state = convert.adamw_state
    else:
        # a factoring threshold the reduced widths reach (d_model 64)
        ropt = r_opt.Adafactor(lr=1e-2, weight_decay=0.1,
                               min_dim_size_to_factor=32)
        opt = Adafactor(lr=1e-2, weight_decay=0.1, min_dim_size_to_factor=32,
                        stack_period=len(T.block_pattern(tcfg).specs))
        to_state = convert.adafactor_state
    g1, g2 = grads_like(rparams, 1), grads_like(rparams, 2)
    # carry the reference's state after one update across, then step both
    p1, s1 = ropt.update(g1, ropt.init(rparams), rparams, lr_scale=0.5)
    p2, s2 = ropt.update(g2, s1, p1, lr_scale=jnp.float32(0.7))
    params = port_tree(p1, tcfg)
    state = to_state(np_tree(s1._asdict()), tcfg, device="cpu")
    got_p, got_s = opt.update(port_tree(g2, tcfg), state, params,
                              lr_scale=torch.tensor(0.7))
    assert got_p is params                       # updated in place
    held_trees(got_p, port_tree(p2, tcfg), OPT_TOL, "params")
    assert int(got_s.step) == int(s2.step) == 2
    fields = ("m", "v") if kind == "adamw" else ("vr", "vc", "v")
    for f in fields:
        held_trees(getattr(got_s, f), port_tree(getattr(s2, f), tcfg),
                   OPT_TOL, f)
    if kind == "adamw":     # f32 parameters are their own master
        assert all(x is None for x in jax.tree.leaves(
            got_s.master, is_leaf=lambda x: x is None))
    # the port's init has the converted state's shapes
    own = opt.init(params)
    for f in fields:
        for a, b in zip(jax.tree.leaves(getattr(own, f)),
                        jax.tree.leaves(getattr(got_s, f))):
            assert a.shape == b.shape


def test_adamw_master_for_bf16_params():
    p = {"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16)}
    opt = AdamW(lr=1e-3)
    state = opt.init(p)
    assert state.master["w"].dtype == torch.float32
    opt.update({"w": torch.ones(4, 4)}, state, p)
    assert p["w"].dtype == torch.bfloat16
    torch.testing.assert_close(p["w"], state.master["w"].to(torch.bfloat16))
    assert float(state.master["w"][0, 0]) == pytest.approx(0.5 - 1e-3,
                                                          rel=1e-6)


def test_make_optimizer():
    assert isinstance(make_optimizer(get_config("gemma2-2b")), AdamW)
    ada = make_optimizer(dataclasses.replace(get_config("gemma2-2b"),
                                             optimizer="adafactor"))
    assert isinstance(ada, Adafactor) and ada.stack_period == 2


def test_cosine_schedule_matches_reference():
    want = r_ts.cosine_schedule(base=2.0, warmup=7, total=40, floor=0.2)
    got = cosine_schedule(base=2.0, warmup=7, total=40, floor=0.2)
    steps = np.arange(0, 50, dtype=np.int32)
    held(got(torch.from_numpy(steps)), want(jnp.asarray(steps)), 1e-6)
    held(got(torch.tensor(3, dtype=torch.int32)), want(jnp.int32(3)), 1e-6)


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opts", [frozenset(), frozenset({"bf16_params"}),
                                  frozenset({"bf16_grads"})], ids=str)
def test_train_step_drops_a_shard_like_reference(loss_setup, opts):
    rcfg, tcfg, rparams = loss_setup
    sched_r = r_ts.cosine_schedule(base=1.0, warmup=2, total=10)
    sched_t = cosine_schedule(base=1.0, warmup=2, total=10)
    rmodel, tmodel = ref_model.build(rcfg), model_lib.build(tcfg)
    ropt, topt = r_opt.AdamW(lr=3e-3), AdamW(lr=3e-3)
    rstep = jax.jit(r_ts.make_train_step(rmodel, ropt, 4, sched_r, opts))
    tstep = make_train_step(tmodel, topt, 4, sched_t, opts)
    mask = np.asarray([1.0, 1.0, 0.0, 1.0], np.float32)
    rstate = r_ts.TrainState(rparams, ropt.init(rparams),
                             jnp.zeros((), jnp.int32))
    params = port_tree(rparams, tcfg)
    tstate = TrainState(params, topt.init(params),
                        torch.zeros((), dtype=torch.int32))
    for i in range(2):
        batch = batch_np(tcfg, 8, 8, seed=20 + i)
        rstate, rm = rstep(rstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                           jnp.asarray(mask))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()},
                           torch.from_numpy(mask))
        held(tm["loss"], rm["loss"], TOL, f"loss {i}")
        assert float(tm["active_shards"]) == float(rm["active_shards"]) == 3
        if not opts:
            held(tm["grad_norm"], rm["grad_norm"], TOL, f"grad_norm {i}")
    assert int(tstate.step) == 2
    held_trees(tstate.params, port_tree(rstate.params, tcfg), TOL, "params",
               atol=3e-3 * 2 ** -6 if opts else 0.0)


def test_train_step_mask_weights_and_shard_grads(loss_setup):
    _, tcfg, rparams = loss_setup
    model = model_lib.build(tcfg)
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(model, AdamW(), 2, opts=frozenset({"shard_grads"}),
                        grad_specs={"any": None})
    with pytest.raises(ValueError, match="unknown opts"):
        make_train_step(model, AdamW(), 2, opts=frozenset({"fp8"}))
    # dropping shard 1 of 2 = training on shard 0 alone
    batch = batch_np(tcfg, 4, 8, seed=3)
    out = []
    for n_micro, mask, b in ((2, [1.0, 0.0], batch),
                             (1, [1.0], {k: v[:2] for k, v in
                                         batch.items()})):
        params = port_tree(rparams, tcfg)
        opt = AdamW(lr=1e-3)
        step = make_train_step(model, opt, n_micro)
        state, m = step(TrainState(params, opt.init(params),
                                   torch.zeros((), dtype=torch.int32)),
                        {k: torch.from_numpy(v) for k, v in b.items()},
                        torch.tensor(mask))
        out.append((float(m["loss"]), state.params))
    assert out[0][0] == out[1][0]
    held_trees(out[0][1], out[1][1], 0.0, "params")


# ---------------------------------------------------------------------------
# Trainer and the launcher
# ---------------------------------------------------------------------------


def test_trainer_and_restart_match_reference(loss_setup, tmp_path):
    rcfg, tcfg, rparams = loss_setup
    kw = dict(n_steps=3, global_batch=4, seq_len=8, n_micro=2, lr=5e-3,
              data_cycle=1, log_every=1000, ckpt_every=2)
    rt = RTrainer(rcfg, RTrainerConfig(**kw, speculative_input=False),
                  key=jax.random.PRNGKey(0))
    want = [h["loss"] for h in rt.run()]

    def port_trainer(**extra):
        t = Trainer(tcfg, TrainerConfig(**kw, **extra), seed=9,
                    device="cpu")
        params = port_tree(rparams, tcfg)
        t.state = TrainState(params, t.optimizer.init(params),
                             torch.zeros((), dtype=torch.int32))
        return t

    t = port_trainer()   # the speculative pipeline and governor, on the CPU
    got = [h["loss"] for h in t.run()]
    held(np.asarray(got), np.asarray(want), TOL, "losses")
    assert got[-1] < got[0]                        # one batch, repeated
    assert not t.pipeline._thread.is_alive()

    # fail after step 2 (checkpointed), restore into a fresh trainer
    t1 = port_trainer(ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="injected failure"):
        t1.run(fail_at=2)
    t2 = Trainer(tcfg, TrainerConfig(**kw, ckpt_dir=str(tmp_path)),
                 seed=123, device="cpu")
    assert t2.maybe_restore() == 2
    tail = t2.run()
    assert [h["step"] for h in tail] == [2]
    assert tail[0]["loss"] == got[2]               # resumes exactly


def test_launcher_runs_reduced_on_cpu(capsys):
    launch_train.main(["--arch", "chatglm3-6b", "--steps", "2", "--batch",
                       "4", "--seq", "8", "--device", "cpu",
                       "--no-speculation"])
    assert "done: 2 steps" in capsys.readouterr().out
