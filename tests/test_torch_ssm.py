"""Port parity of the ssm and hybrid families (`repro_torch.models.mamba2`
and the ssm and hybrid builders of `repro_torch.models.model`), on
reduced configs: the port's seeded weights, the same values in the
reference's layout (`model_params` carries them back bit for bit), and
the same numpy inputs.

f32 compute, so that bf16 rounding at other points in the two frameworks
does not set the tolerance: the SSD scan within 1e-5 of the reference's
chunked form and within 1e-4 of its recurrent oracle; logits and decode
logits within 1e-4 and the loss within 1e-5 (relative to the largest
value, tests/test_torch_families.py's rule); the prefill's f32 ssm
states within 1e-5 and its bf16 conv states and kv caches within one
bf16 ulp. `Engine.generate` gives the reference engine's tokens.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import mamba2 as RM2
from repro.models import model as ref_model
from repro.models.inputs import make_batch as ref_make_batch
from repro.models.param import values_of
from repro.serve.engine import Engine as RefEngine

from repro_torch.configs import get_config
from repro_torch.convert import model_params
from repro_torch.models import mamba2 as M2
from repro_torch.models import model as model_lib
from repro_torch.models.inputs import make_batch
from repro_torch.serve import Engine
from repro_torch.serve.engine import cast_weights

LOGITS_TOL = 1e-4
TOL = 1e-5
ORACLE_TOL = 1e-4
ARCHS = ("mamba2-2.7b", "zamba2-7b")


def configs(name, **kw):
    """(reference, port) reduced config in f32 compute."""
    kw = dict(compute_dtype="float32", **kw)
    return (dataclasses.replace(ref_get_config(name).reduced(), **kw),
            dataclasses.replace(get_config(name).reduced(), **kw))


def np_leaf(t):
    """A port tensor as numpy (bf16 widened to f32, exactly) and its jax
    type."""
    dt = str(t.dtype).split(".")[-1]
    return t.detach().to(torch.float32).numpy() if dt == "bfloat16" \
        else t.detach().numpy(), getattr(jnp, dt)


def jx(t):
    return jnp.asarray(*np_leaf(t))


def stacked(*ts):
    arrs = [np_leaf(t) for t in ts]
    return jnp.asarray(np.stack([a for a, _ in arrs]), arrs[0][1])


def reference_tree(tparams, rcfg):
    """The port's parameters in the reference's layout (the inverse of
    `model_params`): ssm "blocks" stacked (L, ...); hybrid "groups"
    stacked (n_groups, inner, ...), "tail" (tail, ...) or None."""
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


def within_bf16_ulp(got, want, what):
    """got (a bf16 tensor) within one bf16 ulp of want, elementwise."""
    assert got.dtype == torch.bfloat16, what
    g = got.to(torch.float32).numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, what
    mag = np.maximum(np.abs(w), np.finfo(np.float32).tiny)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert (np.abs(g - w) <= ulp).all(), what


def test_configs_registered_and_equal_reference():
    for name in ARCHS:
        ref, port = ref_get_config(name), get_config(name)
        assert dataclasses.asdict(ref) == dataclasses.asdict(port)
        assert dataclasses.asdict(ref.reduced()) == \
            dataclasses.asdict(port.reduced())
        assert port.param_count() == ref.param_count()


def test_weights_carry_across(family):
    """The port's init has the reference init's leaves, shapes and
    types, and `model_params` carries the reference's layout back to the
    port's bit for bit."""
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


def ssd_inputs(S=64, seed=0):
    """numpy xh (2, S, 4, 8), dt = softplus(normal) (2, S, 4), A (4,) in
    -[1, 16], Bc and Cc (2, S, 16)."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((2, S, 4, 8))
    dt = np.log1p(np.exp(rng.standard_normal((2, S, 4))))
    A = -np.linspace(1.0, 16.0, 4)
    Bc, Cc = (rng.standard_normal((2, S, 16)) for _ in range(2))
    return [a.astype(np.float32) for a in (xh, dt, A, Bc, Cc)]


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_chunked_matches_reference(chunk):
    arrs = ssd_inputs()
    want, want_h = jax.jit(RM2.ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, arrs), chunk)
    oracle = jax.jit(RM2.ssd_reference)(*map(jnp.asarray, arrs))
    got, got_h = M2.ssd_chunked(*map(torch.from_numpy, arrs), chunk)
    held(got, want, TOL, "y")
    held(got_h, want_h, TOL, "h_final")
    held(got, oracle, ORACLE_TOL, "y against the recurrent oracle")
    held(M2.ssd_reference(*map(torch.from_numpy, arrs)), oracle, TOL,
         "the port's oracle")


def test_ssd_chunk_rule_raises():
    """S a multiple of the chunk or below it, as the reference asserts."""
    arrs = [torch.from_numpy(a) for a in ssd_inputs(S=40)]
    M2.ssd_chunked(*arrs, 64)  # one chunk of 40
    with pytest.raises(ValueError, match="multiple of the SSD chunk 16"):
        M2.ssd_chunked(*arrs, 16)


def test_conv_full_and_step_match_reference():
    """The causal conv in tap order, and the decode conv on a bf16 state
    (cast to the column's type, as the reference casts it)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, w, b)]
    held(M2._conv_full(*t), RM2._conv_full(x, w, b), 1e-6, "conv_full")
    state = torch.from_numpy(x[:, :3]).to(torch.bfloat16)
    out, st = M2._conv_step(state, t[0][:, 3:4], t[1], t[2])
    rout, rst = RM2._conv_step(jx(state), x[:, 3:4], w, b)
    held(out, rout, 1e-6, "conv_step out")
    assert st.dtype == torch.float32
    held(st, rst, 0.0, "conv_step state")


def test_forward_and_loss_match_reference(family):
    rcfg, tcfg = family["rcfg"], family["tcfg"]
    rb = ref_make_batch(rcfg, 2, 16, "train", seed=16)
    tb = make_batch(tcfg, 2, 16, "train", seed=16, device="cpu")
    model = model_lib.build(tcfg)
    with torch.no_grad():
        logits, aux = model.forward(family["tparams"], tb)
        loss, metrics = model.loss_fn(family["tparams"], tb)
    rm = ref_model.build(rcfg)
    rlogits, (rloss, rmetrics) = jax.jit(
        lambda p, b: (rm.forward(p, b)[0], rm.loss_fn(p, b)))(
            family["rparams"], rb)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    held(logits, rlogits, LOGITS_TOL, "logits")
    held(loss, rloss, TOL, "loss")
    held(metrics["ce"], rmetrics["ce"], TOL, "ce")


def cache_pairs(tcache, rcache, family):
    """(what, port tensor, reference array) for every leaf of the two
    caches."""
    if family == "ssm":
        return [(f"layer {l} state {i}", st[i], rcache["states"][i][l])
                for l, st in enumerate(tcache["states"]) for i in range(4)]
    out = [(f"group {g} layer {j} state {i}", st[i],
            rcache["groups"][i][g, j])
           for g, group in enumerate(tcache["groups"])
           for j, st in enumerate(group) for i in range(4)]
    out += [(f"group {g} {n}", kv[n], rcache[f"attn_{n}"][g])
            for g, kv in enumerate(tcache["kv"]) for n in ("k", "v")]
    out += [(f"tail {l} state {i}", st[i], rcache["tail"][i][l])
            for l, st in enumerate(tcache["tail"]) for i in range(4)]
    return out


def test_prefill_states_and_decode_match_reference(family):
    """Prefill of 16 tokens (two SSD chunks) with max_seq 24: the last
    logits, every layer's states (f32 ssm within 1e-5, bf16 conv states
    and kv caches within one bf16 ulp) and lengths; then 3
    teacher-forced decode steps."""
    rcfg, tcfg = family["rcfg"], family["tcfg"]
    rm, tm = ref_model.build(rcfg), model_lib.build(tcfg)
    rb = ref_make_batch(rcfg, 2, 16, "prefill", seed=4)
    tb = make_batch(tcfg, 2, 16, "prefill", seed=4, device="cpu")
    rlogits, rcache = jax.jit(lambda p, b: rm.prefill(p, b, 24))(
        family["rparams"], rb)
    logits, cache = tm.prefill(family["tparams"], tb, 24)
    held(logits, rlogits, LOGITS_TOL, "prefill logits")
    np.testing.assert_array_equal(cache["lengths"].numpy(),
                                  np.asarray(rcache["lengths"]))
    for what, got, want in cache_pairs(cache, rcache, tcfg.family):
        if got.dtype == torch.float32:
            held(got, want, TOL, what)
        else:
            within_bf16_ulp(got, want, what)
    decode = jax.jit(rm.decode_step)
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (3, 2, 1))
    for step, tok in enumerate(toks.astype(np.int32)):
        rlogits, rcache = decode(family["rparams"], jnp.asarray(tok), rcache)
        logits, cache = tm.decode_step(family["tparams"],
                                       torch.from_numpy(tok), cache)
        held(logits, rlogits, LOGITS_TOL, f"decode step {step} logits")
    for what, got, want in cache_pairs(cache, rcache, tcfg.family):
        held(got, want, LOGITS_TOL, f"after decode: {what}")


def test_init_cache_is_the_reference_cache_spec(family):
    """The empty cache has `cache_spec`'s shapes and types, and two
    decode steps from it give the reference's logits."""
    rcfg, tcfg = family["rcfg"], family["tcfg"]
    rm = ref_model.build(rcfg)
    rcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          rm.cache_spec(2, 8))
    cache = model_lib.build(tcfg).init_cache(2, 8, device="cpu")
    for what, got, want in cache_pairs(cache, rcache, tcfg.family) + [
            ("lengths", cache["lengths"], rcache["lengths"])]:
        assert tuple(got.shape) == tuple(want.shape), what
        assert str(got.dtype).split(".")[-1] == str(want.dtype), what
        assert not bool(got.any()), what
    tok = np.array([[3], [7]], np.int32)
    for step in range(2):
        rlogits, rcache = jax.jit(rm.decode_step)(family["rparams"],
                                                  jnp.asarray(tok), rcache)
        logits, cache = model_lib.build(tcfg).decode_step(
            family["tparams"], torch.from_numpy(tok), cache)
        held(logits, rlogits, LOGITS_TOL, f"step {step} from empty")


def test_engine_generate_matches_reference(family):
    """Greedy tokens after 16 prompt tokens, f32 compute, the reference's
    weights: the reference engine's. The ssm cache has no max_seq bound
    (as the reference's prefill has none); the hybrid's has."""
    rcfg, tcfg = family["rcfg"], family["tcfg"]
    max_seq = 8 if tcfg.family == "ssm" else 22
    ref = RefEngine.build(rcfg, max_seq=max_seq, params=family["rparams"])
    port = Engine.build(tcfg, max_seq=max_seq, device="cpu",
                        params=family["tparams"])
    rb = ref_make_batch(rcfg, 2, 16, "prefill", seed=6)
    tb = make_batch(tcfg, 2, 16, "prefill", seed=6, device="cpu")
    np.testing.assert_array_equal(port.generate(tb, 6), ref.generate(rb, 6))
    if tcfg.family == "hybrid":
        with pytest.raises(ValueError, match="max_seq"):
            port.generate(tb, 7)


def test_cast_weights_keeps_f32_scalars():
    """bf16 weights, but the norms, A_log, dt_bias and D stay f32 (the
    reference casts them to f32 where it reads them); the hybrid's groups,
    shared block and tail are walked."""
    hybrid = setup("zamba2-7b")["tparams"]
    out = cast_weights(hybrid, torch.bfloat16)
    blocks = [b for g in out["groups"] for b in g] + out["tail"]
    for b in blocks:
        for k in ("A_log", "dt_bias", "D", "ln", "norm"):
            assert b[k].dtype == torch.float32, k
        for k in ("in_x", "in_z", "out_proj", "conv_x", "conv_x_b"):
            assert b[k].dtype == torch.bfloat16, k
    assert torch.equal(blocks[0]["A_log"], hybrid["groups"][0][0]["A_log"])
    assert out["shared_attn"]["ln1"].dtype == torch.float32
    assert out["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16
    assert out["lm_head"].dtype == torch.bfloat16
