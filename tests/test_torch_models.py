"""Port parity of the model stack (`repro_torch.models`), gemma2 reduced.

The reference's parameters are carried across with
`repro_torch.convert.model_params`, and both packages run on the same
numpy inputs. The config is reduced gemma2 with 2 kv heads: `reduced()`
gives 4 query over 4 kv heads, which is not grouped-query attention.

Tolerances. f32 compute: 1e-5 for single layers and 1e-4 for the
logits, since the two frameworks sum the same products in other orders
(f32 rounding, about 1e-7 relative a product, over two layers and a
d_ff of 128). bf16 compute: 2e-2, the reference's own bf16 kernel
tolerance, since each matmul output is rounded to bf16 (relative
2**-9) and the frameworks round GELU, RoPE and the softmax at other
points; and where the port goes through the flash-attention kernel its
scores are exact f32 products where the reference's `_attend` rounds
them to bf16 first.

Attention goes through `ops.attention` with every layer's mask. Prompt
length 8 equals gemma2-reduced's sliding window, so every layer's mask
is plain causal; at 16 the local layers pass window 8.
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

from repro_torch.configs import get_config, list_configs
from repro_torch.convert import model_params
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as T

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOGITS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def configs(cdt):
    """(reference, port) reduced gemma2 with GQA in compute type cdt."""
    kw = dict(n_kv_heads=2, compute_dtype=cdt)
    return (dataclasses.replace(ref_get_config("gemma2-2b").reduced(), **kw),
            dataclasses.replace(get_config("gemma2-2b").reduced(), **kw))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def setup(request):
    cdt = request.param
    rcfg, tcfg = configs(cdt)
    rparams = values_of(ref_model.build(rcfg).init(jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, rparams)
    return dict(cdt=cdt, rcfg=rcfg, tcfg=tcfg, rparams=rparams,
                tparams=model_params(tree, tcfg, device="cpu"))


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=tol)


def both(a, cdt):
    """The numpy array a in compute type cdt, as (jax, torch)."""
    return jnp.asarray(a, getattr(jnp, cdt)), \
        torch.from_numpy(a).to(getattr(torch, cdt))


def test_configs_equal_reference():
    """Every config of the reference is registered and is the
    reference's, field for field."""
    ported = ("arctic-480b", "chatglm3-6b", "deepseek-coder-33b",
              "gemma2-2b", "hubert-xlarge", "mamba2-2.7b",
              "mistral-nemo-12b", "olmoe-1b-7b", "paligemma-3b",
              "zamba2-7b")
    for name in ported:
        ref, port = ref_get_config(name), get_config(name)
        assert dataclasses.asdict(ref) == dataclasses.asdict(port)
        assert dataclasses.asdict(ref.reduced()) == \
            dataclasses.asdict(port.reduced())
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
    assert get_config("gemma2-2b").param_count() == 3_203_923_968
    assert list_configs() == list(ported)
    with pytest.raises(KeyError, match="ROADMAP.md"):
        get_config("llama-405b")


def test_other_families_raise():
    """A family the port does not know raises and names ROADMAP.md; a
    family whose extension is missing raises too, as does a transformer
    stack call on an ssm config."""
    cfg = get_config("gemma2-2b").reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        model_lib.build(dataclasses.replace(cfg, family="rnn"))
    for family, ext in (("ssm", "ssm"), ("hybrid", "ssm"), ("moe", "moe")):
        with pytest.raises(ValueError, match=ext):
            model_lib.build(dataclasses.replace(cfg, family=family))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        T.init_params(get_config("mamba2-2.7b").reduced())


def test_init_cache_is_the_reference_cache_spec():
    """The transformer's empty cache: layer l's k and v have the shape
    and type of step l // n of spec l % n in `cache_spec`, all zeros."""
    rcfg, tcfg = configs("float32")
    spec = ref_model.build(rcfg).cache_spec(2, 24)
    cache = model_lib.build(tcfg).init_cache(2, 24, device="cpu")
    n = len(spec["kv"])
    assert len(cache["kv"]) == tcfg.n_layers
    for layer, kv in enumerate(cache["kv"]):
        for name in ("k", "v"):
            want = spec["kv"][layer % n][name]
            assert tuple(kv[name].shape) == tuple(want.shape[1:])
            assert str(kv[name].dtype).split(".")[-1] == str(want.dtype)
            assert not bool(kv[name].any())
    assert cache["lengths"].dtype == torch.int32
    assert tuple(cache["lengths"].shape) == tuple(spec["lengths"].shape)


def test_init_params_has_the_reference_layout():
    """Port init and carried-over reference parameters: same leaves,
    shapes and types, layer by layer; norms zero as in the reference."""
    rcfg, tcfg = configs("bfloat16")
    tree = jax.tree.map(np.asarray, values_of(
        ref_model.build(rcfg).init(jax.random.PRNGKey(0))))
    conv = model_params(tree, tcfg, device="cpu")
    own = model_lib.build(tcfg).init(seed=0, device="cpu")

    def flat(p, pre=""):
        out = {}
        for k, v in p.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{pre}{k}."))
            elif isinstance(v, list):
                for i, b in enumerate(v):
                    out.update(flat(b, f"{pre}{k}.{i}."))
            else:
                out[pre + k] = v
        return out

    a, b = flat(conv), flat(own)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    assert len(own["blocks"]) == tcfg.n_layers
    assert not own["blocks"][1]["ln1_post"].any()
    s = own["embed"].std().item()
    assert 0.9 < s < 1.1  # the embedding's scale is 1.0, the rest 0.02
    assert 0.015 < own["lm_head"].std().item() < 0.025


def test_layers_match_reference(setup):
    cdt = setup["cdt"]
    rng = np.random.default_rng(1)
    tol = TOL[cdt]
    x_np = rng.standard_normal((2, 16, 64)).astype(np.float32)
    w_np = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, tx = both(x_np, cdt)
    close(L.rms_norm(tx, torch.from_numpy(w_np)),
          RL.rms_norm(jx, jnp.asarray(w_np)), tol)
    close(L.softcap(tx.float() * 40, 30.0), RL.softcap(jx.astype(
        jnp.float32) * 40, 30.0), 1e-5)
    assert L.softcap(tx, None) is tx
    pos_np = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    h_np = rng.standard_normal((2, 16, 4, 16)).astype(np.float32)
    jh, th = both(h_np, cdt)
    for frac in (1.0, 0.5):
        close(L.apply_rope(th, torch.from_numpy(pos_np), 16, frac),
              RL.apply_rope(jh, jnp.asarray(pos_np), 16, frac), tol)
    p = setup["tparams"]["blocks"][0]["mlp"]
    rp = jax.tree.map(lambda a: a[0], setup["rparams"]["blocks"][0]["mlp"])
    close(L.apply_mlp(p, tx, "geglu"), RL.apply_mlp(rp, jx, "geglu"), tol)
    tok_np = rng.integers(0, 256, (2, 16)).astype(np.int32)
    table = setup["tparams"]["embed"]
    close(L.embed_tokens(table.to(tx.dtype), torch.from_numpy(tok_np), True),
          RL.embed_tokens(setup["rparams"]["embed"].astype(jx.dtype),
                          jnp.asarray(tok_np), True), 0)
    close(L.logits_head(setup["tparams"]["lm_head"], tx, 30.0),
          RL.logits_head(setup["rparams"]["lm_head"], jx, 30.0), tol)


@pytest.mark.parametrize("S", [8, 16])
@pytest.mark.parametrize("impl", ["einsum", "blocked"])
def test_attention_full_matches_reference(setup, S, impl):
    """Both of the reference's forms, local and global layers; the port
    takes ops.attention where the mask is plain causal."""
    cdt = setup["cdt"]
    rcfg = dataclasses.replace(setup["rcfg"], attn_impl=impl)
    tcfg = setup["tcfg"]
    rng = np.random.default_rng(S)
    x_np = rng.standard_normal((2, S, 64)).astype(np.float32)
    jx, tx = both(x_np, cdt)
    pos_np = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    pat_r, pat_t = RT.block_pattern(rcfg), T.block_pattern(tcfg)
    assert tuple(pat_r.specs) == tuple(tuple(s) for s in pat_t.specs)
    for i, spec in enumerate(pat_t.specs):
        assert spec.window == (8 if i == 0 else None)
        p = setup["tparams"]["blocks"][i]["attn"]
        rp = jax.tree.map(lambda a: a[0],
                          setup["rparams"]["blocks"][i]["attn"])
        out, (k, v) = A.attention_full(p, tx, torch.from_numpy(pos_np), tcfg,
                                       spec)
        rout, (rk, rv) = RA.attention_full(rp, jx, jnp.asarray(pos_np), rcfg,
                                           RA.MaskSpec(*spec))
        assert out.dtype == k.dtype == getattr(torch, cdt)
        close(out, rout, TOL[cdt])
        close(k, rk, TOL[cdt])
        close(v, rv, TOL[cdt])


def test_attention_full_raises_off_the_kernel_on_a_device(monkeypatch):
    """A window below the sequence on a device tensor reaches
    `ops.attention` with its mask (CUDA on the card takes the kernel);
    a device with no kernel (meta here) raises there, and nothing falls
    back to a plain path."""
    _, tcfg = configs("float32")
    p = model_lib.build(tcfg).init(seed=0, device="cpu")["blocks"][0]["attn"]
    p = {k: v.to("meta") for k, v in p.items()}
    x = torch.zeros((1, 16, 64), device="meta")
    pos = torch.zeros((1, 16), dtype=torch.int32, device="meta")
    spec = T.block_pattern(tcfg).specs[0]
    assert spec.window == 8
    calls = []
    real = A.ops.attention

    def spy(q, k, v, **mask):
        calls.append((q.device.type, mask))
        return real(q, k, v, **mask)

    monkeypatch.setattr(A.ops, "attention", spy)
    monkeypatch.setattr(A, "_attend", None)  # no plain path to fall to
    with pytest.raises(ValueError, match="no kernel for device meta"):
        A.attention_full(p, x, pos, tcfg, spec)
    assert calls == [("meta", dict(causal=True, softcap=50.0, window=8,
                                   prefix_len=0))]


def test_attention_decode_matches_reference(setup):
    """One decode step against caches in bf16 (the reference's cache type
    at any compute type), positions on both sides of the window; the
    port's cache is written in place."""
    cdt, rcfg, tcfg = setup["cdt"], setup["rcfg"], setup["tcfg"]
    rng = np.random.default_rng(2)
    B, Smax = 3, 20
    x_np = rng.standard_normal((B, 1, 64)).astype(np.float32)
    jx, tx = both(x_np, cdt)
    kc_np = rng.standard_normal((B, Smax, 2, 16)).astype(np.float32)
    vc_np = rng.standard_normal((B, Smax, 2, 16)).astype(np.float32)
    pos_np = np.array([5, 9, 17], np.int32)
    for i, spec in enumerate(T.block_pattern(tcfg).specs):
        p = setup["tparams"]["blocks"][i]["attn"]
        rp = jax.tree.map(lambda a: a[0],
                          setup["rparams"]["blocks"][i]["attn"])
        kc = torch.from_numpy(kc_np).to(torch.bfloat16)
        vc = torch.from_numpy(vc_np).to(torch.bfloat16)
        out, (k2, v2) = A.attention_decode(p, tx, kc, vc,
                                           torch.from_numpy(pos_np), tcfg,
                                           spec)
        rout, (rk2, rv2) = RA.attention_decode(
            rp, jx, jnp.asarray(kc_np, jnp.bfloat16),
            jnp.asarray(vc_np, jnp.bfloat16), jnp.asarray(pos_np), rcfg,
            RA.MaskSpec(*spec))
        assert k2 is kc and v2 is vc
        close(out, rout, TOL[cdt])
        # one bf16 step (2**-8 relative) where the f32 k or v lies at a
        # rounding boundary
        close(k2, rk2, 2 ** -8)
        close(v2, rv2, 2 ** -8)


@pytest.mark.parametrize("S", [8, 16])
def test_forward_logits_match_reference(setup, S):
    from repro.models.inputs import make_batch as ref_make_batch
    from repro_torch.models.inputs import make_batch
    rcfg, tcfg = setup["rcfg"], setup["tcfg"]
    rb = ref_make_batch(rcfg, 2, S, "prefill", seed=S)
    tb = make_batch(tcfg, 2, S, "prefill", seed=S, device="cpu")
    np.testing.assert_array_equal(tb["tokens"].numpy(), rb["tokens"])
    logits, aux = model_lib.build(tcfg).forward(setup["tparams"], tb)
    rlogits, raux = ref_model.build(rcfg).forward(setup["rparams"], rb)
    assert logits.dtype == torch.float32 and logits.shape == rlogits.shape
    assert float(aux) == float(raux) == 0.0
    close(logits, rlogits, LOGITS_TOL[setup["cdt"]])
