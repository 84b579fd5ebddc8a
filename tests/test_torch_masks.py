"""Port parity of the attention masks: sliding windows, prefix-LM and
bidirectional attention through `repro_torch.kernels.flash_attention`.

The reference computes these masks outside its Pallas kernel, with
`models/attention.py:_mask_bias` and the einsum `_attend`; the port
computes them with its flash-attention call (the plain version here,
the CUDA kernels on a card). On the same numpy inputs, made from a seed:
- the plain masked forward against `_mask_bias` + `_attend`, f32 2e-5
  and bf16 2e-2 (the reference's kernel tolerances). The reference's
  bf16 `_attend` rounds the scores and probabilities to bf16, the port
  keeps them f32; with q scaled by 16 (scores past the softcap) the
  rounded scores alone move the output by more than 2e-2, so those
  cases hold the port's bf16 output against `_attend` run in f32 on
  the same bf16 values;
- the unmasked cases, and a window of at least S, against the Pallas
  kernel in interpret mode;
- the masked gradient (`attention_backward`) against `jax.grad` of
  `_attend`, at tests/test_torch_train.py's tolerance (1e-5 of each
  tensor's largest value; that file holds `loss_fn`'s gradients on
  reduced gemma2 past its window, tests/test_torch_families.py on
  reduced paligemma's prefix);
- on a card only (`cuda`, skipped here): both kernels against the
  plain version on every mask and at head dims 80 and 112.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.models import attention as RA


fa = importlib.import_module("repro_torch.kernels.flash_attention")

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = 1e-5
HOT = 16.0  # q scale that takes the scores past the softcap

# (H, K, S, D, causal, window, prefix, softcap, q scale)
MASKS = [
    (4, 2, 33, 16, True, 1, 0, None, 1.0),
    (4, 2, 33, 16, True, 3, 0, 50.0, 1.0),
    (4, 1, 33, 16, True, 8, 0, 50.0, HOT),
    (4, 4, 33, 16, True, 33, 0, None, 1.0),     # window >= S
    (4, 2, 33, 16, True, None, 5, None, 1.0),
    (4, 2, 33, 16, True, None, 33, 30.0, 1.0),  # prefix at S
    (4, 1, 33, 16, True, None, 40, 30.0, HOT),  # prefix above S
    (4, 2, 33, 16, False, None, 0, None, 1.0),
    (4, 2, 33, 16, False, 6, 0, 50.0, HOT),
    (4, 2, 33, 16, True, 6, 9, None, 1.0),      # window and prefix
    (8, 2, 40, 80, False, None, 0, None, 1.0),  # hubert's head dim
    (4, 4, 40, 112, True, None, 0, None, 1.0),  # zamba2's head dim
    (4, 2, 40, 112, True, 9, 0, 50.0, HOT),
]


def bshd(H, K, S, D, seed, q_scale=1.0):
    """numpy q (1, S, H, D), k and v (1, S, K, D), f32."""
    rng = np.random.default_rng(seed)
    q = q_scale * rng.standard_normal((1, S, H, D))
    k, v = (rng.standard_normal((1, S, K, D)) for _ in range(2))
    return [a.astype(np.float32) for a in (q, k, v)]


@functools.partial(jax.jit, static_argnames=("spec", "cap"))
def ref_attend(q, k, v, spec, cap):
    """The reference: `_mask_bias` + `_attend`, (B, S, heads, D)."""
    S, H, K = q.shape[1], q.shape[2], k.shape[2]
    pos = jnp.broadcast_to(jnp.arange(S)[None], (q.shape[0], S))
    bias = RA._mask_bias(pos, pos, spec)
    return RA._attend(q, k, v, bias, K, H // K, cap)


def port_attend(fn, arrs, dtype, **mask):
    """fn on (B, heads, S, D) views of the numpy (B, S, heads, D) arrays
    in dtype; returns (B, S, heads, D)."""
    t = [torch.from_numpy(a).to(dtype).transpose(1, 2) for a in arrs]
    return fn(*t, **mask).transpose(1, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MASKS, ids=str)
def test_masked_plain_matches_reference(case, dtype):
    H, K, S, D, causal, window, prefix, cap, q_scale = case
    arrs = bshd(H, K, S, D, seed=S + D + (window or 0) + prefix,
                q_scale=q_scale)
    spec = RA.MaskSpec(causal=causal, window=window, prefix_len=prefix)
    ref_in = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    if q_scale != 1.0:  # hot scores: the reference's arithmetic in f32
        ref_in = [x.astype(jnp.float32) for x in ref_in]
    want = ref_attend(*ref_in, spec, cap)
    got = port_attend(fa.attention, arrs, getattr(torch, dtype),
                      causal=causal, softcap=cap, window=window,
                      prefix_len=prefix)
    assert got.dtype == getattr(torch, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_allowed_mask_is_the_references():
    """Every (causal, window, prefix) of a 20-position grid, including
    windows of 1 and past S and prefixes past S, against `_mask_bias`."""
    pos = jnp.arange(20)
    for causal in (True, False):
        for window in (None, 1, 2, 7, 19, 20, 30):
            for prefix in (0, 1, 6, 20, 25):
                spec = RA.MaskSpec(causal, window, prefix)
                want = np.asarray(RA._mask_bias(pos, pos, spec)) == 0
                got = fa.allowed_mask(20, 20, causal, window, prefix)
                got = np.ones((20, 20), bool) if got is None else got.numpy()
                np.testing.assert_array_equal(got, want, str(spec))


@pytest.mark.parametrize("causal,cap", [(True, 50.0), (False, None)])
def test_unmasked_still_matches_pallas_interpret(causal, cap):
    """No window and no prefix: the Pallas kernel (interpret mode) is the
    reference; a window of at least S changes nothing."""
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((1, 4, 128, 64), (1, 2, 128, 64), (1, 2, 128, 64))]
    want = ref_ops.attention(*(jnp.asarray(a) for a in arrs), causal=causal,
                             softcap=cap)
    t = [torch.from_numpy(a) for a in arrs]
    for window in (None, 128, 1000):
        got = fa.attention(*t, causal=causal, softcap=cap, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=2e-5)


def test_kernel_mask_arguments():
    """The window the C entries receive: 0 for none or for one of at
    least Sk. A prefix goes to them as it is; the plain version (the
    kernels' rule) ignores one without causal and cuts one at Sk."""
    assert fa.kernel_window(100, None) == 0
    assert fa.kernel_window(100, 100) == 0
    assert fa.kernel_window(100, 101) == 0
    assert fa.kernel_window(100, 99) == 99
    assert fa.kernel_window(100, 1) == 1
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 12, 16, generator=g) for _ in range(3))
    np.testing.assert_array_equal(
        fa.attention_plain(q, k, v, causal=False, prefix_len=5).numpy(),
        fa.attention_plain(q, k, v, causal=False).numpy())
    np.testing.assert_array_equal(
        fa.attention_plain(q, k, v, causal=True, prefix_len=40).numpy(),
        fa.attention_plain(q, k, v, causal=True, prefix_len=12).numpy())


def test_masks_need_equal_lengths_and_valid_values():
    q, k, v = (torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 12, 16),
               torch.zeros(1, 2, 12, 16))
    for mask in (dict(causal=False, window=4), dict(causal=False,
                                                     prefix_len=2)):
        with pytest.raises(ValueError, match="Sq == Sk"):
            fa.attention(q, k, v, **mask)
    fa.attention(q, k, v, causal=False)  # no mask: any lengths
    with pytest.raises(ValueError, match="window"):
        fa.attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="prefix_len"):
        fa.attention(q, q, q, prefix_len=-1)


GRAD_CASES = [
    # H, K, S, D, causal, window, prefix, softcap, q scale
    (4, 2, 24, 16, True, 5, 0, 50.0, 1.0),
    (4, 1, 24, 16, True, None, 7, None, 1.0),
    (4, 2, 24, 16, False, 4, 0, 30.0, HOT),
]


@pytest.mark.parametrize("case", GRAD_CASES, ids=str)
def test_masked_backward_matches_jax_grad(case):
    H, K, S, D, causal, window, prefix, cap, q_scale = case
    q, k, v = bshd(H, K, S, D, seed=sum(case[:4]), q_scale=q_scale)
    dout = np.random.default_rng(1).standard_normal(q.shape).astype(
        np.float32)
    spec = RA.MaskSpec(causal=causal, window=window, prefix_len=prefix)
    want = jax.jit(jax.grad(
        lambda *x: jnp.sum(ref_attend(*x, spec, cap) * dout),
        argnums=(0, 1, 2)))(q, k, v)
    leaves = [torch.from_numpy(a).transpose(1, 2).requires_grad_(True)
              for a in (q, k, v)]
    out = fa.attention(*leaves, causal=causal, softcap=cap, window=window,
                       prefix_len=prefix)
    got = torch.autograd.grad(out, leaves,
                              torch.from_numpy(dout).transpose(1, 2))
    for g, w in zip(got, want):
        w = np.asarray(w)
        err = np.abs(g.transpose(1, 2).numpy() - w).max()
        assert err <= GRAD_TOL * np.abs(w).max()


# (dtype, (B, H, K, S, D), causal, window, prefix, softcap, views):
# windows and prefixes at and off the kernels' tiles (64 and 128 keys,
# 64 and 128 query rows), the bidirectional mask with and without a
# window, and head dims 80 and 112
CARD_MASKS = [
    (dt, (1, 8, K, S, D), causal, window, prefix, cap, views)
    for i, (dt, (S, D), (causal, window, prefix), cap) in enumerate(
        (dt, sd, m, cap)
        for dt in ("bfloat16", "float32")
        for sd in ((200, 64), (1000, 80), (2049, 128), (300, 256),
                   (700, 112))
        for m in ((True, 1, 0), (True, 64, 0), (True, 129, 0),
                  (True, None, 128), (True, None, 77), (False, None, 0),
                  (False, 100, 0), (True, 65, 200))
        for cap in (50.0,))
    for K, views in [((1, 2, 4)[i % 3], i % 2 == 0)]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,causal,window,prefix,cap,views",
                         CARD_MASKS)
def test_cuda_masks_match_plain_on_card(dtype, shape, causal, window,
                                        prefix, cap, views):
    """Both kernels against the plain version on the card: bfloat16
    through the tensor-core kernel, float32 through the SIMT one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    B, H, K, S, D = shape
    g = torch.Generator().manual_seed(S + D)
    x = [torch.randn((B, S, n, D) if views else (B, n, S, D), generator=g)
         for n in (H, K, K)]
    q, k, v = (t.to(getattr(torch, dtype)).cuda() for t in x)
    if views:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    mask = dict(causal=causal, softcap=cap, window=window, prefix_len=prefix)
    before = (fa.launches_sm90, fa.launches_simt)
    got = fa.attention(q, k, v, **mask)
    torch.cuda.synchronize()
    sm90 = dtype == "bfloat16"
    assert (fa.launches_sm90, fa.launches_simt) == (before[0] + sm90,
                                                    before[1] + (not sm90))
    want = fa.attention_plain(q, k, v, **mask)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if sm90:
        err, size = (got.float() - want.float()).abs(), want.float().abs()
        assert float(err.mean()) <= 2 ** -8 * float(size.mean())
        assert float(err.max()) <= 2 ** -6 * float(size.max())
