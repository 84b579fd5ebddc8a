"""Port parity of flash attention (`repro_torch.kernels.flash_attention`).

On the CPU the wrapper runs the plain PyTorch version; it is held against
the reference's Pallas kernel (interpret mode, as tests/test_kernels.py
runs it here) and its oracle `ref.attention_ref`, on the same inputs made
with numpy from a seed, at the reference test's shapes and tolerances:
f32 2e-5 and bf16 2e-2 (absolute and relative). The plain version goes
further than the Pallas wrapper, which needs multiples of 128: ragged
lengths and head dim 256 are held against the oracle. The CUDA kernel is
held against the plain version by the `cuda`-marked test, which skips
without a card, and by chip_smoke.py.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle

from repro_torch.kernels import ops

fa = importlib.import_module("repro_torch.kernels.flash_attention")

attention_ref = jax.jit(ref_oracle.attention_ref,
                        static_argnames=("causal", "softcap"))
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def qkv(B, H, K, Sq, D, seed, dtype="float32", Sk=None):
    """(jax, torch) q (B, H, Sq, D), k and v (B, K, Sk, D): the same
    values in both, rounded to bf16 the same way (to nearest even)."""
    rng = np.random.default_rng(seed)
    Sk = Sq if Sk is None else Sk
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, D), (B, K, Sk, D), (B, K, Sk, D))]
    jx = tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    tx = tuple(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    return jx, tx


def assert_close(got, want, dtype):
    assert got.dtype == getattr(torch, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bhsd", [(1, 4, 256, 64), (2, 8, 256, 128)])
def test_mha_matches_reference(dtype, bhsd):
    B, H, S, D = bhsd
    jx, tx = qkv(B, H, H, S, D, seed=S + D, dtype=dtype)
    got = ops.attention(*tx, causal=True)
    assert_close(got, ref_ops.attention(*jx, causal=True), dtype)
    assert_close(got, attention_ref(*jx, causal=True), dtype)


@pytest.mark.parametrize("kv_heads", [1, 2, 4])
def test_gqa_matches_reference(kv_heads):
    jx, tx = qkv(1, 8, kv_heads, 256, 64, seed=kv_heads)
    got = ops.attention(*tx, causal=True)
    assert_close(got, ref_ops.attention(*jx, causal=True), "float32")
    assert_close(got, attention_ref(*jx, causal=True), "float32")


@pytest.mark.parametrize("causal,cap", [(False, None), (True, 50.0),
                                        (False, 30.0)])
def test_softcap_and_noncausal_match_reference(causal, cap):
    jx, tx = qkv(1, 2, 2, 256, 64, seed=7)
    got = ops.attention(*tx, causal=causal, softcap=cap)
    assert_close(got, ref_ops.attention(*jx, causal=causal, softcap=cap),
                 "float32")
    assert_close(got, attention_ref(*jx, causal=causal, softcap=cap),
                 "float32")


@pytest.mark.parametrize("blocks", [(128, 128), (256, 64)])
def test_matches_reference_at_every_block_shape(blocks):
    """The reference kernel's tiling does not change its result, and the
    port equals it at each tiling."""
    jx, tx = qkv(1, 2, 2, 512, 64, seed=11)
    want = ref_ops.attention(*jx, block_q=blocks[0], block_k=blocks[1])
    assert_close(ops.attention(*tx), want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_256_gqa_softcap_matches_reference(dtype):
    """gemma2's attention: head dim 256, 8 query heads over 4 kv heads,
    causal, softcap 50."""
    jx, tx = qkv(1, 8, 4, 128, 256, seed=256, dtype=dtype)
    got = ops.attention(*tx, causal=True, softcap=50.0)
    assert_close(got, ref_ops.attention(*jx, causal=True, softcap=50.0),
                 dtype)
    assert_close(got, attention_ref(*jx, causal=True, softcap=50.0), dtype)


@pytest.mark.parametrize("S,causal,cap", [(200, True, 50.0), (77, True, None),
                                          (200, False, None)])
def test_ragged_lengths_match_oracle(S, causal, cap):
    jx, tx = qkv(2, 4, 2, S, 64, seed=S)
    got = ops.attention(*tx, causal=causal, softcap=cap)
    assert_close(got, attention_ref(*jx, causal=causal, softcap=cap),
                 "float32")


def test_noncausal_cross_lengths_match_oracle():
    jx, tx = qkv(1, 4, 2, 96, 128, seed=3, Sk=160)
    assert_close(ops.attention(*tx, causal=False),
                 attention_ref(*jx, causal=False), "float32")


def test_strided_views_match_contiguous():
    """The model hands (B, S, heads, D) activations over as (B, heads, S, D)
    views."""
    _, (q, k, v) = qkv(2, 8, 4, 64, 64, seed=5)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2)
             for x in (q, k, v)]
    torch.testing.assert_close(ops.attention(*views, softcap=50.0),
                               ops.attention(q, k, v, softcap=50.0),
                               rtol=0, atol=0)


def test_causal_needs_equal_lengths():
    _, tx = qkv(1, 2, 2, 64, 64, seed=0, Sk=128)
    with pytest.raises(ValueError, match="Sq == Sk"):
        ops.attention(*tx, causal=True)
    with pytest.raises(ValueError, match="Sq == Sk"):
        fa.attention_cuda(*tx, causal=True)


def test_bad_shapes_and_devices_raise():
    _, (q, k, v) = qkv(1, 6, 4, 32, 64, seed=0)
    with pytest.raises(ValueError, match="H % K"):
        ops.attention(q, k, v)
    _, tx = qkv(1, 4, 2, 32, 64, seed=0)
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.attention_cuda(*tx)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.attention(*(x.to("meta") for x in tx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 4, 4, 256, 64), (2, 8, 4, 200, 256),
                                   (1, 8, 2, 77, 128)])
def test_cuda_kernel_matches_plain_on_card(dtype, shape):
    """The CUDA kernel against its plain version, on the card, at ragged
    lengths and every instantiated head dim."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    B, H, K, S, D = shape
    _, tx = qkv(B, H, K, S, D, seed=S, dtype=dtype)
    q, k, v = (x.cuda() for x in tx)
    before = fa.launches
    got = fa.attention(q, k, v, causal=True, softcap=50.0)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.attention_plain(q, k, v, causal=True, softcap=50.0)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
