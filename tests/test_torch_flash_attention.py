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

bfloat16 CUDA calls go to the tensor-core kernel, which rounds the
probabilities to bf16 before the product with V. `tensor_core_emulation`
repeats that arithmetic on the CPU (test-only), so the rounding is held
against the reference here, where the kernel cannot run.
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
# bf16 errors held against the output's own size on the card: mean |err|
# within MEAN_REL of mean |want|, max |err| within MAX_REL of max |want|
# (chip_smoke.py's limits)
MEAN_REL, MAX_REL = 2.0 ** -8, 2.0 ** -6
# q scaled by this (exact in bf16) takes the scores (std 16) past caps of
# 30 and 50, where a wrong tanh shows; unscaled scores have std 1
HOT_SCALE = 16.0


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


def tensor_core_emulation(q, k, v, causal=True, softcap=None, block_k=64):
    """The arithmetic of `csrc/flash_attention_sm90.cu` in float32 torch:
    bf16 q and k with the products summed in f32; scale, softcap and mask;
    an online softmax over `block_k`-key tiles with f32 running max and
    sum (the sum over the unrounded p); p rounded to bf16 before an
    f32-accumulated product with bf16 v; the output in q's type."""
    B, H, K, Sq, Sk, D = fa._check(q, k, v, causal)
    bf = torch.bfloat16
    qg = q.to(bf).float().reshape(B, K, H // K, Sq, D)
    kf, vf = k.to(bf).float(), v.to(bf).float()
    m = torch.full((B, K, H // K, Sq, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, K, H // K, Sq, D))
    q_pos = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = torch.einsum("bkgsd,bktd->bkgst", qg, kt) * (D ** -0.5)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        if causal:
            k_pos = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = torch.where(k_pos <= q_pos, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bkgst,bktd->bkgsd",
                                         p.to(bf).float(), vt)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, H, Sq, D).to(q.dtype)


@pytest.mark.parametrize("bhsd", [(1, 4, 256, 64), (2, 8, 256, 128)])
def test_tensor_core_rounding_matches_reference_bf16(bhsd):
    """tests/test_kernels.py's bf16 shapes (MHA, causal): the tensor-core
    kernel's arithmetic, p rounded to bf16, against the Pallas kernel
    (interpret mode) and the oracle within bf16 2e-2."""
    B, H, S, D = bhsd
    jx, tx = qkv(B, H, H, S, D, seed=S + D, dtype="bfloat16")
    got = tensor_core_emulation(*tx, causal=True)
    assert_close(got, ref_ops.attention(*jx, causal=True), "bfloat16")
    assert_close(got, attention_ref(*jx, causal=True), "bfloat16")


@pytest.mark.parametrize("causal,cap,q_scale", [
    (True, 50.0, 1.0), (True, None, 1.0), (False, 30.0, 1.0),
    (True, 50.0, HOT_SCALE), (False, 30.0, HOT_SCALE)])
def test_tensor_core_rounding_head_dim_256_gqa(causal, cap, q_scale):
    """gemma2's attention shape (D 256, 8 query heads over 4 kv heads,
    softcap 50) and the other mask modes the kernel takes; with q scaled
    by HOT_SCALE the scores pass the cap."""
    jx, tx = qkv(1, 8, 4, 256, 256, seed=257, dtype="bfloat16")
    jx, tx = (jx[0] * q_scale,) + jx[1:], (tx[0] * q_scale,) + tx[1:]
    got = tensor_core_emulation(*tx, causal=causal, softcap=cap)
    assert_close(got, ref_ops.attention(*jx, causal=causal, softcap=cap),
                 "bfloat16")
    assert_close(got, attention_ref(*jx, causal=causal, softcap=cap),
                 "bfloat16")


@pytest.mark.parametrize("S,cap", [(77, 50.0), (200, None)])
def test_tensor_core_rounding_ragged_matches_plain(S, cap):
    """Ragged lengths (a last tile shorter than 64 keys) against the
    oracle and the port's plain version."""
    jx, tx = qkv(2, 8, 4, S, 256, seed=S, dtype="bfloat16")
    got = tensor_core_emulation(*tx, causal=True, softcap=cap)
    assert_close(got, attention_ref(*jx, causal=True, softcap=cap),
                 "bfloat16")
    want = fa.attention_plain(*tx, causal=True, softcap=cap)
    assert_close(got, want.float().numpy(), "bfloat16")


@pytest.mark.parametrize("D", fa.KERNEL_HEAD_DIMS)
def test_route_by_type(D):
    """bfloat16 goes to the tensor-core kernel, float32 to the SIMT one."""
    assert fa._route(torch.bfloat16, D) == "sm90"
    assert fa._route(torch.float32, D) == "simt"


@pytest.mark.parametrize("dtype,D", [(torch.float16, 128),
                                     (torch.float64, 64),
                                     (torch.int32, 64),
                                     (torch.bfloat16, 96),
                                     (torch.float32, 32)])
def test_route_raises_on_anything_else(dtype, D):
    with pytest.raises(ValueError):
        fa._route(dtype, D)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_raises_for_head_dim_96(dtype):
    """96 lies between the instantiated 80 and 112: neither kernel takes
    it, whatever the type."""
    with pytest.raises(ValueError, match="head dims"):
        fa._route(dtype, 96)


# (dtype, (B, H, K, S, D), causal, softcap, strided (B, S, heads, D) views,
# q scale): ragged lengths at every head dim in both types, then bf16 at
# every head dim, 1, 2 and 4 kv heads, ragged and tile-multiple lengths,
# then softcap cases whose scores pass the cap (the serving shape first)
CARD_CASES = (
    [(dt, shape, True, 50.0, False, 1.0) for dt in ("float32", "bfloat16")
     for shape in ((1, 4, 4, 256, 64), (2, 8, 4, 200, 256),
                   (1, 8, 2, 77, 128), (1, 8, 4, 300, 112))]
    + [("bfloat16", (1, 8, (1, 2, 4)[(i + i // 3) % 3], S, D), causal, cap,
        i % 2 == 1, 1.0)
       for i, (D, S, (causal, cap)) in enumerate(
           (D, S, mode) for D in (64, 112, 128, 256)
           for S in (77, 200, 2048, 2049)
           for mode in ((True, None), (True, 50.0), (False, 30.0)))]
    + [("bfloat16", (4, 8, 4, 2048, 256), True, 50.0, True, HOT_SCALE),
       ("bfloat16", (1, 8, 2, 2049, 128), False, 30.0, True, HOT_SCALE),
       ("bfloat16", (1, 8, 4, 2048, 64), False, 30.0, False, HOT_SCALE),
       ("bfloat16", (2, 8, 4, 77, 256), True, 50.0, False, HOT_SCALE),
       ("bfloat16", (1, 8, 1, 200, 64), True, 50.0, True, HOT_SCALE),
       ("float32", (1, 8, 4, 512, 256), True, 50.0, False, HOT_SCALE)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,causal,cap,views,q_scale", CARD_CASES)
def test_cuda_kernel_matches_plain_on_card(dtype, shape, causal, cap, views,
                                           q_scale):
    """The CUDA kernels against their plain version, on the card, at ragged
    lengths and every instantiated head dim: bfloat16 through the
    tensor-core kernel, float32 through the SIMT one, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    B, H, K, S, D = shape
    _, tx = qkv(B, H, K, S, D, seed=S, dtype=dtype)
    tx = (tx[0] * q_scale,) + tx[1:]
    if views:
        tx = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in tx]
    q, k, v = (x.cuda() for x in tx)
    before = (fa.launches, fa.launches_sm90, fa.launches_simt)
    got = fa.attention(q, k, v, causal=causal, softcap=cap)
    torch.cuda.synchronize()
    sm90 = dtype == "bfloat16"
    assert (fa.launches, fa.launches_sm90, fa.launches_simt) == (
        before[0] + 1, before[1] + sm90, before[2] + (not sm90))
    want = fa.attention_plain(q, k, v, causal=causal, softcap=cap)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == "bfloat16":
        err, size = (got.float() - want.float()).abs(), want.float().abs()
        assert float(err.mean()) <= MEAN_REL * float(size.mean())
        assert float(err.max()) <= MAX_REL * float(size.max())
