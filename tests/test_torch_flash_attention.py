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

The gradient's kernels skip the tiles the mask removes and form each
row's statistics in a pass of their own. `backward_kernel_emulation`
repeats the f32 route's schedule (`csrc/flash_attention_bwd.h`) on the
CPU against `attention_backward_plain` (f32, 2e-5 of each gradient's
max); `backward_tensor_core_emulation` repeats the bf16 route's
(`csrc/flash_attention_bwd_bf16.cu`: bf16 products with f32 sums, P and
dS as bf16 hi/lo pairs or triples, its tiles and tile ranges) against the plain version
within the card's bf16 criteria and against `jax.grad` of the
reference's `_attend`. The `cuda`-marked tests hold the kernels against
the plain version on a card.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro.models import attention as RA

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


# ---------------------------------------------------------------------------
# The backward kernel (csrc/flash_attention_bwd.h)
# ---------------------------------------------------------------------------


def backward_kernel_emulation(q, k, v, dout, causal=True, softcap=None,
                              window=None, prefix_len=0, bq=64, bk=32):
    """The schedule of `csrc/flash_attention_bwd.h` in float32 torch
    (test-only): (1) per 64-row query tile, over the key tiles the
    forward's range keeps, a pass for each row's max m, sum l and
    D = sum exp(s - m) dP / l (online), then a pass for dq = sum dS K;
    (2) per 32-key tile, over the query tiles the mask lets read it, the
    group's query heads in order, dv += P^T dO and dk += dS^T Q with P
    and dS from the stored m, l and D. Tiles outside those ranges are
    never visited, so a wrong range loses gradient here."""
    B, H, K, Sq, Sk, D = fa._check(q, k, v, causal, window, prefix_len)
    G, scale = H // K, D ** -0.5
    win = fa.kernel_window(Sk, window)
    qf, kf, vf, df = (x.float() for x in (q, k, v, dout))
    allowed = fa.allowed_mask(Sq, Sk, causal, window, prefix_len)
    if allowed is None:
        allowed = torch.ones(Sq, Sk, dtype=torch.bool)

    def scores(qt, kt, rows, keys):
        s = torch.einsum("bhsd,bhtd->bhst", qt, kt) * scale
        t = torch.zeros_like(s)
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s = softcap * t
        return torch.where(allowed[rows][:, keys], s,
                           torch.tensor(-1e30)), t

    kv_heads = torch.arange(H) // G
    m = torch.zeros(B, H, Sq)
    l, drow = torch.zeros_like(m), torch.zeros_like(m)
    dq = torch.zeros(B, H, Sq, D)
    for q0 in range(0, Sq, bq):
        rows = slice(q0, min(q0 + bq, Sq))
        end = min(Sk, max(q0 + bq, prefix_len if q0 < prefix_len else 0)) \
            if causal else Sk
        begin = max(0, q0 - win + 1) // bk * bk if win else 0
        mi = torch.full((B, H, rows.stop - q0, 1), -1e30)
        li, di = torch.zeros_like(mi), torch.zeros_like(mi)
        for k0 in range(begin, end, bk):
            keys = slice(k0, min(k0 + bk, Sk))
            s, _ = scores(qf[:, :, rows], kf[:, kv_heads, keys], rows, keys)
            dp = torch.einsum("bhsd,bhtd->bhst", df[:, :, rows],
                              vf[:, kv_heads, keys])
            m_new = torch.maximum(mi, s.amax(-1, keepdim=True))
            alpha, p = torch.exp(mi - m_new), torch.exp(s - m_new)
            li = alpha * li + p.sum(-1, keepdim=True)
            di = alpha * di + (p * dp).sum(-1, keepdim=True)
            mi = m_new
        m[:, :, rows], l[:, :, rows] = mi[..., 0], li[..., 0]
        drow[:, :, rows] = (di / li)[..., 0]
        for k0 in range(begin, end, bk):
            keys = slice(k0, min(k0 + bk, Sk))
            s, t = scores(qf[:, :, rows], kf[:, kv_heads, keys], rows, keys)
            dp = torch.einsum("bhsd,bhtd->bhst", df[:, :, rows],
                              vf[:, kv_heads, keys])
            p = torch.exp(s - mi) / li
            ds = p * (dp - di / li) * (1.0 - t * t) * scale
            dq[:, :, rows] += torch.einsum("bhst,bhtd->bhsd", ds,
                                           kf[:, kv_heads, keys])
    dk, dv = torch.zeros(B, K, Sk, D), torch.zeros(B, K, Sk, D)
    for k0 in range(0, Sk, bk):
        keys = slice(k0, min(k0 + bk, Sk))
        begin = min(k0, Sq) if causal and k0 >= prefix_len else 0
        end = min(Sq, k0 + bk - 1 + win) if win else Sq
        for g in range(G):
            heads = torch.arange(K) * G + g
            for q0 in range(begin, end, bq):
                rows = slice(q0, min(q0 + bq, Sq))
                s, t = scores(qf[:, heads, rows], kf[:, :, keys], rows, keys)
                dp = torch.einsum("bhsd,bhtd->bhst", df[:, heads, rows],
                                  vf[:, :, keys])
                p = torch.exp(s - m[:, heads, rows, None]) / \
                    l[:, heads, rows, None]
                ds = p * (dp - drow[:, heads, rows, None]) * (1.0 - t * t) \
                    * scale
                dv[:, :, keys] += torch.einsum("bhst,bhsd->bhtd", p,
                                               df[:, heads, rows])
                dk[:, :, keys] += torch.einsum("bhst,bhsd->bhtd", ds,
                                               qf[:, heads, rows])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# (B, H, K, S, causal, window, prefix, softcap): ragged lengths, windows
# at and off the 32-key and 64-row tiles (1 sees only itself), prefixes
# inside and past a tile, bidirectional with a window, groups 1, 2, 4, 7
BWD_CASES = [
    (2, 4, 2, 77, True, None, 0, 50.0),
    (1, 4, 4, 130, True, 1, 0, None),
    (1, 4, 1, 130, True, 31, 0, 30.0),
    (1, 8, 2, 130, True, 65, 0, None),
    (1, 4, 2, 130, True, None, 20, 50.0),
    (1, 4, 2, 100, True, 33, 70, None),
    (2, 7, 1, 96, False, None, 0, 30.0),
    (1, 4, 2, 130, False, 40, 0, None),
]


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_backward_kernel_schedule_matches_plain(case):
    """The kernel's schedule and arithmetic (`backward_kernel_emulation`)
    against `attention_backward_plain`, f32, within 2e-5 of each
    gradient's largest value, on masks whose ranges cut tiles."""
    B, H, K, S, causal, window, prefix, cap = case
    _, (q, k, v) = qkv(B, H, K, S, 16, seed=S + H)
    q = q * 4.0         # scores near and past the caps
    dout = torch.from_numpy(np.random.default_rng(S).standard_normal(
        (B, H, S, 16)).astype(np.float32))
    mask = dict(causal=causal, softcap=cap, window=window, prefix_len=prefix)
    got = backward_kernel_emulation(q, k, v, dout, **mask)
    want = fa.attention_backward_plain(q, k, v, dout, **mask)
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= 2e-5 * scale


def backward_tensor_core_emulation(q, k, v, dout, causal=True,
                                   softcap=None, window=None, prefix_len=0):
    """The schedule and arithmetic of `csrc/flash_attention_bwd_bf16.cu`
    in float32 torch (test-only), on bf16 inputs. Products take bf16
    values and sum in f32; scores are in log2 units.
    (1) per 64-row block over the key tiles of its range (32 keys a tile
    at D 256, else 64), taken in turn by two consumers: a pass for each
    row's lse = m + log2 l and D = sum exp2(x - m) dP / l (online, each
    consumer's partial sums merged, the first's first), then dS =
    P (dP - D) (1 - t^2) scale with P = exp2(x - lse) on the allowed pairs
    and dq += dS K, each consumer's sum, then the first's plus the
    second's.
    (2) per 64-key block, the group's query heads in order and each
    one's 64-row query tiles in the mask's range: dV += P^T dO; dS^T =
    P (1 - t^2) scale in f32 times (dP^T - D), dK += dS^T Q.
    P and dS enter dV and dK as bf16 hi/lo pairs, hi + lo (two products
    each), dS enters dQ as a bf16 triple (three). Tiles outside those ranges are never visited,
    so a wrong range loses gradient here."""
    B, H, K, Sq, Sk, D = fa._check(q, k, v, causal, window, prefix_len)
    G, scale, log2e = H // K, D ** -0.5, 1.4426950408889634
    bf = torch.bfloat16
    win = fa.kernel_window(Sk, window)
    bn = 32 if D > 128 else 64
    qf, kf, vf, df = (x.to(bf).float() for x in (q, k, v, dout))
    allowed = fa.allowed_mask(Sq, Sk, causal, window, prefix_len)
    if allowed is None:
        allowed = torch.ones(Sq, Sk, dtype=torch.bool)
    rnd = lambda x: x.to(bf).float()
    hilo = lambda x: (rnd(x), rnd(x - rnd(x)))
    triple = lambda x: (rnd(x), rnd(x - rnd(x)),
                        rnd(x - rnd(x) - rnd(x - rnd(x))))

    def scores(qt, kt, rows, keys):
        """x (log2 units), t and the allowed pairs of rows x keys."""
        s = torch.einsum("bhsd,bhtd->bhst", qt, kt)
        t = torch.zeros_like(s)
        if softcap is not None:
            t = torch.tanh(s * (scale / softcap))
            x = softcap * log2e * t
        else:
            x = s * (scale * log2e)
        return x, t, allowed[rows][:, keys]

    def key_range(r0, rows):
        """The forward's key tiles of rows r0 .. r0 + rows - 1."""
        end = min(Sk, max(r0 + rows, prefix_len if r0 < prefix_len else 0)) \
            if causal else Sk
        begin = max(0, r0 - win + 1) if win else 0
        return range(begin // bn * bn, end, bn)

    kv_heads = torch.arange(H) // G
    lse = torch.zeros(B, H, Sq)
    drow = torch.zeros(B, H, Sq)
    dq = torch.zeros(B, H, Sq, D)
    for q0 in range(0, Sq, 64):
        rows = slice(q0, min(q0 + 64, Sq))
        n = rows.stop - q0
        tiles = list(key_range(q0, 64))

        def tile_scores(k0):
            keys = slice(k0, min(k0 + bn, Sk))
            x, t, ok = scores(qf[:, :, rows], kf[:, kv_heads, keys], rows,
                              keys)
            dp = torch.einsum("bhsd,bhtd->bhst", df[:, :, rows],
                              vf[:, kv_heads, keys])
            return keys, x, t, ok, dp

        parts = []
        for wg in (0, 1):  # each consumer's tiles, then merged
            m = torch.full((B, H, n, 1), -1e30)
            l, dd = torch.zeros_like(m), torch.zeros_like(m)
            for k0 in tiles[wg::2]:
                _, x, _, ok, dp = tile_scores(k0)
                x = torch.where(ok, x, torch.tensor(-1e30))
                m_new = torch.maximum(m, x.amax(-1, keepdim=True))
                alpha, e = torch.exp2(m - m_new), torch.exp2(x - m_new)
                l = alpha * l + e.sum(-1, keepdim=True)
                dd = alpha * dd + (e * dp).sum(-1, keepdim=True)
                m = m_new
            parts.append((m, l, dd))
        (m0, l0, d0), (m1, l1, d1) = parts
        mm = torch.maximum(m0, m1)
        a0, a1 = torch.exp2(m0 - mm), torch.exp2(m1 - mm)
        ll, dsum = l0 * a0 + l1 * a1, d0 * a0 + d1 * a1
        lse[:, :, rows] = (mm + torch.log2(ll))[..., 0]
        drow[:, :, rows] = (dsum / ll)[..., 0]
        acc = [torch.zeros(B, H, n, D), torch.zeros(B, H, n, D)]
        for i, k0 in enumerate(tiles):  # pass 2: tile u = n + i, (u % 2)'s
            keys, x, t, ok, dp = tile_scores(k0)
            p = torch.where(ok, torch.exp2(x - lse[:, :, rows, None]), 0.0)
            ds = p * (dp - drow[:, :, rows, None]) * (1.0 - t * t) * scale
            for part in triple(ds):
                acc[(len(tiles) + i) % 2] += torch.einsum(
                    "bhst,bhtd->bhsd", part, kf[:, kv_heads, keys])
        dq[:, :, rows] = acc[0] + acc[1]
    dk, dv = torch.zeros(B, K, Sk, D), torch.zeros(B, K, Sk, D)
    for k0 in range(0, Sk, 64):
        keys = slice(k0, min(k0 + 64, Sk))
        begin = k0 if causal and k0 >= prefix_len else 0
        end = min(Sq, k0 + 63 + win) if win else Sq
        for g in range(G):
            heads = torch.arange(K) * G + g
            for q0 in range(begin, end, 64):
                rows = slice(q0, min(q0 + 64, Sq))
                x, t, ok = scores(qf[:, heads, rows], kf[:, :, keys], rows,
                                  keys)
                dp = torch.einsum("bhsd,bhtd->bhst", df[:, heads, rows],
                                  vf[:, :, keys])
                p = torch.where(ok, torch.exp2(
                    x - lse[:, heads, rows, None]), 0.0)
                f = p * (1.0 - t * t) * scale
                ds = f * (dp - drow[:, heads, rows, None])
                for part in hilo(p):
                    dv[:, :, keys] += torch.einsum("bhst,bhsd->bhtd", part,
                                                   df[:, heads, rows])
                for part in hilo(ds):
                    dk[:, :, keys] += torch.einsum("bhst,bhsd->bhtd", part,
                                                   qf[:, heads, rows])
    return dq.to(bf), dk.to(bf), dv.to(bf)


def bf16_close(got, want):
    """The card's bf16 criteria for a gradient: mean |err| within MEAN_REL
    of mean |want|, max |err| within MAX_REL of max |want|."""
    err, size = (got.float() - want.float()).abs(), want.float().abs()
    assert float(err.mean()) <= MEAN_REL * float(size.mean())
    assert float(err.max()) <= MAX_REL * float(size.max())


def bwd_inputs(B, H, K, S, D, seed, q_scale):
    """bf16 q, k, v and dout from numpy draws (dout's from seed + 1)."""
    _, (q, k, v) = qkv(B, H, K, S, D, seed=seed, dtype="bfloat16")
    dout = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (B, H, S, D)).astype(np.float32)).to(torch.bfloat16)
    return q * q_scale, k, v, dout


# BWD_CASES at the kernels' smallest head dim, and gemma2's attention with
# hot scores: D 256, 8 query heads over 4 kv heads, softcap 50, q scaled
# by HOT_SCALE (the scores pass the cap)
TC_BWD_CASES = [c + (64, 4.0) for c in BWD_CASES] + [
    (1, 8, 4, 160, True, None, 0, 50.0, 256, HOT_SCALE),
    (1, 8, 4, 160, True, 100, 0, 30.0, 256, 1.0)]


@pytest.mark.parametrize("case", TC_BWD_CASES, ids=str)
def test_backward_tensor_core_emulation_matches_plain(case):
    """The bf16 route's schedule and arithmetic
    (`backward_tensor_core_emulation`) against `attention_backward_plain`
    on the same bf16 inputs, within the bf16 criteria chip_smoke.py holds
    the kernel to (MEAN_REL, MAX_REL), on masks whose ranges cut tiles."""
    B, H, K, S, causal, window, prefix, cap, D, q_scale = case
    q, k, v, dout = bwd_inputs(B, H, K, S, D, S + H + D, q_scale)
    mask = dict(causal=causal, softcap=cap, window=window, prefix_len=prefix)
    got = backward_tensor_core_emulation(q, k, v, dout, **mask)
    want = fa.attention_backward_plain(q, k, v, dout, **mask)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        bf16_close(g, w)


# (H, K, S, D, causal, window, prefix, softcap): the reference's einsum
# attention on bf16 inputs, every mask kind
REF_BWD_CASES = [
    (8, 4, 96, 256, True, None, 0, 50.0),
    (4, 2, 100, 64, True, 33, 0, None),
    (4, 1, 80, 128, True, None, 20, 30.0),
    (4, 2, 70, 64, False, 40, 0, None),
]
# the reference rounds its scores to bf16 before the softmax (its bf16
# einsum's output), so its gradient is off the f32 one by more than the
# kernel's: mean |err| within 2^-7 of mean |want|, max within 2^-5 of
# the max (the kernel against the plain version: 2^-8 and 2^-6)
REF_MEAN_REL, REF_MAX_REL = 2.0 ** -7, 2.0 ** -5


@pytest.mark.parametrize("case", REF_BWD_CASES, ids=str)
def test_backward_tensor_core_emulation_matches_jax_grad(case):
    """The bf16 route's arithmetic against `jax.grad` of the reference's
    `_mask_bias` + `_attend` (src/repro/models/attention.py) on the same
    bf16 values, (B, S, heads, D) on the reference's side."""
    H, K, S, D, causal, window, prefix, cap = case
    q, k, v, dout = bwd_inputs(1, H, K, S, D, S + D, 1.0)
    spec = RA.MaskSpec(causal=causal, window=window, prefix_len=prefix)

    def loss(qj, kj, vj):
        pos = jnp.arange(S)[None]
        out = RA._attend(qj, kj, vj, RA._mask_bias(pos, pos, spec), K,
                         H // K, cap)
        return jnp.sum(out.astype(jnp.float32) * to_jax(dout))

    def to_jax(x):
        return jnp.asarray(x.float().transpose(1, 2).numpy(), jnp.bfloat16)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(to_jax(x) for x in (q, k, v)))
    got = backward_tensor_core_emulation(q, k, v, dout, causal=causal,
                                         softcap=cap, window=window,
                                         prefix_len=prefix)
    for g, w in zip(got, want):
        w = torch.from_numpy(np.asarray(w, np.float32)).transpose(1, 2)
        err, size = (g.float() - w).abs(), w.abs()
        assert float(err.mean()) <= REF_MEAN_REL * float(size.mean())
        assert float(err.max()) <= REF_MAX_REL * float(size.max())


def test_backward_routes_by_device():
    """CPU tensors take the plain version (the same bits as calling it),
    one operator a call; the CUDA entry raises on CPU tensors, and a
    device with no kernel raises."""
    _, (q, k, v) = qkv(1, 4, 2, 40, 16, seed=2)
    dout = torch.ones_like(q)
    got = fa.attention_backward(q, k, v, dout, softcap=30.0, window=9)
    want = fa.attention_backward_plain(q, k, v, dout, softcap=30.0, window=9)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    before = fa.launches_backward
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.attention_backward_cuda(q, k, v, dout)
    with pytest.raises(ValueError, match="no kernel for device"):
        fa.attention_backward(*(x.to("meta") for x in (q, k, v, dout)))
    assert fa.launches_backward == before


# (dtype, (B, H, K, S, D), causal, window, prefix, softcap, views): every
# head dim in both types, groups 1 to 16 and 7, ragged lengths, masks
CARD_BWD_CASES = (
    [(dt, (1, 8, (1, 2, 4, 8)[i % 4], S, D), causal, window, prefix, cap,
      i % 2 == 0)
     for i, (dt, D, (S, causal, window, prefix, cap)) in enumerate(
         (dt, D, m) for dt in ("float32", "bfloat16")
         for D in fa.KERNEL_HEAD_DIMS
         for m in ((77, True, None, 0, 50.0), (200, True, 65, 0, None),
                   (300, True, None, 77, 30.0), (130, False, 40, 0, None)))]
    + [("bfloat16", (1, 32, 2, 257, 128), True, None, 0, None, True),
       ("bfloat16", (1, 56, 8, 129, 128), True, None, 0, None, True),
       ("bfloat16", (1, 8, 4, 2048, 256), True, None, 0, 50.0, True)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,causal,window,prefix,cap,views",
                         CARD_BWD_CASES)
def test_cuda_backward_matches_plain_on_card(dtype, shape, causal, window,
                                             prefix, cap, views):
    """The backward kernel against `attention_backward_plain` on the
    card: f32 within 2e-5 of each gradient's largest value, bf16 within
    the forward's relative limits; one launch a call, the same bits
    twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    B, H, K, S, D = shape
    _, tx = qkv(B, H, K, S, D, seed=S + D, dtype=dtype)
    dout = torch.randn(B, H, S, D, generator=torch.Generator().manual_seed(
        S)).to(getattr(torch, dtype))
    if views:
        tx = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in tx]
    q, k, v, do = (x.cuda() for x in (*tx, dout))
    mask = dict(causal=causal, softcap=cap, window=window, prefix_len=prefix)
    before = fa.launches_backward
    got = fa.attention_backward(q, k, v, do, **mask)
    again = fa.attention_backward(q, k, v, do, **mask)
    torch.cuda.synchronize()
    assert fa.launches_backward == before + 2
    want = fa.attention_backward_plain(q, k, v, do, **mask)
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype and torch.equal(g, a)
        err, size = (g.float() - w.float()).abs(), w.float().abs()
        if dtype == "float32":
            assert float(err.max()) <= 2e-5 * float(size.max())
        else:
            assert float(err.mean()) <= MEAN_REL * float(size.mean())
            assert float(err.max()) <= MAX_REL * float(size.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_unaligned_inputs_on_card(dtype):
    """Inputs whose storage starts one element past an allocation: the
    f32 kernel takes them with its element-by-element tile loads; the
    bf16 wrapper copies them to fresh dense tensors first (`_tma_ready`:
    the TMA unit needs 16-byte aligned tiles) and launches the same
    kernel. Either way, the same bits as the same values aligned."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, tx = qkv(1, 8, 2, 200, 128, seed=11, dtype=dtype)
    dout = torch.randn(1, 8, 200, 128, generator=torch.Generator(
    ).manual_seed(12)).to(getattr(torch, dtype))
    aligned = [x.cuda() for x in (*tx, dout)]

    def skewed(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        return buf[1:].view(x.shape).copy_(x)

    mask = dict(causal=True, softcap=50.0, window=65)
    want = fa.attention_backward(*aligned, **mask)
    got = fa.attention_backward(*(skewed(x) for x in aligned), **mask)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
