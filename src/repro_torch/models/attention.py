"""GQA attention: full-sequence (prefill and training) and decode (KV
cache) paths; counterpart of `repro.models.attention`.

Supports grouped-query attention (q heads grouped kv-major: head h reads
kv head h // q_per_kv), causal / bidirectional / prefix-LM masks, sliding
windows (gemma2 local layers), attention-logit softcapping and partial
RoPE. The full-sequence path goes through the flash-attention kernel
(`kernels.ops.attention`) with every mask; the reference's `attn_impl`
picks between two plain forms of the same function (`_attend` and
`_attend_blocked`), and the port needs neither on that path. Decode
stays plain torch (`_attend`), as the reference computes it with
einsums.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import ops
from ..sharding.planner import constrain, replicate_like
from .layers import apply_rope, softcap, weight
from .param import normal


class MaskSpec(NamedTuple):
    causal: bool = True
    window: Optional[int] = None     # sliding window size (local attention)
    prefix_len: int = 0              # bidirectional prefix (paligemma)


def init_attention(d_model, n_heads, n_kv_heads, head_dim, dtype,
                   generator=None, device=None):
    kw = dict(dtype=dtype, generator=generator, device=device)
    return {"wq": normal((d_model, n_heads, head_dim), **kw),
            "wk": normal((d_model, n_kv_heads, head_dim), **kw),
            "wv": normal((d_model, n_kv_heads, head_dim), **kw),
            "wo": normal((n_heads, head_dim, d_model), **kw)}


def _mask_bias(q_pos, k_pos, spec: MaskSpec, k_valid=None):
    """Additive mask bias (..., Sq, Sk) from position grids (a grid
    made here beside a DTensor one is replicated on its mesh)."""
    i = q_pos[..., :, None]
    j = replicate_like(k_pos, q_pos)[..., None, :]
    if spec.causal:
        allowed = j <= i
        if spec.prefix_len:
            allowed = allowed | ((i < spec.prefix_len)
                                 & (j < spec.prefix_len))
    else:
        allowed = replicate_like(torch.ones(
            torch.broadcast_shapes(i.shape, j.shape), dtype=torch.bool,
            device=i.device), i)
    if spec.window is not None:
        allowed = allowed & (j > i - spec.window)
    if k_valid is not None:
        allowed = allowed & replicate_like(k_valid, i)[..., None, :]
    zero = torch.zeros((), dtype=torch.float32, device=allowed.device)
    return torch.where(allowed, zero, torch.full_like(zero, -1e30))


def _attend(q, k, v, bias, n_kv, q_per_kv, cap):
    """q: (B,Sq,H,Dh) grouped kv-major; k,v: (B,Sk,K,Dh); bias:
    (B?,Sq,Sk)."""
    B, Sq, H, Dh = q.shape
    q = q.reshape(B, Sq, n_kv, q_per_kv, Dh)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).to(torch.float32)
    scores = scores * (Dh ** -0.5)
    scores = softcap(scores, cap)
    scores = scores + bias[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, Sq, H, Dh)


def _project(x, w):
    """x (B, S, d) @ w (d, heads, Dh) -> (B, S, heads, Dh). A DTensor w
    keeps only its heads shard (`weight`; a flatten of (heads, Dh)
    sharded within a head would have no DTensor layout)."""
    w = weight(w, x, (1,))
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _out_project(out, w):
    """out (B, S, heads, Dh) @ w (heads, Dh, d) -> (B, S, d)."""
    return out.flatten(2) @ weight(w, out, (0,)).flatten(0, 1)


def attention_full(p, x, positions, cfg, spec: MaskSpec):
    """Attention over a full sequence, for prefill and for training.
    Returns (out, (k, v)).

    Attention goes through `ops.attention` with the spec's mask
    (causal, window, prefix), whatever `cfg.attn_impl` says: the kernel
    forward under autograd on a CUDA tensor, the plain version on a CPU
    one, with `attention_backward` as the gradient on both.

    Under a plan q, k and v are constrained as the reference's are, on
    batch and heads, and the kernel runs on each rank's shard. Their
    sequence is not: the kernel's DTensor rule has no context-parallel
    strategy, so where the plan shards the sequence (heads that do not
    divide the model axis) it is gathered once, before the projections
    (DTensor also cannot flatten a batch- and sequence-sharded x into
    the product's rows on every torch version)."""
    x = constrain(x, ("batch", None, None))
    xq = constrain(_project(x, p["wq"]), ("batch", None, "heads", None))
    xk = constrain(_project(x, p["wk"]), ("batch", None, "kv_heads", None))
    xv = constrain(_project(x, p["wv"]), ("batch", None, "kv_heads", None))
    if cfg.rope_fraction > 0 and cfg.head_dim:
        xq = apply_rope(xq, positions, cfg.head_dim, cfg.rope_fraction,
                        cfg.rope_theta)
        xk = apply_rope(xk, positions, cfg.head_dim, cfg.rope_fraction,
                        cfg.rope_theta)
    out = ops.attention(xq.transpose(1, 2), xk.transpose(1, 2),
                        xv.transpose(1, 2), causal=spec.causal,
                        softcap=cfg.attn_softcap, window=spec.window,
                        prefix_len=spec.prefix_len).transpose(1, 2)
    out = constrain(_out_project(out, p["wo"]), ("batch", "seq", None))
    return out, (xk, xv)


def attention_decode(p, x, cache_k, cache_v, pos, cfg, spec: MaskSpec):
    """One-token decode. x: (B,1,D); cache_*: (B,Smax,K,Dh); pos: (B,)
    int32. Returns (out, (cache_k, cache_v)).

    Plain torch, as the reference computes decode with einsums outside
    any kernel. Unlike the reference's immutable `.at[].set`, the new k
    and v are written into the given caches in place, and the same
    tensors are returned. The cache keeps its own type (bf16) and is read
    back in x's type, as in the reference."""
    B = x.shape[0]
    Smax = cache_k.shape[1]
    xq = constrain(_project(x, p["wq"]), ("batch", None, "heads", None))
    xk = _project(x, p["wk"])
    xv = _project(x, p["wv"])
    if cfg.rope_fraction > 0 and cfg.head_dim:
        pp = pos[:, None]
        xq = apply_rope(xq, pp, cfg.head_dim, cfg.rope_fraction,
                        cfg.rope_theta)
        xk = apply_rope(xk, pp, cfg.head_dim, cfg.rope_fraction,
                        cfg.rope_theta)
    b_idx = torch.arange(B, device=x.device)
    pos_l = pos.to(torch.long)
    cache_k[b_idx, pos_l] = xk[:, 0].to(cache_k.dtype)
    cache_v[b_idx, pos_l] = xv[:, 0].to(cache_v.dtype)
    k_pos = torch.arange(Smax, device=x.device)[None, :]
    bias = _mask_bias(pos_l[:, None], k_pos, spec,
                      k_valid=(k_pos <= pos_l[:, None]))
    out = _attend(xq, cache_k.to(x.dtype), cache_v.to(x.dtype), bias,
                  cfg.n_kv_heads, cfg.q_per_kv, cfg.attn_softcap)
    out = _out_project(out, p["wo"])
    return out, (cache_k, cache_v)
