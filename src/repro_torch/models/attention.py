"""GQA attention: full-sequence (prefill and training) and decode (KV
cache) paths; counterpart of `repro.models.attention`.

Supports grouped-query attention (q heads grouped kv-major: head h reads
kv head h // q_per_kv), causal / bidirectional / prefix-LM masks, sliding
windows (gemma2 local layers), attention-logit softcapping and partial
RoPE. The full-sequence path goes through the flash-attention kernels
(`kernels.ops.attention`, forward and backward) with every mask; the
reference's `attn_impl` picks between two plain forms of the same
function (`_attend` and `_attend_blocked`, a scan over key blocks), and
the port's attention is blocked on both passes whichever it names. Decode
stays plain torch (`_attend`), as the reference computes it with
einsums.

On a placed cache (DTensors by `Plan.cache_spec_tree`) decode writes and
reads each rank's shard. A cache sharded on its batch or its kv heads
(or replicated) runs the same ops on every rank's shard
(`_attend_local`). A cache
sharded on its sequence (kv heads that do not divide "model") is
written only by the rank that holds the position, and each rank attends
over its own slice of the sequence, keeping a partial max, sum and
weighted V, which a log-sum-exp combine reduces across the sequence's
mesh dims (`_attend_seq_sharded`: all-reduces of (B, K, G, 1, Dh) and
smaller; the reference's softmax over a sharded axis, as GSPMD
partitions it). The cache itself never moves.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import is_dtensor
from ..kernels import ops
from ..sharding.planner import (constrain, follow, on_shards,
                                replicate_like, shard_range)
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


def _attend_partial(q, k, v, bias, cap):
    """`_attend` over one slice of the keys, unnormalized: (m, l, o) with
    m (B, K, G, Sq, 1) the slice's largest score, l the sum of exp(s - m)
    and o the exp(s - m)-weighted V (B, K, G, Sq, Dh), f32. q (B, Sq, H,
    Dh) with H = K G, kv-major."""
    B, Sq, H, Dh = q.shape
    K = k.shape[2]
    q = q.reshape(B, Sq, K, H // K, Dh)
    s = torch.einsum("bskgd,btkd->bkgst", q, k).to(torch.float32)
    s = softcap(s * (Dh ** -0.5), cap) + bias[:, None, None, :, :]
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype), v)
    return m, p.sum(-1, keepdim=True), o.to(torch.float32)


def _attend_local(q, k, v, bias, q_per_kv, cap):
    """`_attend` with DTensor k and v sharded on their batch or kv heads
    (or replicated), as plain torch on each rank's shards (`on_shards`):
    q and the bias cut to its rows and kv heads (no collective, unless
    q's heads lie otherwise). An einsum over DTensors would flatten the
    batch with a sharded kv-head dim, which not every torch version's
    DTensor can do."""
    n_kv = k.to_local().shape[2]
    return on_shards(
        lambda k, v, q, b: _attend(q, k, v, b, n_kv, q_per_kv, cap),
        [(k, (0, 1, 2, 3)), (v, (0, 1, 2, 3)), (q, (0, None, 2, 3)),
         (bias, (0, None, 1))], [(0, None, 2, 3)])


def _attend_seq_sharded(q, k, v, bias, cap):
    """`_attend` with DTensor k and v sharded on their sequence (dim 1;
    maybe also on the batch, dim 0, and the kv heads, dim 2): each rank
    attends over its own keys (`_attend_partial`: q and the bias cut to
    the cache's batch and heads, the bias to its keys, no collective but
    a gather of q's heads where the cache holds them all), and the
    partials are combined over the mesh dims that shard the sequence:
    M = max m, L = sum l exp(m - M), O = sum o exp(m - M), out = O / L,
    three all-reduces of small tensors. Returns (B, Sq, H, Dh) in v's
    type."""
    from torch.distributed.tensor import DTensor, Partial
    mesh, plc = k.device_mesh, tuple(k.placements)
    q_plc, b_plc = follow(plc, (0, None, 2, 3)), follow(plc, (0, None, 1))
    # the partials' (B, K, G, Sq, .) placements, less the sequence's
    o_plc = follow(plc, (0, 2, None, None, 3))
    m, l, o = _attend_partial(
        q.redistribute(mesh, q_plc).to_local(), k.to_local(), v.to_local(),
        bias.redistribute(mesh, b_plc).to_local(), cap)

    def total(t, op):
        part = tuple(Partial(op) if p.is_shard(1) else c
                     for p, c in zip(plc, o_plc))
        return DTensor.from_local(t, mesh, part, run_check=False).redistribute(
            mesh, o_plc).to_local()

    w = torch.exp(m - total(m, "max"))
    out = total(o * w, "sum") / total(l * w, "sum")
    out = DTensor.from_local(out.to(v.dtype), mesh, o_plc, run_check=False)
    B, K, G, Sq, Dh = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, K * G, Dh)


def _seq_sharded(cache) -> bool:
    return is_dtensor(cache) and any(p.is_shard(1) for p in cache.placements)


def _write_at(cache, new, pos):
    """cache[b, pos[b]] = new[b] for every row b: cache (B, Smax, K, Dh),
    new (B, K, Dh), pos (B,) long. A DTensor cache is written on each
    rank's own shard (new and pos cut to its batch and heads, no
    collective); where it is sharded on its sequence only the rank that
    holds pos[b] writes row b, and the others write back what they
    hold."""
    if not is_dtensor(cache):
        cache[torch.arange(cache.shape[0], device=cache.device), pos] = new
        return
    mesh, plc = cache.device_mesh, tuple(cache.placements)
    new = new.redistribute(mesh, follow(plc, (0, 2, 3))).to_local()
    pos = pos.redistribute(mesh, follow(plc, (0,))).to_local()
    local = cache.to_local()
    b = torch.arange(local.shape[0], device=local.device)
    if not _seq_sharded(cache):
        local[b, pos] = new
        return
    lo, n = shard_range(cache.shape[1], plc, mesh, 1)
    j = pos - lo
    hit = ((j >= 0) & (j < n))[:, None, None]
    j = torch.clamp(j, 0, n - 1)
    local[b, j] = torch.where(hit, new, local[b, j])


def write_prefix(cache, new):
    """cache[:, :S] = new, new (B, S, K, Dh); a DTensor cache on each
    rank's shard (new cut to its placements, its sequence to the rank's
    positions; no collective)."""
    S = new.shape[1]
    if not is_dtensor(cache):
        cache[:, :S] = new
        return
    mesh, plc = cache.device_mesh, tuple(cache.placements)
    new = new.redistribute(mesh, follow(plc, (0, None, 2, 3))).to_local()
    lo, n = shard_range(cache.shape[1], plc, mesh, 1)
    m = max(0, min(n, S - lo))
    cache.to_local()[:, :m] = new[:, lo: lo + m]


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
    one, with `attention_backward` as the gradient (the backward kernel,
    or on the CPU its plain version).

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
    pos_l = pos.to(torch.long)
    _write_at(cache_k, xk[:, 0].to(cache_k.dtype), pos_l)
    _write_at(cache_v, xv[:, 0].to(cache_v.dtype), pos_l)
    k_pos = replicate_like(torch.arange(Smax, device=x.device),
                           pos_l)[None, :]
    bias = _mask_bias(pos_l[:, None], k_pos, spec,
                      k_valid=(k_pos <= pos_l[:, None]))
    k, v = cache_k.to(x.dtype), cache_v.to(x.dtype)
    if _seq_sharded(cache_k):
        out = _attend_seq_sharded(xq, k, v, bias, cfg.attn_softcap)
    elif is_dtensor(k):
        out = _attend_local(xq, k, v, bias, cfg.q_per_kv, cfg.attn_softcap)
    else:
        out = _attend(xq, k, v, bias, cfg.n_kv_heads, cfg.q_per_kv,
                      cfg.attn_softcap)
    # the row-parallel product's partial sum reduced, as attention_full
    # reduces it: the next layer's k and v are cast to the cache's type
    out = constrain(_out_project(out, p["wo"]), ("batch", "seq", None))
    return out, (cache_k, cache_v)
