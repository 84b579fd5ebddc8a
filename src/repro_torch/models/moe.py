"""Mixture-of-Experts layer with capacity; counterpart of
`repro.models.moe`.

olmoe: 64 experts, top-8. arctic: 128 experts, top-2, plus a parallel
dense FFN (`dense_residual`).

The routing is the reference's: a router softmax in f32, the top k
experts of each token (ties to the lower expert index, as
`jax.lax.top_k` breaks them), gates renormalised over the k, and each
(token, slot) given a place in its expert's buffer of C slots by a
cumulative count in slot-major (k, s) order; places at or past C are
dropped. The reference builds one-hot (B, S, E, C) dispatch and combine
tensors and contracts them with einsums. Every (expert, place) holds at
most one token, so the port gathers the kept tokens' rows into (B, E, C,
D) expert buffers and gathers each token's k expert outputs back: the
same values without the (B, S, E, C) tensors. The expert products are
batched matmuls (`torch.bmm`), as the reference leaves them to XLA
outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import is_dtensor
from ..sharding.planner import (batch_placements, constrain,
                                constraint_placements, shard_range)
from .layers import apply_mlp, init_mlp, weight
from .param import normal


def init_moe(d_model, moe_cfg, activation, dtype, generator=None,
             device=None):
    """{"router" (d_model, E) f32 whatever `dtype` (as in the reference),
    "wi_gate", "wi_up" (E, d_model, F), "wo" (E, F, d_model)} (+ "dense",
    an MLP, for `dense_residual`)."""
    E, Fh = moe_cfg.n_experts, moe_cfg.d_ff
    kw = dict(dtype=dtype, generator=generator, device=device)
    p = {"router": normal((d_model, E), generator=generator, device=device),
         "wi_gate": normal((E, d_model, Fh), **kw),
         "wi_up": normal((E, d_model, Fh), **kw),
         "wo": normal((E, Fh, d_model), **kw)}
    if moe_cfg.dense_residual:
        p["dense"] = init_mlp(d_model, moe_cfg.dense_d_ff, activation, dtype,
                              generator=generator, device=device)
    return p


def _capacity(S, moe_cfg):
    c = int(S * moe_cfg.top_k / moe_cfg.n_experts * moe_cfg.capacity_factor)
    return max(c, moe_cfg.top_k)


def top_k(probs, k):
    """(values, indices) of the k largest along the last axis, in
    `jax.lax.top_k`'s order: descending, equal values lower index first.
    `torch.topk` orders ties otherwise; a stable descending sort keeps
    the index order among equals."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(probs, moe_cfg, S):
    """The routing of `probs` (B, S, E): (expert index (B, S, K), place in
    the expert's buffer (B, S, K), kept (B, S, K) bool, gates (B, S, K)
    f32, 0 where dropped)."""
    B, E, K = probs.shape[0], moe_cfg.n_experts, moe_cfg.top_k
    gate_vals, expert = top_k(probs, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # place of each (token, slot) among its expert's picks in the
    # slot-major order k * S + s: the reference's cumulative one-hot
    # count, here its rank in a stable sort by expert, less the number of
    # picks of lower experts
    flat = expert.transpose(1, 2).reshape(B, K * S)
    order = torch.sort(flat, dim=1, stable=True).indices
    counts = torch.zeros((B, E), dtype=torch.long, device=flat.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    first = torch.cumsum(counts, dim=1) - counts              # (B, E)
    rank = (torch.arange(K * S, device=flat.device)[None]
            - torch.gather(first, 1, torch.gather(flat, 1, order)))
    place = torch.empty_like(flat).scatter_(1, order, rank)
    place = place.reshape(B, K, S).transpose(1, 2)
    keep = (place < _capacity(S, moe_cfg)) & (gate_vals > 0)
    gates = torch.where(keep, gate_vals, torch.zeros_like(gate_vals))
    return expert, place, keep, gates


def _dispatch(x, probs, moe_cfg, e0=0, n_local=None):
    """Route each token and gather the kept (token, slot) rows into
    their expert buffers: (xe (E', B*C, D) with B outer, slot (B, S, K),
    the row of each (token, slot) in the (B, E, C) layout, clamped where
    dropped, gates (B, S, K), density (B, E), each row's top-1 share of
    each expert). Independent by batch row. The buffers are those of
    experts [e0, e0 + E') (`n_local` = E', all E by default): a rank's
    expert shard."""
    B, S, D = x.shape
    E = moe_cfg.n_experts
    C = _capacity(S, moe_cfg)
    n_local = n_local or E
    expert, place, keep, gates = route(probs, moe_cfg, S)
    b_idx = torch.arange(B, device=x.device)[:, None, None]
    place = torch.clamp(place, max=C - 1)
    slot = (b_idx * E + expert) * C + place
    tok = (b_idx * S + torch.arange(S, device=x.device)[None, :, None]
           ).expand(B, S, moe_cfg.top_k)
    rows, kept = slot, keep
    if n_local != E:
        e = expert - e0
        kept = keep & (e >= 0) & (e < n_local)
        rows = (b_idx * n_local + torch.clamp(e, 0, n_local - 1)) * C + place
    xe = torch.zeros((B * n_local * C, D), dtype=x.dtype, device=x.device)
    xe.index_copy_(0, rows[kept], x.reshape(B * S, D)[tok[kept]])
    xe = xe.reshape(B, n_local, C, D).transpose(0, 1).reshape(
        n_local, B * C, D)
    density = F.one_hot(expert[:, :, 0], E).to(torch.float32).mean(1)
    return xe, slot, gates, density


def _combine(ye, slot, gates, dtype, n_experts, e0=0):
    """Each token's k expert outputs times its gates (in `dtype`, as the
    reference casts its combine tensor), summed in f32: ye (E', B*C, D)
    -> (B, S, D). Independent by batch row. `ye` may hold experts
    [e0, e0 + E') of the `n_experts` that `slot` counts (a rank's expert
    shard): the others' terms are left out, a partial sum."""
    E, BC, D = ye.shape
    B = slot.shape[0]
    C = BC // B
    ye = ye.reshape(E, B, C, D).transpose(0, 1).reshape(BC * E, D)
    g = gates.to(dtype).to(torch.float32)[..., None]
    if E != n_experts:
        b_e, place = slot // C, slot % C
        e = b_e % n_experts - e0
        mine = (e >= 0) & (e < E)
        slot = ((b_e // n_experts) * E + torch.clamp(e, 0, E - 1)) * C \
            + place
        g = g * mine[..., None]
    return (ye[slot].to(torch.float32) * g).sum(2).to(dtype)


def _by_rows(fn, x, out_placements, in_placements, in_grad_placements):
    """`fn` on each rank's shard, its inputs moved to their placements
    first (the routing is per batch row, so batch shards are exact)."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements,
                     in_grad_placements=in_grad_placements,
                     device_mesh=x.device_mesh, redistribute_inputs=True)


#: the expert buffers' logical axes, the reference's (B, E, C, D), and
#: the dims of the port's (E, B*C, D) they name
_BUFFER_AXES, _BUFFER_DIMS = ("batch", "experts", None, None), (1, 0, 3)


def _expert_layout(x, buffer_shape) -> tuple:
    """(the expert buffers' placements, the placements of a sum over
    them) for DTensor tokens `x`: on each mesh dim, a batch shard of the
    rows; else, where the plan shards the experts, each rank's own
    experts (their dispatch and combine cover them alone: a partial sum
    over that dim, reduced in the (B, S, D) layout, in place of moving
    every expert's (E, B*C, D) buffers); else replicas."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    want = constraint_placements(buffer_shape, _BUFFER_AXES, x.device_mesh,
                                 _BUFFER_DIMS) or \
        (Replicate(),) * x.device_mesh.ndim
    buf, part = [], []
    for r, t in zip(batch_placements(x), want):
        if r == Shard(0):
            buf.append(Shard(1))
            part.append(r)
        elif t == Shard(0):
            buf.append(t)
            part.append(Partial())
        else:
            buf.append(Replicate())
            part.append(Replicate())
    return tuple(buf), tuple(part)


def apply_moe(p, x, moe_cfg, activation):
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar f32).

    On DTensors the routing, the dispatch and the combine run on each
    rank's batch rows and experts (`_expert_layout`), and the expert
    buffers are constrained as the reference's (B, E, C, D) are, "batch"
    on the B*C dim (B outer, so a batch shard is whole rows of C
    slots)."""
    E = moe_cfg.n_experts
    x = constrain(x, ("batch", None, None))      # as apply_mlp's input
    logits = (x @ p["router"].to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                     # (B, S, E)
    dispatch, combine, e0, n_local = _dispatch, _combine, 0, E
    if is_dtensor(x):
        B, S, D = x.shape
        rows = batch_placements(x)
        buf, part = _expert_layout(x, (E, B * _capacity(S, moe_cfg), D))
        e0, n_local = shard_range(E, buf, x.device_mesh, 0)
        dispatch = _by_rows(_dispatch, x, (buf, rows, rows, rows),
                            (rows, rows, None, None, None),
                            (part, rows, None, None, None))
        combine = _by_rows(_combine, x, list(part),
                           (buf, rows, rows, None, None, None),
                           (buf, rows, part, None, None, None))
    xe, slot, gates, density = dispatch(x, probs, moe_cfg, e0, n_local)
    xe = constrain(xe, _BUFFER_AXES, dims=_BUFFER_DIMS)

    gate_h = torch.bmm(xe, weight(p["wi_gate"], x, (0, 2)))
    up_h = torch.bmm(xe, weight(p["wi_up"], x, (0, 2)))
    act = F.silu(gate_h) if activation == "swiglu" else \
        F.gelu(gate_h, approximate="tanh")
    ye = torch.bmm(act * up_h, weight(p["wo"], x, (0, 1)))   # (E, B*C, D)
    ye = constrain(ye, _BUFFER_AXES, dims=_BUFFER_DIMS)
    out = constrain(combine(ye, slot, gates, x.dtype, E, e0),
                    ("batch", "seq", None))

    # Switch-style load-balance auxiliary loss
    router_prob = probs.mean(1)                               # (B, E)
    aux = (density * router_prob).sum(-1).mean() * E
    aux = moe_cfg.aux_loss_weight * aux

    if "dense" in p:
        out = out + apply_mlp(p["dense"], x, activation)
    return out, aux
