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

from .layers import apply_mlp, init_mlp
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


def apply_moe(p, x, moe_cfg, activation):
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar f32)."""
    B, S, D = x.shape
    E, K = moe_cfg.n_experts, moe_cfg.top_k
    C = _capacity(S, moe_cfg)
    logits = (x @ p["router"].to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                     # (B, S, E)
    expert, place, keep, gates = route(probs, moe_cfg, S)

    # dispatch: the kept (token, slot) rows into their (b, e, place) slot
    b_idx = torch.arange(B, device=x.device)[:, None, None]
    slot = (b_idx * E + expert) * C + torch.clamp(place, max=C - 1)
    tok = (b_idx * S + torch.arange(S, device=x.device)[None, :, None]
           ).expand(B, S, K)
    xe = torch.zeros((B * E * C, D), dtype=x.dtype, device=x.device)
    xe.index_copy_(0, slot[keep], x.reshape(B * S, D)[tok[keep]])
    xe = xe.reshape(B, E, C, D).transpose(0, 1).reshape(E, B * C, D)

    gate_h = torch.bmm(xe, p["wi_gate"].to(x.dtype))
    up_h = torch.bmm(xe, p["wi_up"].to(x.dtype))
    act = F.silu(gate_h) if activation == "swiglu" else \
        F.gelu(gate_h, approximate="tanh")
    ye = torch.bmm(act * up_h, p["wo"].to(x.dtype))           # (E, B*C, D)
    ye = ye.reshape(E, B, C, D).transpose(0, 1).reshape(B * E * C, D)

    # combine: each token's k expert outputs times its gates (in x's
    # type, as the reference casts its combine tensor), summed in f32
    g = gates.to(x.dtype).to(torch.float32)[..., None]
    out = (ye[slot].to(torch.float32) * g).sum(2).to(x.dtype)

    # Switch-style load-balance auxiliary loss
    density = F.one_hot(expert[:, :, 0], E).to(torch.float32).mean(1)
    router_prob = probs.mean(1)                               # (B, E)
    aux = (density * router_prob).sum(-1).mean() * E
    aux = moe_cfg.aux_loss_weight * aux

    if "dense" in p:
        out = out + apply_mlp(p["dense"], x, activation)
    return out, aux
