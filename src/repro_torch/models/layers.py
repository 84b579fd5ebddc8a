"""Shared neural layers: norms, RoPE, MLPs, softcaps, embeddings and the
cross-entropy loss. Counterpart of `repro.models.layers`, op for op and
in the same types."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .param import normal


def rms_norm(x, weight, eps=1e-6):
    """In f32, scaled by (1 + weight), back to x's type."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.to(torch.float32))).to(dtype)


def softcap(x, cap):
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, fraction: float, theta: float, device=None):
    """Inverse frequencies for the rotated sub-dimension."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x, positions, head_dim: int, fraction: float = 1.0,
               theta: float = 10_000.0):
    """x: (..., S, H, Dh); positions: broadcastable to (..., S). The pairs
    are interleaved (dims 0::2 with 1::2), as in the reference."""
    inv_freq, rot = rope_freqs(head_dim, fraction, theta, x.device)
    if rot == 0:
        return x
    ang = positions[..., :, None].to(torch.float32) * inv_freq
    cos = torch.cos(ang)[..., :, None, :]   # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    rotated = torch.stack([o1, o2], dim=-1).reshape(x_rot.shape)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(d_model, d_ff, activation, dtype, generator=None, device=None):
    kw = dict(dtype=dtype, generator=generator, device=device)
    if activation in ("swiglu", "geglu"):
        return {"wi_gate": normal((d_model, d_ff), **kw),
                "wi_up": normal((d_model, d_ff), **kw),
                "wo": normal((d_ff, d_model), **kw)}
    return {"wi": normal((d_model, d_ff), **kw),
            "wo": normal((d_ff, d_model), **kw)}


def apply_mlp(p, x, activation):
    if activation in ("swiglu", "geglu"):
        gate = x @ p["wi_gate"].to(x.dtype)
        up = x @ p["wi_up"].to(x.dtype)
        act = F.silu(gate) if activation == "swiglu" else \
            F.gelu(gate, approximate="tanh")
        h = act * up
    else:
        h = F.gelu(x @ p["wi"].to(x.dtype), approximate="tanh")
    return h @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def init_embed(vocab, d_model, dtype, generator=None, device=None):
    return normal((vocab, d_model), scale=1.0, dtype=dtype,
                  generator=generator, device=device)


def embed_tokens(table, tokens, scale_by_dim: bool):
    x = table[tokens]
    if scale_by_dim:
        x = x * torch.tensor(table.shape[-1] ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def logits_head(w, x, final_cap=None):
    """w: (d_model, vocab); returns float32 logits (softcapped if
    configured)."""
    out = (x @ w.to(x.dtype)).to(torch.float32)
    return softcap(out, final_cap)


def cross_entropy(logits, labels, mask=None):
    """Mean CE over valid positions; logits float32 (B, S, V)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(nll.dtype)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
