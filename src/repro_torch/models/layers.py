"""Shared neural layers: norms, RoPE, MLPs, softcaps, embeddings and the
cross-entropy loss. Counterpart of `repro.models.layers`, op for op and
in the same types."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import is_dtensor
from ..sharding.planner import (batch_placements, constrain, replicate_like,
                                shard_range, unshard)
from .param import normal


def weight(w, x, keep: tuple):
    """The weight `w` in x's type. A DTensor weight is gathered on every
    dim but its tensor-parallel ones (`keep`): FSDP's all-gather of a
    weight before its product, rather than DTensor's own choice, which
    at a small microbatch gathers the activations instead."""
    return unshard(w.to(x.dtype), keep)


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
    positions = replicate_like(positions, x)
    inv_freq = replicate_like(inv_freq, x)
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
    """Under a plan that shards the sequence (context parallelism), the
    input's sequence is gathered first and the output scattered back:
    the MLP's weights take the model axis for its hidden (the
    reference's constraint on the hidden)."""
    x = constrain(x, ("batch", None, None))
    if activation in ("swiglu", "geglu"):
        gate = x @ weight(p["wi_gate"], x, (1,))
        up = x @ weight(p["wi_up"], x, (1,))
        act = F.silu(gate) if activation == "swiglu" else \
            F.gelu(gate, approximate="tanh")
        h = act * up
    else:
        h = F.gelu(x @ weight(p["wi"], x, (1,)), approximate="tanh")
    if h.dim() == 3:
        h = constrain(h, ("batch", "seq", "ffn"))
    return constrain(h @ weight(p["wo"], x, (0,)), ("batch", "seq", None))


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def init_embed(vocab, d_model, dtype, generator=None, device=None):
    return normal((vocab, d_model), scale=1.0, dtype=dtype,
                  generator=generator, device=device)


def _lookup(table, tokens, lo: int):
    """Rows of a vocabulary shard [lo, lo + len(table)) for `tokens`,
    zeros where a token lies outside it."""
    n = table.shape[0]
    j = tokens.long() - lo
    inside = ((j >= 0) & (j < n)).to(table.dtype)
    return table[torch.clamp(j, 0, n - 1)] * inside[..., None]


def _embed_sharded(table, tokens):
    """A DTensor table's rows for `tokens` on each rank's shards: the
    table keeps its vocabulary shards (the others gathered, as
    `weight`), each rank looks up its batch rows in its vocabulary
    piece, and the pieces are a partial sum over the vocabulary's ranks;
    the table's gradient is partial over the batch's ranks."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    table = unshard(table, keep=(0,))
    tokens = replicate_like(tokens, table)
    plc, rows = tuple(table.placements), batch_placements(tokens)
    out = [Partial() if t.is_shard(0) else r for t, r in zip(plc, rows)]
    grad = tuple(t if t.is_shard(0) else Partial() if r.is_shard(0)
                 else Replicate() for t, r in zip(plc, rows))
    lo = shard_range(table.shape[0], plc, table.device_mesh, 0)[0]
    return local_map(_lookup, out_placements=out,
                     in_placements=(plc, rows, None),
                     in_grad_placements=(grad, rows, None),
                     device_mesh=table.device_mesh,
                     redistribute_inputs=True)(table, tokens, lo)


def embed_tokens(table, tokens, scale_by_dim: bool):
    """The rows of `table` (vocab, d_model) for `tokens`; a DTensor
    table's by `_embed_sharded` (indexing would gather the table, and
    its backward has no sharding rule on every torch version)."""
    if is_dtensor(table):
        x = _embed_sharded(table, tokens)
    else:
        x = table[tokens]
    if scale_by_dim:
        x = x * torch.tensor(table.shape[-1] ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def logits_head(w, x, final_cap=None):
    """w: (d_model, vocab); returns float32 logits (softcapped if
    configured)."""
    out = (x @ weight(w, x, (1,))).to(torch.float32)
    return softcap(out, final_cap)


def _gold_mask(labels, lo: int, n: int):
    """(..., n) bool: position j holds label - lo, for the vocabulary
    shard [lo, lo + n); all False where the label lies outside it."""
    j = labels.long() - lo
    inside = (j >= 0) & (j < n)
    return F.one_hot(torch.clamp(j, 0, n - 1), n).bool() & inside[..., None]


def _nll_vocab_sharded(logits, labels, n_valid=None):
    """lse - gold of DTensor logits sharded on the vocabulary: the max,
    the sum of exps and the gold logit reduced over the vocabulary's
    ranks (small (B, S) collectives) into the logits' batch layout,
    never the (B, S, V) logits moved (nor, in the backward, their
    gradient). The gold logit is a sum over a one-hot mask made on each
    rank's own shard; columns from `n_valid` on (the padded vocabulary)
    are -inf in the max and the sum, masked on each rank's shard."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    rows = batch_placements(logits)
    last = logits.dim() - 1
    lo, n = shard_range(logits.shape[-1], logits.placements, mesh, last)

    def reduced(x):
        return x.redistribute(mesh, rows)

    onehot = local_map(_gold_mask, out_placements=list(logits.placements),
                       in_placements=(rows, None, None), device_mesh=mesh,
                       redistribute_inputs=True)(labels, lo, n)
    z = logits
    if n_valid is not None and n_valid < logits.shape[-1]:
        cols = tuple(Shard(0) if p.is_shard(last) else Replicate()
                     for p in logits.placements)
        pad = torch.arange(lo, lo + n, device=logits.to_local().device) \
            >= n_valid
        z = logits.masked_fill(DTensor.from_local(
            pad, mesh, cols, run_check=False, shape=(logits.shape[-1],),
            stride=(1,)), float("-inf"))
    m = reduced(z.detach().amax(-1, keepdim=True))
    lse = torch.log(reduced(torch.exp(z - m).sum(-1))) + m[..., 0]
    gold = reduced((logits * onehot.to(logits.dtype)).sum(-1))
    return lse - gold


def token_nll(logits, labels, n_valid=None):
    """The negative log-likelihood of each position's label over the
    first `n_valid` logits (all by default); logits float32 (B, S, V) ->
    (B, S). Plain labels beside DTensor logits are replicated on their
    mesh; DTensor logits sharded on the vocabulary take
    `_nll_vocab_sharded`, which masks the columns past `n_valid` where
    they lie rather than slicing them off (a slice of a sharded dim
    would gather the logits)."""
    labels = replicate_like(labels, logits)
    last = logits.dim() - 1
    if is_dtensor(logits) and any(
            p.is_shard(last) and logits.device_mesh.size(i) > 1
            for i, p in enumerate(logits.placements)):
        return _nll_vocab_sharded(logits, labels, n_valid)
    if n_valid is not None and n_valid < logits.shape[-1]:
        logits = logits[..., :n_valid]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - gold


def masked_mean(nll, mask=None):
    """The mean of `nll` over the positions `mask` keeps (all without
    one)."""
    if mask is None:
        return torch.mean(nll)
    mask = replicate_like(mask, nll).to(nll.dtype)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def cross_entropy(logits, labels, mask=None, n_valid=None):
    """Mean CE over valid positions; logits float32 (B, S, V), of which
    the first `n_valid` take part (all by default)."""
    return masked_mean(token_nll(logits, labels, n_valid), mask)


def next_token_ce(logits, labels, n_valid, prefix: int = 0):
    """Next-token CE, as the reference takes it: position t's logits
    (past a `prefix` of positions with no label, vlm's patches) against
    labels[t + 1] over the first `n_valid` logits, the last position
    dropped. Each position's NLL is taken against the wrapped labels and
    the small (B, S) NLL is sliced, so that DTensor logits stay where
    they lie."""
    nxt = torch.cat([labels[:, 1:], labels[:, :1]], dim=1)
    if prefix:
        nxt = torch.cat([nxt[:, :1].expand(-1, prefix), nxt], dim=1)
    nll = token_nll(logits, torch.clamp(nxt, min=0), n_valid)[:, prefix:]
    return masked_mean(nll[:, :-1], labels[:, 1:] >= 0)
