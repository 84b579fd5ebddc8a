"""Plain float32 reference of the benchmark's training cells.

A decoder-only transformer as the configuration file states it: the
embedding; per layer an RMSNorm (scale 1 + w), grouped-query causal
attention with interleaved RoPE, an RMSNorm and either a SwiGLU MLP or a
routed mixture of experts; a final RMSNorm and an untied LM head; the
loss is the mean next-token cross-entropy (position t's logits against
`labels[t + 1]`, the last position dropped, as the program's
`next_token_ce` takes it) plus, with experts, each layer's load-balance
loss. The experts: a router softmax, the top k experts of each token
(ties to the lower index), gates renormalised over the k, each (token,
slot) placed in its expert's buffer by a running count in slot-major
(k, s) order, and placements at or past the capacity dropped; the
load-balance loss is `coef * E * sum(top-1 share * mean probability)`.

Training is AdamW on f32 parameters (no weight decay in these cells),
each step's gradient the mean over the batch's rows. It runs in blocks
so that it fits one card at the cells' widths: one row at a time,
forward without a graph keeping only each layer's input, the head and
the loss in blocks of rows, then each layer recomputed with a graph and
its backward taken, attention a kv head's group at a time (recomputed
again in its backward). Products go through `precision.Precision`:
float32 with TF32 off, or the control's float8.

It imports nothing of the program. Weights come from `lib/weights.py`
and tokens from `lib/tokens.py`, the benchmark's own.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..lib import weights as W
from ..lib.model_shape import ModelShape

from .precision import Precision, set_exact_float32

#: rows of logits formed at once for the loss: 1 GiB of f32 at 131,072
HEAD_ROWS = 2048


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * (1 + w)


def rope(x, theta):
    """x (S, heads, Dh): pairs (2i, 2i + 1) rotated by position * theta^(-2i/Dh)."""
    S, _, Dh = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, Dh, 2, dtype=torch.float32,
                                        device=x.device) / Dh))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       -1).reshape(x.shape)


def _group_attention(q, k, v, allowed, prec):
    """q (G, S, Dh) of one kv head's group, k and v (S, Dh)."""
    G, S, Dh = q.shape
    s = prec.mm(q, k.t().expand(G, Dh, S)) * Dh ** -0.5
    p = torch.softmax(s.masked_fill(~allowed, float("-inf")), -1)
    return prec.mm(p, v.expand(G, S, Dh))


def attention(P, pre, h, s: ModelShape, prec, allowed, graph):
    S, d = h.shape
    H, K, Dh = s.n_heads, s.n_kv_heads, s.head_dim
    G = H // K
    q = rope(prec.mm(h, P[pre + "wq"].reshape(d, H * Dh)).view(S, H, Dh),
             s.rope_theta)
    k = rope(prec.mm(h, P[pre + "wk"].reshape(d, K * Dh)).view(S, K, Dh),
             s.rope_theta)
    v = prec.mm(h, P[pre + "wv"].reshape(d, K * Dh)).view(S, K, Dh)
    outs = []
    for j in range(K):
        args = (q[:, j * G:(j + 1) * G].transpose(0, 1), k[:, j], v[:, j],
                allowed, prec)
        o = checkpoint(_group_attention, *args, use_reentrant=False) \
            if graph else _group_attention(*args)
        outs.append(o.transpose(0, 1))
    o = torch.cat(outs, 1).reshape(S, H * Dh)
    return prec.mm(o, P[pre + "wo"].reshape(H * Dh, d))


def mlp(P, pre, h, prec):
    return prec.mm(F.silu(prec.mm(h, P[pre + "wi_gate"]))
                   * prec.mm(h, P[pre + "wi_up"]), P[pre + "wo"])


def experts(P, pre, h, s: ModelShape, prec):
    """(output (S, d), load-balance loss) of one row's S tokens."""
    S = h.shape[0]
    E, K = s.n_experts, s.top_k
    probs = torch.softmax(prec.mm(h, P[pre + "router"]), -1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :K], idx[:, :K]
    gates = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9) \
        if s.norm_topk else vals
    # place of each (token, slot) in its expert's buffer: the running
    # count of the expert's picks in slot-major order
    onehot = F.one_hot(idx.t().reshape(-1), E)
    place = ((torch.cumsum(onehot, 0) - 1) * onehot).sum(-1).view(K, S).t()
    keep = (place < s.capacity(S)) & (gates > 0)
    tok, slot = keep.nonzero(as_tuple=True)
    ex = idx[tok, slot]
    order = torch.argsort(ex, stable=True)
    tok, slot, ex = tok[order], slot[order], ex[order]
    counts = torch.bincount(ex, minlength=E).tolist()
    xs = h[tok]
    wg, wu, wo = (P[pre + n].unbind(0) for n in ("wi_gate", "wi_up", "wo"))
    ys, lo = [], 0
    for e, n in enumerate(counts):
        if n:
            xe = xs[lo:lo + n]
            ys.append(prec.mm(F.silu(prec.mm(xe, wg[e])) * prec.mm(xe, wu[e]),
                              wo[e]))
        lo += n
    y = torch.cat(ys) * gates[tok, slot][:, None]
    out = torch.zeros_like(h).index_add(0, tok, y)
    density = F.one_hot(idx[:, 0], E).to(torch.float32).mean(0)
    aux = s.aux_coef * E * torch.sum(density * probs.mean(0))
    return out, aux


def block(P, i, x, s: ModelShape, prec, allowed, graph=False):
    """(x after layer i, its load-balance loss or None)."""
    pre = f"blocks.{i}."
    x = x + attention(P, pre + "attn.", rms_norm(x, P[pre + "ln1"],
                                                 s.norm_eps),
                      s, prec, allowed, graph)
    h = rms_norm(x, P[pre + "ln2"], s.norm_eps)
    if s.moe:
        y, aux = experts(P, pre + "moe.", h, s, prec)
        return x + y, aux
    return x + mlp(P, pre + "mlp.", h, prec), None


def head_loss(P, x, labels, s: ModelShape, prec, weight):
    """Mean next-token NLL of one row, its backward (times `weight`)
    taken into the head's gradients; returns (nll, d loss / d x)."""
    S = x.shape[0]
    x = x.detach().requires_grad_(True)
    total = 0.0
    for lo in range(0, S - 1, HEAD_ROWS):
        hi = min(S - 1, lo + HEAD_ROWS)
        logits = prec.mm(rms_norm(x[lo:hi], P["final_norm"], s.norm_eps),
                         P["lm_head"])
        gold = torch.gather(logits, -1, labels[lo + 1:hi + 1, None])[:, 0]
        part = torch.sum(torch.logsumexp(logits, -1) - gold)
        (part * (weight / (S - 1))).backward()
        total += float(part.detach())
    return total / (S - 1), x.grad


def row_step(P, tokens, labels, s: ModelShape, prec, allowed, weight):
    """Forward and backward of one row; gradients (times `weight`) added
    into the parameters' `.grad`. Returns the row's loss."""
    with torch.no_grad():
        xs = [P["embed"][tokens]]
        aux_total = 0.0
        for i in range(s.n_layers):
            x, aux = block(P, i, xs[-1], s, prec, allowed)
            xs.append(x)
            if aux is not None:
                aux_total += float(aux)
    nll, g = head_loss(P, xs.pop(), labels, s, prec, weight)
    for i in reversed(range(s.n_layers)):
        x = xs.pop().requires_grad_(True)
        out, aux = block(P, i, x, s, prec, allowed, graph=True)
        outs, grads = [out], [g]
        if aux is not None:
            outs.append(aux)
            grads.append(torch.tensor(weight, device=aux.device))
        torch.autograd.backward(outs, grads)
        g = x.grad
    emb = P["embed"]
    if emb.grad is None:
        emb.grad = torch.zeros_like(emb)
    emb.grad.index_add_(0, tokens, g)
    return nll + aux_total


@torch.no_grad()
def adamw(P, state, t, lr, b1, b2, eps, last):
    """AdamW's step `t` (no weight decay) in place, from each `.grad`.

    After one step the moments are (1 - b1) g1 and (1 - b2) g1^2, so until
    step 2 only g1 is kept (12 bytes a parameter with the parameter and
    the next gradient, in place of 16); the moments are stored from step
    2 on, and only if a step follows (`last` False). The arithmetic is
    the usual AdamW's, a chunk of a leaf at a time."""
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    g1s = state.pop("g1", None)
    if t == 1 and not last:
        state["g1"] = {}
    for name, p in P.items():
        g, p.grad = p.grad, None
        flat_g, flat_p = g.view(-1), p.view(-1)
        g1 = g1s.pop(name).view(-1) if g1s is not None else None
        keep = t >= 2 and not last
        if keep:
            state.setdefault("m", {})[name] = torch.zeros_like(flat_p)
            state.setdefault("v", {})[name] = torch.zeros_like(flat_p)
        for lo, hi in W.chunks(flat_p.numel()):
            gc = flat_g[lo:hi]
            if t == 1:
                m = (1 - b1) * gc
                v = (1 - b2) * gc * gc
            elif g1 is not None:
                m = ((1 - b1) * g1[lo:hi]).mul_(b1).add_((1 - b1) * gc)
                v = ((1 - b2) * g1[lo:hi] * g1[lo:hi]).mul_(b2).add_(
                    (1 - b2) * gc * gc)
            else:
                m = state["m"][name][lo:hi].mul_(b1).add_((1 - b1) * gc)
                v = state["v"][name][lo:hi].mul_(b2).add_((1 - b2) * gc * gc)
            if keep and g1 is not None:
                state["m"][name][lo:hi] = m
                state["v"][name][lo:hi] = v
            u = m / bc1
            u.div_(torch.sqrt(v / bc2).add_(eps))
            flat_p[lo:hi].sub_(u.mul_(lr))
        if t == 1 and not last:
            state["g1"][name] = g
        del g


def train(s: ModelShape, seed: int, batches: list, opt: dict, device,
          precision: str = "float32") -> dict:
    """`len(batches)` steps from the seed's weights. Returns each step's
    loss, each leaf's first gradient norm, and each leaf's change after
    the last step as its norm and its projections (`W.change_readings`)."""
    set_exact_float32()
    prec = Precision(precision)
    P = W.make(s, seed, device)
    for p in P.values():
        p.requires_grad_(True)
    state, losses, grad_norms = {}, [], None
    for t, batch in enumerate(batches, start=1):
        tokens = torch.as_tensor(batch["tokens"], device=device).long()
        labels = torch.as_tensor(batch["labels"], device=device).long()
        R, S = tokens.shape
        allowed = torch.ones((S, S), dtype=torch.bool,
                             device=device).tril_()
        loss = 0.0
        for r in range(R):
            loss += row_step(P, tokens[r], labels[r], s, prec, allowed,
                             1.0 / R) / R
        losses.append(loss)
        if t == 1:
            grad_norms = {k: float(torch.linalg.vector_norm(p.grad))
                          for k, p in P.items()}
        adamw(P, state, t, opt["lr"], opt["b1"], opt["b2"], opt["eps"],
              last=t == len(batches))
    del state
    norms, probes = W.change_readings(P, s, seed)
    return {"loss": losses, "grad_norms": grad_norms,
            "change_norms": norms, "change_probes": probes}
