"""The model FLOPs of a training step, for `step_mfu`.

6 FLOPs a token for each parameter that multiplies it (2 in the
forward, 4 in the backward): the attention projections, the dense MLP,
or the router and the `top_k` experts a token is routed to, and the LM
head; not the embedding (a lookup) nor the norms. Plus attention's own
products: 12 H D FLOPs a causal (query, key) pair a layer (q.k and p.v,
2 D each in the forward, twice that in the backward). Recomputation
under activation checkpointing is not counted, nor tokens dropped over
an expert's capacity. This is the PaLM paper's MFU (Chowdhery et al.,
2022, appendix B) with a causal mask's pairs in place of S^2.
"""
from __future__ import annotations

from .attention import causal_pairs


def matmul_params_per_token(s) -> int:
    """`s`: a `lib.model_shape.ModelShape`."""
    d, H, K, Dh = s.d_model, s.n_heads, s.n_kv_heads, s.head_dim
    attn = d * Dh * (2 * H + 2 * K)
    if s.moe:
        ffn = d * s.n_experts + s.top_k * 3 * d * s.d_ff
    else:
        ffn = 3 * d * s.d_ff
    return s.n_layers * (attn + ffn) + d * s.vocab


def step_flops(s, rows: int, seq: int) -> float:
    """Model FLOPs of one step over `rows` sequences of `seq` tokens."""
    tokens = rows * seq
    attn = 12.0 * s.n_heads * s.head_dim * causal_pairs(seq) * rows \
        * s.n_layers
    return 6.0 * tokens * matmul_params_per_token(s) + attn
