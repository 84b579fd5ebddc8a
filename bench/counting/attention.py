"""The work and the bytes of one causal flash-attention launch, as the
inputs need them, whatever the kernel computes.

Shapes: q (B, H, S, D), k and v (B, K, S, D), bf16 (2 bytes). A causal
row i attends to keys 0..i, so a (query, key) pair is one of
S (S + 1) / 2 per head and row.

Forward (`flash_attention_sm90_kernel`): two products a pair, q.k and
p.v, each D multiply-adds: 4 D FLOPs a pair a head. Bytes: q, k and v
read once and o written once.

Backward (`flash_attention_bwd_*` kernels of one call): the five
products that the gradient needs, s = q.k and dp = do.v recomputed,
dq = ds.k, dk = ds^T.q and dv = p^T.do: 10 D FLOPs a pair a head.
Bytes: q, k, v and do read once, dq, dk and dv written once. Since the
bf16 backward was redesigned the kernel computes more products than five
(`launch/op_analyzer.py` costs it at 13): its share is read against the
five, so that a redesign that drops work shows.

A launch's bound is the larger of work / 989e12 and bytes / 3.35e12
(`peaks.py`); its roofline share is the bound over its device time.
Reference: the FlashAttention-2 paper (Dao, 2023), section 4: forward 4
N^2 d FLOPs, backward 2.5 times the forward, halved for a causal mask.
"""
from __future__ import annotations

from . import peaks

BYTES = 2


def causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def forward_flops(B, H, S, D) -> float:
    return 4.0 * D * causal_pairs(S) * B * H


def backward_flops(B, H, S, D) -> float:
    return 10.0 * D * causal_pairs(S) * B * H


def forward_bytes(B, H, K, S, D) -> float:
    return float(BYTES * B * S * D * (2 * H + 2 * K))


def backward_bytes(B, H, K, S, D) -> float:
    return float(BYTES * B * S * D * (3 * H + 3 * K))


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)


def forward_bound_s(B, H, K, S, D) -> float:
    return bound_s(forward_flops(B, H, S, D), forward_bytes(B, H, K, S, D))


def backward_bound_s(B, H, K, S, D) -> float:
    return bound_s(backward_flops(B, H, S, D), backward_bytes(B, H, K, S, D))
