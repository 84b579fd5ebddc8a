"""The matrix products of the reference, in float32 (TF32 off) or, for
the control, in float8: each operand of a product, in the forward and in
the backward, rounded to e4m3 under a per-tensor scale (its largest
magnitude at 448) and multiplied in float32. That is the precision one
step below the bfloat16 compute that the configurations state."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def set_exact_float32() -> None:
    """Products and convolutions in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def q8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, in float32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return q8(a) @ q8(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g8 = q8(g)
        return g8 @ q8(b).transpose(-1, -2), q8(a).transpose(-1, -2) @ g8


class Precision:
    """`mm(a, b)`: `a @ b` (same batch dims) in the named precision."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8"):
            raise ValueError(f"precision {name!r}: float32 or float8")
        self.name = name

    def mm(self, a, b):
        if self.name == "float32":
            return a @ b
        return _Fp8Matmul.apply(a, b)
