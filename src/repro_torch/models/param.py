"""Parameter initialisation; counterpart of `repro.models.param`.

The reference wraps each array with logical sharding axes for its
planner; the port holds plain tensors in dicts (one entry per layer) and
keeps no axes. Random values come from an explicit `torch.Generator`, so
they differ from `jax.random`'s: the parity tests carry the reference's
weights across with `repro_torch.convert.model_params`.
"""
from __future__ import annotations

import torch


def normal(shape, scale=0.02, dtype=torch.float32, generator=None,
           device=None) -> torch.Tensor:
    """scale * N(0, 1) drawn in f32, then cast to `dtype` (as the
    reference draws)."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (scale * x).to(dtype)
