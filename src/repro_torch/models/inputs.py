"""Batch construction; counterpart of `repro.models.inputs.make_batch`
for text models. The tokens are the reference's: the same numpy
generator draws them in the same order."""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def make_batch(cfg, batch: int, seq: int, kind: str, seed: int = 0,
               device=None) -> dict:
    """{"tokens": (batch, seq) int32} (+ "labels" for kind "train") on
    `device`."""
    if cfg.vision is not None or cfg.audio is not None:
        raise NotImplementedError(f"make_batch: {cfg.family} inputs are not "
                                  f"ported (ROADMAP.md)")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def tok(shape):
        ids = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        return torch.from_numpy(ids).to(dev)

    out = {"tokens": tok((batch, seq))}
    if kind == "train":
        out["labels"] = tok((batch, seq))
    return out
