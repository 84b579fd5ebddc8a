"""Batch construction; counterpart of `repro.models.inputs.make_batch`.
The arrays are the reference's: the same numpy generator draws them in
the same order, and the stub front ends' inputs (vlm patch embeddings,
audio frame features) are rounded to bfloat16 as the reference rounds
them."""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def make_batch(cfg, batch: int, seq: int, kind: str, seed: int = 0,
               device=None) -> dict:
    """On `device`: {"tokens": (batch, seq) int32} (+ "labels" for kind
    "train"); vlm: {"patch_embeds": (batch, n_patches, embed_dim) bf16,
    "tokens": (batch, seq - n_patches)} (+ labels of the text); audio:
    {"frames": (batch, seq, frame_dim) bf16} (+ labels (batch, seq))."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def tok(shape):
        ids = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        return torch.from_numpy(ids).to(dev)

    def normal_bf16(shape):
        return torch.from_numpy(rng.normal(size=shape)).to(
            torch.bfloat16).to(dev)

    if cfg.vision is not None:
        n_text = seq - cfg.vision.n_patches
        out = {"patch_embeds": normal_bf16((batch, cfg.vision.n_patches,
                                            cfg.vision.embed_dim)),
               "tokens": tok((batch, n_text))}
        if kind == "train":
            out["labels"] = tok((batch, n_text))
        return out
    if cfg.audio is not None:
        out = {"frames": normal_bf16((batch, seq, cfg.audio.frame_dim))}
        if kind == "train":
            out["labels"] = tok((batch, seq))
        return out
    out = {"tokens": tok((batch, seq))}
    if kind == "train":
        out["labels"] = tok((batch, seq))
    return out


def batch_struct(cfg, batch: int, seq: int, kind: str, device=None) -> dict:
    """`make_batch`'s layout as zeros on `device`, with no draws: under
    `FakeTensorMode` it allocates nothing (the dry run's inputs, as the
    reference's `batch_struct` gives ShapeDtypeStructs)."""
    dev = resolve_device(device)

    def z(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.vision is not None:
        n_text = seq - cfg.vision.n_patches
        out = {"patch_embeds": z((batch, cfg.vision.n_patches,
                                  cfg.vision.embed_dim), torch.bfloat16),
               "tokens": z((batch, n_text))}
        if kind == "train":
            out["labels"] = z((batch, n_text))
        return out
    if cfg.audio is not None:
        out = {"frames": z((batch, seq, cfg.audio.frame_dim), torch.bfloat16)}
        if kind == "train":
            out["labels"] = z((batch, seq))
        return out
    out = {"tokens": z((batch, seq))}
    if kind == "train":
        out["labels"] = z((batch, seq))
    return out
