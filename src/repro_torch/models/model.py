"""Model interface; counterpart of `repro.models.model` for the
transformer families (dense, moe, vlm, audio), which the reference also
builds with one `_build_transformer`.

`build(cfg)` returns a `Model` with:
  init(seed=0, device=None)        -> parameters (`transformer.init_params`)
  forward(params, batch)           -> (logits, aux)
  prefill(params, batch, max_seq)  -> (logits, cache)   [serving]
  decode_step(params, tokens, cache) -> (logits, cache)
  loss_fn(params, batch)           -> (loss, metrics)    [training]

Cache convention, as in the reference: a dict with "kv" (one {"k", "v"}
dict per layer) and "lengths" (B,) int32 holding the current position.
An audio encoder has no decode (`cfg.has_decode`). The ssm and hybrid
families wait for a later slice: `build` raises for them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..device import resolve_device
from . import transformer as TF


@dataclass
class Model:
    cfg: Any
    init: Callable
    forward: Callable
    prefill: Callable
    decode_step: Callable
    loss_fn: Callable


def build(cfg) -> Model:
    TF.check_supported(cfg)

    def init(seed=0, device=None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return TF.init_params(cfg, generator=gen, device=dev)

    def forward(params, batch):
        return TF.forward(params, batch, cfg)

    def prefill(params, batch, max_seq=None):
        logits, caches, lengths = TF.prefill(params, batch, cfg, max_seq)
        return logits, {"kv": caches, "lengths": lengths}

    def decode_step(params, tokens, cache):
        logits, kv, lengths = TF.decode_step(params, tokens, cache["kv"],
                                             cache["lengths"], cfg)
        return logits, {"kv": kv, "lengths": lengths}

    def loss_fn(params, batch):
        return TF.loss_fn(params, batch, cfg)

    return Model(cfg, init, forward, prefill, decode_step, loss_fn)
