"""Serving engine: prefill + greedy decode with a KV cache; counterpart of
`repro.serve.engine`."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..models import model as model_lib

#: leaves that keep param_dtype: the norm weights, which rms_norm and
#: the Mamba2 block's gated norm read in f32, and the Mamba2 block's
#: per-head `A_log`, `dt_bias` and `D`, which the reference casts to f32
#: where it uses them (log(linspace(1, 16, H)) is not exact in bf16)
_KEEP = ("ln1", "ln2", "ln1_post", "ln2_post", "final_norm", "ln", "norm",
         "A_log", "dt_bias", "D")


def cast_weights(params, dtype):
    """The weight matrices in `dtype`, the `_KEEP` leaves as they are,
    through every dict and list of the tree (a transformer's "blocks",
    a hybrid's "groups", "shared_attn" and "tail"). The reference casts
    each weight to the compute type where it is used (`w.astype(x.dtype)`);
    casting once gives the same values."""
    def cast(tree, key=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v, key) for v in tree]
        return tree if key in _KEEP else tree.to(dtype)

    return cast(params)


@dataclass
class Engine:
    model: model_lib.Model
    params: dict
    max_seq: int

    @classmethod
    def build(cls, cfg, max_seq: int = 256, params=None, seed: int = 0,
              device=None):
        """The engine of `cfg` on `device` (the card unless asked for the
        CPU). Without `params`, random weights from a generator seeded
        with `seed`; given `params` are moved to the device. An encoder
        (`cfg.has_decode` false: the audio family) has no decode, so no
        engine: run `model.build(cfg).forward` instead."""
        if not cfg.has_decode:
            raise ValueError(f"Engine.build: {cfg.name} is an encoder "
                             f"(has_decode is false); it has no decode "
                             f"step to serve")
        dev = resolve_device(device)
        m = model_lib.build(cfg)
        if params is None:
            params = m.init(seed=seed, device=dev)
        params = cast_weights(params, getattr(torch, cfg.compute_dtype))
        params = _to(params, dev)
        return cls(model=m, params=params, max_seq=max_seq)

    def generate(self, batch: dict, n_tokens: int, progress_cb=None):
        """Greedy decode of n_tokens after the prompt, in the reference's
        order; progress_cb(i, n) per token. Returns (B, n_tokens) int32
        numpy. A vlm prompt's patches take cache places too; an ssm model
        has no KV cache, so no max_seq bound (as in the reference)."""
        cfg = self.model.cfg
        S = batch["tokens"].shape[1]
        if cfg.vision is not None:
            S += cfg.vision.n_patches
        if cfg.family != "ssm" and S + n_tokens > self.max_seq:
            raise ValueError(f"generate: prompt {S} + {n_tokens} tokens "
                             f"exceed max_seq {self.max_seq}")
        logits, cache = self.model.prefill(self.params, batch, self.max_seq)
        V = self.model.cfg.vocab_size
        toks = []
        tok = _greedy(logits, V)
        for i in range(n_tokens):
            toks.append(tok)
            logits, cache = self.model.decode_step(self.params, tok, cache)
            tok = _greedy(logits, V)
            if progress_cb is not None:
                progress_cb(i + 1, n_tokens)
        return torch.cat(toks, dim=1).cpu().numpy()


def _greedy(logits, V):
    return torch.argmax(logits[:, -1:, :V], dim=-1).to(torch.int32)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)
