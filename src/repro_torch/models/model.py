"""Model interface over every family; counterpart of
`repro.models.model`.

`build(cfg)` returns a `Model` with:
  init(seed=0, device=None)        -> parameters
  forward(params, batch)           -> (logits, aux)
  prefill(params, batch, max_seq)  -> (logits, cache)   [serving]
  decode_step(params, tokens, cache) -> (logits, cache)
  loss_fn(params, batch)           -> (loss, metrics)    [training]
  init_cache(batch, max_seq, device) -> the empty cache (the reference's
                                      `cache_spec`, as zeros)

`build` dispatches on `cfg.family` as the reference does: dense, moe,
vlm and audio over `transformer.py`; ssm (Mamba2 layers only) and hybrid
(groups of Mamba2 layers, each group followed by one application of a
single shared attention block, then tail layers) over `mamba2.py`.

Cache convention, as in the reference: a dict with family-specific
leaves plus "lengths" (B,) int32 holding the current position.
Transformer families: "kv" (one {"k", "v"} dict per layer). ssm:
"states", one (conv_x, conv_B, conv_C, ssm) tuple per layer (bf16 conv
states, f32 ssm). hybrid: "groups" (a list of each group's state
tuples), "kv" (one bf16 {"k", "v"} pair of (B, max_seq, K, Dh) per
group: every application of the shared block has its own cache) and
"tail" (the tail layers' states). The reference stacks layers and
`lax.scan`s over them; the port keeps one dict per layer and loops. An
audio encoder has no decode (`cfg.has_decode`).

Sharded serving: `prefill` and `decode_step` on parameters, prompts,
tokens and caches placed as DTensors (`sharding.planner.
place_serve_state`) under `plan_context` run as eager SPMD, and give
their caches back in the plan's `cache_spec_tree` placements
(`planner.cache_placed`), as the reference's dry run jits them with the
cache specs as out_shardings. The `Engine` stays unsharded, as the
reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..sharding.planner import (cache_placed, cache_zeros, reduce_partial,
                                replicate_like)
from . import attention as A
from . import layers as L
from . import mamba2 as M2
from . import transformer as TF
from .param import normal


@dataclass
class Model:
    cfg: Any
    init: Callable
    forward: Callable
    prefill: Callable
    decode_step: Callable
    loss_fn: Callable
    init_cache: Callable


def build(cfg) -> Model:
    TF.check_supported(cfg)
    if cfg.family == "ssm":
        return _build_ssm(cfg)
    if cfg.family == "hybrid":
        return _build_hybrid(cfg)
    return _build_transformer(cfg)


def _generator(seed, device):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen, dev


def _lengths(B, value, device):
    return torch.full((B,), value, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Transformer families
# ---------------------------------------------------------------------------


def _build_transformer(cfg) -> Model:
    def init(seed=0, device=None):
        gen, dev = _generator(seed, device)
        return TF.init_params(cfg, generator=gen, device=dev)

    def forward(params, batch):
        return TF.forward(params, batch, cfg)

    def prefill(params, batch, max_seq=None):
        logits, caches, lengths = TF.prefill(params, batch, cfg, max_seq)
        return logits, cache_placed({"kv": caches, "lengths": lengths},
                                    lengths.shape[0], logits)

    def decode_step(params, tokens, cache):
        logits, kv, lengths = TF.decode_step(params, tokens, cache["kv"],
                                             cache["lengths"], cfg)
        return logits, cache_placed({"kv": kv, "lengths": lengths},
                                    lengths.shape[0], logits)

    def loss_fn(params, batch):
        return TF.loss_fn(params, batch, cfg)

    def init_cache(batch, max_seq, device=None):
        dev = resolve_device(device)
        return {"kv": TF.init_cache(cfg, batch, max_seq, device=dev),
                "lengths": _lengths(batch, 0, dev)}

    return Model(cfg, init, forward, prefill, decode_step, loss_fn,
                 init_cache)


# ---------------------------------------------------------------------------
# ssm (mamba2) and hybrid (zamba2): the parts they share
# ---------------------------------------------------------------------------


def _init_params(cfg, seed, device, body):
    """An ssm or hybrid model's parameters in the reference's order:
    embed, then `body(dtype, generator=, device=)`'s layers, final_norm,
    lm_head, all in `cfg.param_dtype`."""
    gen, dev = _generator(seed, device)
    pdt = getattr(torch, cfg.param_dtype)
    kw = dict(generator=gen, device=dev)
    Vp = TF.padded_vocab(cfg)
    out = {"embed": L.init_embed(Vp, cfg.d_model, pdt, **kw)}
    out.update(body(pdt, **kw))
    out["final_norm"] = torch.zeros((cfg.d_model,), dtype=pdt, device=dev)
    out["lm_head"] = normal((cfg.d_model, Vp), dtype=pdt, **kw)
    return out


def _embed(params, tokens, cfg):
    """The embedded tokens; a DTensor table's partial rows reduced
    (`reduce_partial`) before the first layer's norm and casts."""
    cdt = getattr(torch, cfg.compute_dtype)
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    return reduce_partial(L.embed_tokens(params["embed"].to(cdt), tokens,
                                         cfg.embed_scale))


def _head(params, x, cfg):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.logits_head(params["lm_head"], x, cfg.final_softcap)


def _next_token_loss(forward, params, batch, cfg):
    """Next-token CE over the first vocab_size logits (no aux loss),
    reduced where DTensor logits lie (`layers.next_token_ce`)."""
    logits, aux = forward(params, batch)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    ce = L.next_token_ce(logits, labels, cfg.vocab_size)
    return ce, {"loss": ce, "ce": ce, "aux_loss": aux}


def _remat(cfg) -> bool:
    """Checkpoint each scan step's work, as the reference does, while
    autograd records: whole, under "dots" too (the reference's ssm and
    hybrid scans take `jax.checkpoint` with no policy)."""
    return cfg.remat != "none" and torch.is_grad_enabled()


def _mamba_only(p, x, cfg):
    return M2.apply_mamba_full(p, x, cfg)[0]


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Pure SSM (mamba2)
# ---------------------------------------------------------------------------


def _build_ssm(cfg) -> Model:
    def init(seed=0, device=None):
        return _init_params(cfg, seed, device, lambda dt, **kw: {
            "blocks": [M2.init_mamba_block(cfg, dt, **kw)
                       for _ in range(cfg.n_layers)]})

    def forward(params, batch, remat=True):
        x = _embed(params, batch["tokens"], cfg)
        remat = remat and _remat(cfg)
        for p in params["blocks"]:
            x = checkpoint(_mamba_only, p, x, cfg, use_reentrant=False) \
                if remat else _mamba_only(p, x, cfg)
        return _head(params, x, cfg), _zero(x)

    def loss_fn(params, batch):
        return _next_token_loss(forward, params, batch, cfg)

    @torch.no_grad()
    def prefill(params, batch, max_seq=None):
        """The prompt's last logits and every layer's states; no max_seq
        bound, as in the reference: the states do not grow."""
        x = _embed(params, batch["tokens"], cfg)
        states = []
        for p in params["blocks"]:
            x, st = M2.apply_mamba_full(p, x, cfg)
            states.append(st)
        logits = _head(params, x[:, -1:], cfg)
        return logits, cache_placed({
            "states": states, "lengths": _lengths(x.shape[0], x.shape[1],
                                                  x.device)},
            x.shape[0], logits)

    @torch.no_grad()
    def decode_step(params, tokens, cache):
        x = _embed(params, tokens, cfg)
        states = []
        for p, st in zip(params["blocks"], cache["states"], strict=True):
            x, st = M2.apply_mamba_decode(p, x, st, cfg)
            states.append(st)
        logits = _head(params, x, cfg)
        return logits, cache_placed({"states": states,
                                     "lengths": cache["lengths"] + 1},
                                    x.shape[0], logits)

    def init_cache(batch, max_seq=None, device=None):
        dev = resolve_device(device)
        return {"states": [M2.zero_states(cfg, batch, dev)
                           for _ in range(cfg.n_layers)],
                "lengths": _lengths(batch, 0, dev)}

    return Model(cfg, init, forward, prefill, decode_step, loss_fn,
                 init_cache)


# ---------------------------------------------------------------------------
# Hybrid (zamba2): mamba groups + one shared attention block
# ---------------------------------------------------------------------------


def _hybrid_layout(cfg):
    """(n_groups, mamba layers per group, tail layers): groups of
    shared_attn_every layers, the last of each the shared block."""
    per = cfg.hybrid.shared_attn_every
    n_groups = cfg.n_layers // per              # 13 for 81 layers, per 6
    inner = per - 1
    tail = cfg.n_layers - n_groups * per
    return n_groups, inner, tail


def _build_hybrid(cfg) -> Model:
    n_groups, inner, tail = _hybrid_layout(cfg)
    spec = A.MaskSpec(causal=True, window=None, prefix_len=0)

    def init(seed=0, device=None):
        return _init_params(cfg, seed, device, lambda dt, **kw: {
            "groups": [[M2.init_mamba_block(cfg, dt, **kw)
                        for _ in range(inner)] for _ in range(n_groups)],
            "shared_attn": TF.init_block(cfg, dt, **kw),
            "tail": [M2.init_mamba_block(cfg, dt, **kw)
                     for _ in range(tail)]})

    def group_train(group, shared, x, positions):
        for p in group:
            x = _mamba_only(p, x, cfg)
        return TF.apply_block(shared, x, positions, cfg, spec)[0]

    def forward(params, batch, remat=True):
        x = _embed(params, batch["tokens"], cfg)
        positions = TF._positions(x.shape[0], x.shape[1], x.device)
        remat = remat and _remat(cfg)
        for group in params["groups"]:
            args = (group, params["shared_attn"], x, positions)
            x = checkpoint(group_train, *args, use_reentrant=False) \
                if remat else group_train(*args)
        for p in params["tail"]:
            x = checkpoint(_mamba_only, p, x, cfg, use_reentrant=False) \
                if remat else _mamba_only(p, x, cfg)
        return _head(params, x, cfg), _zero(x)

    def loss_fn(params, batch):
        return _next_token_loss(forward, params, batch, cfg)

    def kv_cache(batch, max_seq, device):
        shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return [{"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
                 "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}
                for _ in range(n_groups)]

    @torch.no_grad()
    def prefill(params, batch, max_seq=None):
        """Each group's k and v go into its bf16 cache as they come (the
        reference pads and casts the stacked kv after the scan: the same
        values)."""
        x = _embed(params, batch["tokens"], cfg)
        B, S, _ = x.shape
        max_seq = max_seq or S
        if max_seq < S:
            raise ValueError(f"prefill: max_seq {max_seq} < prompt length "
                             f"{S}")
        positions = replicate_like(TF._positions(B, S, x.device), x)
        kv = cache_zeros(lambda d: kv_cache(B, max_seq, d), B, x)
        groups, tails = [], []
        for group, cache in zip(params["groups"], kv, strict=True):
            states = []
            for p in group:
                x, st = M2.apply_mamba_full(p, x, cfg)
                states.append(st)
            groups.append(states)
            x, new, _ = TF.apply_block(params["shared_attn"], x, positions,
                                       cfg, spec)
            A.write_prefix(cache["k"], new["k"])
            A.write_prefix(cache["v"], new["v"])
        for p in params["tail"]:
            x, st = M2.apply_mamba_full(p, x, cfg)
            tails.append(st)
        logits = _head(params, x[:, -1:], cfg)
        return logits, cache_placed({
            "groups": groups, "kv": kv, "tail": tails,
            "lengths": _lengths(B, S, x.device)}, B, logits)

    @torch.no_grad()
    def decode_step(params, tokens, cache):
        """One token; writes each group's kv cache in place."""
        x = _embed(params, tokens, cfg)
        pos = cache["lengths"]
        groups, tails = [], []
        for group, states, kv in zip(params["groups"], cache["groups"],
                                     cache["kv"], strict=True):
            new = []
            for p, st in zip(group, states, strict=True):
                x, st = M2.apply_mamba_decode(p, x, st, cfg)
                new.append(st)
            groups.append(new)
            x, _, _ = TF.apply_block(params["shared_attn"], x, None, cfg,
                                     spec, cache=kv, pos=pos)
        for p, st in zip(params["tail"], cache["tail"], strict=True):
            x, st = M2.apply_mamba_decode(p, x, st, cfg)
            tails.append(st)
        logits = _head(params, x, cfg)
        return logits, cache_placed({
            "groups": groups, "kv": cache["kv"], "tail": tails,
            "lengths": pos + 1}, x.shape[0], logits)

    def init_cache(batch, max_seq, device=None):
        dev = resolve_device(device)
        return {"groups": [[M2.zero_states(cfg, batch, dev)
                            for _ in range(inner)] for _ in range(n_groups)],
                "kv": kv_cache(batch, max_seq, dev),
                "tail": [M2.zero_states(cfg, batch, dev)
                         for _ in range(tail)],
                "lengths": _lengths(batch, 0, dev)}

    return Model(cfg, init, forward, prefill, decode_step, loss_fn,
                 init_cache)
