"""Transformer stack for the dense, moe, vlm and audio families;
counterpart of `repro.models.transformer`.

The reference stacks each block's parameters with a leading `steps` axis
and runs `lax.scan` over pattern steps (a pattern is the repeating unit:
one block for most archs, [local, global] for gemma2). The port keeps one
parameter dict per layer in `params["blocks"]` and loops in Python: layer
l is step l // len(specs) and uses spec l % len(specs). KV caches are one
{"k", "v"} dict per layer, each (B, max_seq, K, Dh) in bf16.

moe blocks replace the MLP with `moe.apply_moe` and add its aux loss;
vlm prepends its projected patch embeddings to the text and attends
with a prefix-LM mask over them (`prefix_len = n_patches`); audio
projects its frame features and attends bidirectionally (`causal=False`
in its config). The vision and audio front ends are stubs, as in the
reference: the batch carries patch embeddings and frame features.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as A
from . import layers as L
from . import moe as MOE
from ..sharding.planner import (cache_zeros, constrain, reduce_partial,
                                replicate_like)
from .param import normal


class Pattern(NamedTuple):
    specs: tuple            # tuple[A.MaskSpec], one per block in the unit
    steps: int              # repeats of the unit


#: the families the port builds; this stack runs the first four, and
#: `model.py` builds ssm and hybrid over `mamba2.py`
FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")
TRANSFORMER_FAMILIES = FAMILIES[:4]
#: the config extensions each family has, and no other
_EXTENSIONS = {"moe": ("moe",), "vlm": ("vision",), "audio": ("audio",),
               "ssm": ("ssm",), "hybrid": ("ssm", "hybrid")}


def check_supported(cfg, families=FAMILIES) -> None:
    """Raise for a family not in `families` or a config whose extensions
    do not match its family."""
    if cfg.family not in families:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not one of "
            f"{', '.join(families)} (ROADMAP.md lists the port's families)")
    want = _EXTENSIONS.get(cfg.family, ())
    for ext in ("moe", "vision", "audio", "ssm", "hybrid"):
        if (ext in want) != (getattr(cfg, ext) is not None):
            raise ValueError(f"{cfg.name}: family {cfg.family!r} with "
                             f"{ext} {getattr(cfg, ext)!r}")


def block_pattern(cfg, prefix_len: int = 0) -> Pattern:
    if cfg.alt_local_global:
        if cfg.n_layers % 2:
            raise ValueError(f"{cfg.name}: alternating local/global layers "
                             f"need an even n_layers, got {cfg.n_layers}")
        local = A.MaskSpec(causal=cfg.causal, window=cfg.sliding_window,
                           prefix_len=prefix_len)
        glob = A.MaskSpec(causal=cfg.causal, window=None,
                          prefix_len=prefix_len)
        return Pattern((local, glob), cfg.n_layers // 2)
    spec = A.MaskSpec(causal=cfg.causal, window=cfg.sliding_window,
                      prefix_len=prefix_len)
    return Pattern((spec,), cfg.n_layers)


def layer_specs(cfg, prefix_len: int = 0) -> list:
    """The mask spec of each layer, in order."""
    specs = block_pattern(cfg, prefix_len).specs
    return [specs[i % len(specs)] for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------


def init_block(cfg, dtype, generator=None, device=None):
    def zeros():
        return torch.zeros((cfg.d_model,), dtype=dtype, device=device)

    kw = dict(generator=generator, device=device)
    p = {"ln1": zeros(),
         "attn": A.init_attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim, dtype, **kw),
         "ln2": zeros()}
    if cfg.moe is not None:
        p["moe"] = MOE.init_moe(cfg.d_model, cfg.moe, cfg.activation, dtype,
                                **kw)
    else:
        p["mlp"] = L.init_mlp(cfg.d_model, cfg.d_ff, cfg.activation, dtype,
                              **kw)
    if cfg.post_block_norms:
        p["ln1_post"] = zeros()
        p["ln2_post"] = zeros()
    return p


def apply_block(p, x, positions, cfg, spec, cache=None, pos=None):
    """Returns (x, new_cache_or_kv, aux); aux is the moe layer's load
    balance loss, 0 elsewhere."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cache is None:
        attn_out, kv = A.attention_full(p["attn"], h, positions, cfg, spec)
    else:
        attn_out, kv = A.attention_decode(p["attn"], h, cache["k"],
                                          cache["v"], pos, cfg, spec)
    if cfg.post_block_norms:
        attn_out = L.rms_norm(attn_out, p["ln1_post"], cfg.norm_eps)
    x = x + attn_out
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        mlp_out, aux = MOE.apply_moe(p["moe"], h, cfg.moe, cfg.activation)
    else:
        mlp_out = L.apply_mlp(p["mlp"], h, cfg.activation)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.post_block_norms:
        mlp_out = L.rms_norm(mlp_out, p["ln2_post"], cfg.norm_eps)
    x = x + mlp_out
    return x, {"k": kv[0], "v": kv[1]}, aux


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def padded_vocab(cfg) -> int:
    return (cfg.vocab_size + 31) // 32 * 32


def init_params(cfg, generator=None, dtype=None, device=None):
    """{"embed", "blocks" (one dict per layer), "final_norm", "lm_head"}
    (+ "vision_proj" (embed_dim, d_model) for vlm, "frame_proj"
    (frame_dim, d_model) for audio) in `cfg.param_dtype` unless `dtype`
    is given, drawn from `generator` (which must live on `device`)."""
    check_supported(cfg, TRANSFORMER_FAMILIES)
    dtype = dtype or getattr(torch, cfg.param_dtype)
    kw = dict(generator=generator, device=device)
    Vp = padded_vocab(cfg)
    params = {
        "embed": L.init_embed(Vp, cfg.d_model, dtype, **kw),
        "blocks": [init_block(cfg, dtype, **kw)
                   for _ in range(cfg.n_layers)],
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=device),
        "lm_head": normal((cfg.d_model, Vp), dtype=dtype, **kw),
    }
    if cfg.vision is not None:
        params["vision_proj"] = normal(
            (cfg.vision.embed_dim, cfg.d_model), dtype=dtype, **kw)
    if cfg.audio is not None:
        params["frame_proj"] = normal(
            (cfg.audio.frame_dim, cfg.d_model), dtype=dtype, **kw)
    return params


def _embed_inputs(params, batch, cfg):
    """-> (x (B,S,D), prefix_len): vlm's projected patch embeddings
    before its embedded text (prefix_len = n_patches), audio's projected
    frames, or the embedded text. A DTensor projection is gathered whole
    before its product (`layers.weight`): its d_model takes no
    tensor-parallel axis."""
    check_supported(cfg, TRANSFORMER_FAMILIES)
    cdt = getattr(torch, cfg.compute_dtype)
    dev = params["embed"].device

    def embed_text():
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        return L.embed_tokens(params["embed"].to(cdt), tokens,
                              cfg.embed_scale)

    if cfg.vision is not None:
        patches = torch.as_tensor(batch["patch_embeds"], device=dev).to(cdt)
        pe = patches @ L.weight(params["vision_proj"], patches, ())
        return torch.cat([pe, embed_text()], dim=1), cfg.vision.n_patches
    if cfg.audio is not None:
        frames = torch.as_tensor(batch["frames"], device=dev).to(cdt)
        return frames @ L.weight(params["frame_proj"], frames, ()), 0
    return embed_text(), 0


def _positions(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(
        B, S)


#: the ops whose outputs `remat="dots"` keeps: the weight products. Every
#: product of a weight in a block is a 3-d activation times a 2-d weight,
#: which `matmul` folds to one `mm` (`attention._project`, `_out_project`,
#: `layers.apply_mlp`, the router of `moe.apply_moe`): the reference's
#: `dots_with_no_batch_dims_saveable` keeps the same outputs. The experts'
#: `torch.bmm` over E and the attention operator are recomputed, as the
#: reference's batch-dimension einsums are. (`torch.einsum` lowers even a
#: contraction with no batch dim to `bmm`: such a product would not be
#: kept.)
SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of `remat="dots"`: keep the weight
    products' outputs, recompute everything else."""
    if op in SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def dots_context():
    """The `context_fn` of a block checkpointed under `remat="dots"`."""
    return create_selective_checkpoint_contexts(dots_policy)


def forward(params, batch, cfg, remat=True):
    """Full forward to float32 logits (B, S, Vp); returns (logits, aux).

    With `remat` and `cfg.remat != "none"`, while autograd records, each
    block runs under `torch.utils.checkpoint` (non-reentrant). Under
    `"full"` it keeps only its inputs and recomputes its activations in
    the backward, so its attention runs twice a step. Under `"dots"` it
    is a selective checkpoint (`dots_policy`): it also keeps the outputs
    of its weight products (q, k, v and output projections, the MLP's
    gate, up and down, the router) and recomputes the rest, the attention
    among it. The values, and so the losses and gradients, are the same
    bits under "full", "dots" and "none"; only the work and the memory
    differ. The reference checkpoints each scan step (one pattern unit)."""
    x, prefix_len = _embed_inputs(params, batch, cfg)
    B, S, _ = x.shape
    positions = replicate_like(_positions(B, S, x.device), x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat and cfg.remat != "none" and torch.is_grad_enabled()
    kw = {"context_fn": dots_context} if cfg.remat == "dots" else {}
    for p, spec in zip(params["blocks"], layer_specs(cfg, prefix_len),
                       strict=True):
        x = constrain(x, ("batch", "seq", None))
        if remat:
            x, a = checkpoint(_block_train, p, x, positions, cfg, spec,
                              use_reentrant=False, **kw)
        else:
            x, a = _block_train(p, x, positions, cfg, spec)
        aux = aux + a
    # the head's vocabulary takes the model axis: a sequence sharded on
    # it is gathered first
    x = L.rms_norm(constrain(x, ("batch", None, None)), params["final_norm"],
                   cfg.norm_eps)
    logits = L.logits_head(params["lm_head"], x, cfg.final_softcap)
    return constrain(logits, ("batch", "seq", "vocab")), aux


def _block_train(p, x, positions, cfg, spec):
    """apply_block without its kv: (x, aux)."""
    x, _, aux = apply_block(p, x, positions, cfg, spec)
    return x, aux


def loss_fn(params, batch, cfg, remat=True):
    """Next-token CE, or frame-target CE for a bidirectional encoder (+
    the moe aux loss, 0 elsewhere). Returns (loss, metrics). As in the
    reference, position t's logits are held against labels[t + 1] (the
    batch's labels are already the next tokens), over the first
    vocab_size logits; vlm's loss covers the text positions only."""
    logits, aux = forward(params, batch, cfg, remat)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    V = cfg.vocab_size
    if not cfg.causal:
        ce = L.cross_entropy(logits, torch.clamp(labels, min=0),
                             mask=labels >= 0, n_valid=V)
    else:
        ce = L.next_token_ce(logits, labels, V, prefix=cfg.vision.n_patches
                             if cfg.vision is not None else 0)
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux_loss": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg, batch, max_seq, dtype=torch.bfloat16, device=None):
    """Zero KV cache: one {"k", "v"} dict per layer, (B, max_seq, K, Dh)."""
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def prefill(params, batch, cfg, max_seq=None):
    """Run the prompt; returns (last-position logits, caches, lengths).
    A vlm prompt is its patches and then its text; its length counts
    both, and decode continues after the text.

    Each layer's k and v go into its bf16 cache as they come (the
    reference pads and casts the stacked kv after the scan: the same
    values). Under a plan the caches are made placed by its
    `cache_spec_tree`, and each rank writes its own shard
    (`attention.write_prefix`)."""
    x, prefix_len = _embed_inputs(params, batch, cfg)
    x = reduce_partial(x)
    B, S, _ = x.shape
    max_seq = max_seq or S
    if max_seq < S:
        raise ValueError(f"prefill: max_seq {max_seq} < prompt length {S}")
    positions = replicate_like(_positions(B, S, x.device), x)
    caches = cache_zeros(lambda d: init_cache(cfg, B, max_seq, device=d),
                         B, x)
    for p, spec, cache in zip(params["blocks"],
                              layer_specs(cfg, prefix_len), caches,
                              strict=True):
        x, kv, _ = apply_block(p, x, positions, cfg, spec)
        A.write_prefix(cache["k"], kv["k"])
        A.write_prefix(cache["v"], kv["v"])
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = L.logits_head(params["lm_head"], x, cfg.final_softcap)
    lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, caches, lengths


def decode_step(params, tokens, caches, lengths, cfg):
    """One decode step. tokens: (B,1) int32; lengths: (B,) current
    positions. Writes each layer's cache in place. Returns (logits
    (B,1,V), caches, lengths+1). The masks have no prefix here, as in
    the reference: a decoded token is past any prefix."""
    check_supported(cfg, TRANSFORMER_FAMILIES)
    cdt = getattr(torch, cfg.compute_dtype)
    x = reduce_partial(L.embed_tokens(params["embed"].to(cdt), tokens,
                                      cfg.embed_scale))
    for p, spec, cache in zip(params["blocks"], layer_specs(cfg), caches,
                              strict=True):
        x, _, _ = apply_block(p, x, None, cfg, spec, cache=cache,
                              pos=lengths)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.logits_head(params["lm_head"], x, cfg.final_softcap)
    return logits, caches, lengths + 1
