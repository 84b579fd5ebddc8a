"""Parameter initialisation and logical axes; counterpart of
`repro.models.param`.

The reference wraps each array with logical sharding axes for its
planner and stacks layers into one leaf. The port holds plain tensors in
dicts, one entry per layer, and keeps the axes apart: `param_axes(cfg)`
gives, for each leaf of `build(cfg).init`, its axis names and its stack
depth, the number of layers (or steps of the block pattern) that the
reference stacks into the leaf that holds it. The planner judges a
leaf's size by depth x its elements, as the reference judges the stacked
leaf. Random values come from an explicit `torch.Generator`, so they
differ from `jax.random`'s: the parity tests carry the reference's
weights across with `repro_torch.convert.model_params`.

Logical axis vocabulary (the reference's, less its "layers" axis):
  "vocab", "d_model", "heads", "kv_heads", "head_dim", "ffn",
  "experts", "e_ffn", "ssm_in", "ssm_state", "ssm_heads", "ssm_bc",
  "conv", "patch".
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


def normal(shape, scale=0.02, dtype=torch.float32, generator=None,
           device=None) -> torch.Tensor:
    """scale * N(0, 1) drawn in f32, then cast to `dtype` (as the
    reference draws). Scaled in place: one f32 draw at a time besides the
    result (arctic-480b's (128, 4864, 7168) expert leaf is 17.9 GB in
    f32)."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(dtype)


@dataclass(frozen=True)
class LeafAxes:
    """A leaf's logical axes (one name, or None, a dim) and its stack
    depth. Not a tuple, so tree functions keep it whole."""
    axes: tuple
    depth: int


_D = ("d_model",)
_ATTN = {"wq": ("d_model", "heads", "head_dim"),
         "wk": ("d_model", "kv_heads", "head_dim"),
         "wv": ("d_model", "kv_heads", "head_dim"),
         "wo": ("heads", "head_dim", "d_model")}
_MLP = {"wi_gate": ("d_model", "ffn"), "wi_up": ("d_model", "ffn"),
        "wi": ("d_model", "ffn"), "wo": ("ffn", "d_model")}
_MOE = {"router": ("d_model", "experts"),
        "wi_gate": ("experts", "d_model", "e_ffn"),
        "wi_up": ("experts", "d_model", "e_ffn"),
        "wo": ("experts", "e_ffn", "d_model"), "dense": _MLP}
_BLOCK = {"ln1": _D, "ln2": _D, "ln1_post": _D, "ln2_post": _D,
          "attn": _ATTN, "mlp": _MLP, "moe": _MOE}
_MAMBA = {"ln": _D, "in_z": ("d_model", "ssm_in"),
          "in_x": ("d_model", "ssm_in"), "in_B": ("d_model", "ssm_bc"),
          "in_C": ("d_model", "ssm_bc"), "in_dt": ("d_model", "ssm_heads"),
          "conv_x": ("conv", "ssm_in"), "conv_B": ("conv", "ssm_bc"),
          "conv_C": ("conv", "ssm_bc"), "conv_x_b": ("ssm_in",),
          "conv_B_b": ("ssm_bc",), "conv_C_b": ("ssm_bc",),
          "A_log": ("ssm_heads",), "D": ("ssm_heads",),
          "dt_bias": ("ssm_heads",), "norm": ("ssm_in",),
          "out_proj": ("ssm_in", "d_model")}
_TOP = {"embed": ("vocab", "d_model"), "final_norm": _D,
        "lm_head": ("d_model", "vocab"), "vision_proj": ("patch", "d_model"),
        "frame_proj": ("patch", "d_model")}


def abstract_params(cfg, device="cpu"):
    """`build(cfg).init(seed=0, device=device)` on fake tensors: every
    leaf's shape and type, nothing allocated (full width is fine)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from .model import build
    with FakeTensorMode():
        return build(cfg).init(seed=0, device=device)


def stack_depths(cfg) -> dict:
    """Stack depth of each top-level entry of the parameters: the
    reference's leading "layers" extents multiplied (zamba2's groups
    carry two)."""
    if cfg.family == "ssm":
        return {"blocks": cfg.n_layers}
    if cfg.family == "hybrid":
        from .model import _hybrid_layout
        n_groups, inner, tail = _hybrid_layout(cfg)
        return {"groups": n_groups * inner, "shared_attn": 1, "tail": tail}
    from .transformer import block_pattern
    return {"blocks": block_pattern(cfg).steps}


def param_axes(cfg, params=None) -> dict:
    """A tree with the keys of `build(cfg).init` whose leaves are
    `LeafAxes`: the leaf's logical axes (the reference's `P.axes` less
    its leading "layers" axes) and its stack depth. `params` (any tree
    of the init's layout with shaped leaves) gives the keys; by default
    `abstract_params(cfg)`."""
    if params is None:
        params = abstract_params(cfg)
    depths = stack_depths(cfg)
    layer_rules = _MAMBA if cfg.family in ("ssm", "hybrid") else _BLOCK

    def walk(tree, rules, depth, path):
        if isinstance(tree, dict):
            return {k: walk(v, rules[k], depth, path + (k,))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(t, rules, depth, path + (i,))
                    for i, t in enumerate(tree)]
        if len(tree.shape) != len(rules):
            raise ValueError(f"param_axes: {path} has shape "
                             f"{tuple(tree.shape)}, axes {rules}")
        return LeafAxes(tuple(rules), depth)

    out = {}
    for k, v in params.items():
        if k in _TOP:
            out[k] = walk(v, _TOP[k], 1, (k,))
        elif k == "shared_attn":
            out[k] = walk(v, _BLOCK, depths[k], (k,))
        else:
            out[k] = walk(v, layer_rules, depths[k], (k,))
    return out
