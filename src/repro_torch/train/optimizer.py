"""AdamW and Adafactor on trees of tensors; counterpart of
`repro.train.optimizer`.

A tree is a tensor, or a dict, list or tuple of trees (the model's
parameter layout: one dict per layer). State is a NamedTuple of trees of
tensors. Unlike the reference's pure functions, `update` writes the new
parameters and state into the given tensors in place (under no_grad) and
returns them: at gemma2-2b's full width each f32 copy is 12.8 GB.

AdamW keeps an f32 master copy only of parameters that are not already
f32; an f32 parameter is its own master (the reference's
`master.astype(p.dtype)` is then the identity), so the results are the
reference's and one 12.8 GB copy is saved.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ckpt.checkpoint import tree_leaves, tree_leaves_with_paths, tree_map
from ..device import is_dtensor


def _device_of(tree) -> torch.device:
    return tree_leaves(tree)[0].device


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32, 0-dim
    m: object
    v: object
    master: object          # f32 master copies; None where the parameter
    #                         is f32 (its own master)


class AdafactorState(NamedTuple):
    step: torch.Tensor      # int32, 0-dim
    vr: object              # row stats (mean over the last dim)
    vc: object              # column stats (mean over the second-to-last)
    v: object               # full stats for unfactored leaves


def _step_f32(step):
    return step.to(torch.float32)


#: the elements of one slice that `leaf_slices` cuts by default: 1 GiB
#: in f32
SLICE_ELEMS = 1 << 28


def leaf_slices(x, max_elems: int, inner: int = 0) -> list:
    """Views of `x` that together cover it in order: x seen as (units,
    *trailing), a unit its `inner` trailing dims (one (rows, cols) matrix
    for inner 2) or one element (inner 0), cut along the units into
    views of at most `max_elems` elements where whole units allow (at
    least one unit a view). `x` must be contiguous (`view` raises
    otherwise); a DTensor is one slice, as it is."""
    if is_dtensor(x):
        return [x]
    trailing = tuple(x.shape[x.dim() - inner:]) if inner else ()
    flat = x.view((-1,) + trailing)
    k = max(1, max_elems // max(1, math.prod(trailing)))
    return [flat[i:i + k] for i in range(0, flat.shape[0], k)]


def _matrices(g, vr, vc):
    """(g, vr, vc) of each (rows, cols) matrix of a slice: a matrix's row
    and column means then do not depend on how many matrices its slice
    holds, as a batched reduction's bits do on the card. A DTensor leaf
    (one slice) is taken whole."""
    return [(g, vr, vc)] if is_dtensor(g) else zip(g, vr, vc, strict=True)


class AdamW:
    def __init__(self, lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0):
        self.lr, self.b1, self.b2, self.eps, self.wd = (lr, b1, b2, eps,
                                                        weight_decay)

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return AdamWState(
            step=torch.zeros((), dtype=torch.int32,
                             device=_device_of(params)),
            m=tree_map(zeros, params), v=tree_map(zeros, params),
            master=tree_map(lambda p: None if p.dtype == torch.float32
                            else p.detach().to(torch.float32), params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, lr_scale=1.0):
        """One step, in place: the reference's op order, leaf by leaf.
        Returns (params, state)."""
        step = state.step + 1
        t = _step_f32(step)
        b1, b2 = self.b1, self.b2
        lr = self.lr * lr_scale
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                           device=t.device), t)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                           device=t.device), t)

        def leaf(g, p, m, v, master):
            g = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            ma = p if master is None else master
            u = m / bc1
            u.div_(torch.sqrt(v / bc2).add_(self.eps))
            u.add_(ma, alpha=self.wd)
            ma.sub_(u.mul_(lr))
            if master is not None:
                p.copy_(master)

        tree_map(leaf, grads, params, state.m, state.v, state.master)
        return params, AdamWState(step, state.m, state.v, state.master)

    def state_spec_tree(self, param_specs, params_struct=None):
        """Partition specs of the state given the parameters' (the
        reference's: m, v and master take their parameter's spec; an
        f32 parameter's master is None in the state, and its spec goes
        unused). `params_struct` is unused: Adafactor's takes it."""
        from ..sharding.planner import Spec
        return AdamWState(step=Spec(), m=param_specs, v=param_specs,
                          master=param_specs)


class Adafactor:
    """Factored second-moment optimizer (Shazeer & Stern, 2018), no
    momentum.

    The update's RMS clip is taken over one leaf of the reference's tree.
    The reference stacks each block leaf over the layers of one pattern
    position, so layers l and l + `stack_period` of `params["blocks"]`
    share one clip here too (`make_optimizer` sets the period from the
    config's block pattern).

    `update` streams each leaf in slices of at most `slice_elems`
    elements (`leaf_slices`, whole matrices): in f32, one arctic-480b
    layer's (128, 7168, 4864) expert leaf is 17.9 GB, and the whole
    layer's direction 56.3 GB."""

    def __init__(self, lr=1e-3, decay=0.8, eps=1e-30, clip=1.0,
                 weight_decay=0.0, min_dim_size_to_factor=128,
                 stack_period=1, slice_elems=SLICE_ELEMS):
        self.lr, self.decay, self.eps, self.clip = lr, decay, eps, clip
        self.wd = weight_decay
        self.min_factor = min_dim_size_to_factor
        self.stack_period = stack_period
        self.slice_elems = slice_elems

    def _factored(self, p):
        return p.dim() >= 2 and p.shape[-1] >= self.min_factor and \
            p.shape[-2] >= self.min_factor

    def init(self, params) -> AdafactorState:
        def zeros(shape, p):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vr(p):
            return zeros(p.shape[:-1] if self._factored(p) else (), p)

        def vc(p):
            return zeros(p.shape[:-2] + p.shape[-1:] if self._factored(p)
                         else (), p)

        def vfull(p):
            return zeros(() if self._factored(p) else p.shape, p)

        return AdafactorState(
            step=torch.zeros((), dtype=torch.int32,
                             device=_device_of(params)),
            vr=tree_map(vr, params), vc=tree_map(vc, params),
            v=tree_map(vfull, params))

    def _clip_group(self, path):
        """The reference's leaf that holds `path`: block leaves of layers
        congruent modulo `stack_period` are one stacked leaf there."""
        if len(path) > 1 and path[0] == "blocks":
            return ("blocks", path[1] % self.stack_period) + path[2:]
        return path

    @torch.no_grad()
    def update(self, grads, state: AdafactorState, params, lr_scale=1.0):
        """One step, in place; returns (params, state).

        Streamed: leaf by leaf, and within a leaf in slices of at most
        `slice_elems` elements along its leading (stack or expert) dims
        (`leaf_slices`), so that no f32 tensor larger than one slice is
        formed (a gradient of another type is widened a slice at a time).
        Three passes: the statistics; the direction, of which only each
        clip group's sum of squares is kept; the direction again,
        recomputed, clipped and applied. A slice holds whole (rows, cols)
        matrices, and a factored leaf's row and column means and its row
        factor's mean are taken one matrix at a time (`_matrices`), so
        every statistic and every element of the direction are the same
        however the leaf is sliced; only each clip group's sum of squares
        is added in another order."""
        step = state.step + 1
        t = _step_f32(step)
        beta = 1.0 - torch.pow(t, -self.decay)
        lr = self.lr * lr_scale
        state_of = [dict(tree_leaves_with_paths(x))
                    for x in (params, state.vr, state.vc, state.v)]
        leaves = [(path, g, *(f[path] for f in state_of))
                  for path, g in tree_leaves_with_paths(grads)]

        def parts(g, p, vr, vc, v):
            """(g, p, vr, vc, v) slice by slice: a factored leaf as
            (n, rows, cols) matrices cut along n (vr and vc alike), any
            other elementwise (vr and vc None)."""
            n, g = self.slice_elems, g.contiguous()
            if self._factored(p):
                ps = leaf_slices(p, n, 2)
                return zip(leaf_slices(g, n, 2), ps,
                           leaf_slices(vr, n // p.shape[-1], 1),
                           leaf_slices(vc, n // p.shape[-2], 1),
                           [None] * len(ps), strict=True)
            ps = leaf_slices(p, n)
            return zip(leaf_slices(g, n), ps, [None] * len(ps),
                       [None] * len(ps), leaf_slices(v, n), strict=True)

        for _, *leaf in leaves:
            for part in parts(*leaf):
                self._stats(beta, *part)
        sums: dict = {}
        for path, *leaf in leaves:
            key = self._clip_group(path)
            s, n = sums.get(key, (0.0, 0))
            for part in parts(*leaf):
                u = self._direction(*part)
                s = s + torch.sum(u * u)
                del u
            sums[key] = (s, n + leaf[0].numel())
        for path, *leaf in leaves:
            s, n = sums[self._clip_group(path)]
            rms = torch.sqrt(s / n + 1e-30)
            for part in parts(*leaf):
                u = self._direction(*part)
                u = u / torch.clamp(rms / self.clip, min=1.0)
                p = part[1]
                p32 = p.to(torch.float32)
                p.copy_(p32 - lr * (u + self.wd * p32))
                del u, p32
        return params, AdafactorState(step, state.vr, state.vc, state.v)

    def _stats(self, beta, g, p, vr, vc, v):
        """One slice's statistics, in place: each matrix's row and column
        means of g^2 + eps (factored), else g^2 + eps itself."""
        if vr is None:
            v.mul_(beta).add_((1 - beta) * (g.to(torch.float32) ** 2
                                            + self.eps))
            return
        for g, vr, vc in _matrices(g, vr, vc):
            g2 = g.to(torch.float32) ** 2 + self.eps
            vr.mul_(beta).add_((1 - beta) * torch.mean(g2, dim=-1))
            vc.mul_(beta).add_((1 - beta) * torch.mean(g2, dim=-2))

    def _direction(self, g, p, vr, vc, v):
        """One slice's unclipped update direction, in f32."""
        g = g.to(torch.float32)
        if vr is None:
            return g / torch.sqrt(v + self.eps)
        mean = torch.mean(vr, dim=-1, keepdim=True) if is_dtensor(vr) else \
            torch.stack([torch.mean(r, dim=-1, keepdim=True) for r in vr])
        r_factor = vr / torch.clamp(mean, min=self.eps)
        return g / torch.sqrt(r_factor[..., None] * vc[..., None, :]
                              + self.eps)

    def state_spec_tree(self, param_specs, params_struct):
        """Partition specs of the state given the parameters' specs and
        shapes (the reference's rule): a factored leaf's row statistics
        drop the last dim's entry, its column statistics the
        second-to-last; the 0-dim placeholders replicate."""
        from ..sharding.planner import Spec

        def vr_spec(p, spec):
            return spec[:-1] if self._factored(p) else Spec()

        def vc_spec(p, spec):
            return spec[:-2] + spec[-1:] if self._factored(p) else Spec()

        def v_spec(p, spec):
            return Spec() if self._factored(p) else spec

        return AdafactorState(
            step=Spec(),
            vr=tree_map(vr_spec, params_struct, param_specs),
            vc=tree_map(vc_spec, params_struct, param_specs),
            v=tree_map(v_spec, params_struct, param_specs))


def make_optimizer(cfg, lr=1e-3, weight_decay=0.0):
    if cfg.optimizer == "adafactor":
        from ..models.transformer import block_pattern
        return Adafactor(lr=lr, weight_decay=weight_decay,
                         stack_period=len(block_pattern(cfg).specs))
    return AdamW(lr=lr, weight_decay=weight_decay)
