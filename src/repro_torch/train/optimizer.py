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

from typing import NamedTuple

import torch

from ..ckpt.checkpoint import tree_leaves, tree_leaves_with_paths, tree_map


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
    config's block pattern)."""

    def __init__(self, lr=1e-3, decay=0.8, eps=1e-30, clip=1.0,
                 weight_decay=0.0, min_dim_size_to_factor=128,
                 stack_period=1):
        self.lr, self.decay, self.eps, self.clip = lr, decay, eps, clip
        self.wd = weight_decay
        self.min_factor = min_dim_size_to_factor
        self.stack_period = stack_period

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
        """One step, in place; returns (params, state)."""
        step = state.step + 1
        t = _step_f32(step)
        beta = 1.0 - torch.pow(t, -self.decay)
        lr = self.lr * lr_scale

        def stats(g, p, vr, vc, v):
            g2 = g.to(torch.float32) ** 2 + self.eps
            if self._factored(p):
                vr.mul_(beta).add_((1 - beta) * torch.mean(g2, dim=-1))
                vc.mul_(beta).add_((1 - beta) * torch.mean(g2, dim=-2))
            else:
                v.mul_(beta).add_((1 - beta) * g2)

        tree_map(stats, grads, params, state.vr, state.vc, state.v)

        def direction(g, p, vr, vc, v):
            g = g.to(torch.float32)
            if self._factored(p):
                r_factor = vr / torch.clamp(
                    torch.mean(vr, dim=-1, keepdim=True), min=self.eps)
                return g / torch.sqrt(r_factor[..., None] * vc[..., None, :]
                                      + self.eps)
            return g / torch.sqrt(v + self.eps)

        upd = tree_map(direction, grads, params, state.vr, state.vc, state.v)
        sums: dict = {}
        for path, u in tree_leaves_with_paths(upd):
            key = self._clip_group(path)
            s, n = sums.get(key, (0.0, 0))
            sums[key] = (s + torch.sum(u * u), n + u.numel())
        flat_p = dict(tree_leaves_with_paths(params))
        for path, u in tree_leaves_with_paths(upd):
            s, n = sums[self._clip_group(path)]
            rms = torch.sqrt(s / n + 1e-30)
            u = u / torch.clamp(rms / self.clip, min=1.0)
            p = flat_p[path]
            p32 = p.to(torch.float32)
            p.copy_(p32 - lr * (u + self.wd * p32))
        return params, AdafactorState(step, state.vr, state.vc, state.v)

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
