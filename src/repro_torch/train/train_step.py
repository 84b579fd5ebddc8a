"""The train step: microbatched gradient accumulation with Chronos
backup-shard (Clone-strategy) masked aggregation; counterpart of
`repro.train.train_step`.

The global batch is split into `n_micro` microbatches run one after
another. Each microbatch is a Chronos "task": the `shard_mask` (n_micro,)
carries the governor's decision of which shards' gradients count; a
dropped straggler or failed backup gets weight 0 and the aggregation
renormalizes by max(sum(mask), 1).

Gradients accumulate in each parameter's `.grad`: microbatch i adds the
gradient of w_i * loss_i, and the sum is divided by the denominator at
the end. For the 0/1 weights of a mask that is the reference's order
(w_i g_i summed in microbatch order, then divided); other weights scale
the loss before the backward instead of the gradient after it. This
keeps one f32 gradient per parameter, with no separate accumulator
(12.8 GB at gemma2-2b's full width). The "bf16_params" and "bf16_grads"
options take the reference's path instead: per-microbatch gradients of
the compute copies, added into an accumulator of their type.

A parameter that is not f32 (arctic-480b's bf16 ones) gets the
reference's f32 gradient: with two microbatches or more, each
microbatch's gradient is widened (exactly) as soon as it is formed and
added into an f32 accumulator in microbatch order, and the sum is
divided in f32. With one microbatch the weight w / max(w, 1) scales the
loss and nothing is divided (for w <= 1, as a governor's 0/1 mask, the
division was by 1): the gradient stays in the parameter's type, and its
exact widening is left to where it is used, a slice at a time (the norm
here, the optimizer's update). The reference's f32 gradients of one
arctic-480b layer are 56.3 GB; kept in bf16 they are 28.1 GB.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple

import torch

from ..ckpt.checkpoint import tree_leaves, tree_rebuild
from ..device import is_dtensor
from ..sharding.planner import batch_placements, placements, replicate_like
from .optimizer import SLICE_ELEMS, leaf_slices


class TrainState(NamedTuple):
    params: object
    opt_state: object
    step: torch.Tensor      # int32, 0-dim


def make_train_step(model, optimizer, n_micro: int, lr_schedule=None,
                    opts: frozenset = frozenset(), grad_specs=None,
                    mesh=None, micro_scope=contextlib.nullcontext):
    """Returns train_step(state, batch, shard_mask) -> (state, metrics);
    the parameters and the optimizer state are updated in place.
    `micro_scope()` is entered around each microbatch's forward,
    backward and accumulation (the dry run counts one microbatch as
    many; `launch/op_analyzer.py`).

    opts:
      "bf16_params"  cast f32 parameters of 2 or more dims to bf16 once a
                     step, before the microbatches;
      "bf16_grads"   accumulate gradients in bf16;
      "shard_grads"  with `grad_specs` (a `Spec` a parameter) and `mesh`
                     (their `DeviceMesh`): each microbatch's gradient is
                     moved to its spec's placements before it is added
                     (on DTensor parameters, the reduce-scatter inside
                     the loop), as the reference constrains its
                     accumulator to the parameters' shardings.

    DTensor state (`sharding.planner.place_train_state`): every rank runs
    the same step on its shards (eager SPMD), the models' `constrain`
    calls placing the activations under `plan_context`. Without
    "shard_grads" each gradient is reduced once, after the last
    microbatch, to its parameter's placements; the optimizer never meets
    a partial sum. A batch sharded on its rows is laid out as
    (n_micro, rows) with each microbatch's rows sharded alike, which
    gathers the batch once a step. The loss, the gradient norm and the
    active shards come back replicated.
    """
    unknown = set(opts) - {"bf16_params", "bf16_grads", "shard_grads"}
    if unknown:
        raise ValueError(f"make_train_step: unknown opts {sorted(unknown)}")
    shard = "shard_grads" in opts and grad_specs is not None
    if shard and mesh is None:
        raise ValueError("make_train_step: 'shard_grads' with grad_specs "
                         "needs the device mesh of the specs (mesh=)")
    separate = "bf16_params" in opts or "bf16_grads" in opts
    acc_dt = torch.bfloat16 if "bf16_grads" in opts else torch.float32

    def micro_of(batch, device):
        out = {}
        for k, x in batch.items():
            if is_dtensor(x):
                out[k] = micro_rows(x, n_micro)
                continue
            x = torch.as_tensor(x, device=device)
            out[k] = x.reshape((n_micro, x.shape[0] // n_micro)
                               + tuple(x.shape[1:]))
        return out

    def targets(leaves):
        """Each leaf's gradient placements: its grad spec's with
        "shard_grads", else its own; None for a tensor that is not a
        DTensor."""
        specs = tree_leaves(grad_specs) if shard else [None] * len(leaves)
        return [None if not is_dtensor(p) else
                placements(spec, mesh) if shard else tuple(p.placements)
                for p, spec in zip(leaves, specs, strict=True)]

    def grads_in_place(params, micro, mask, denom):
        """The .grad path; returns (loss sum, gradient leaves)."""
        leaves = tree_leaves(params)
        want = targets(leaves)
        one = n_micro == 1
        # a leaf that is not f32, with 2 microbatches or more: its f32 sum
        acc = {j: None for j, p in enumerate(leaves)
               if p.dtype != torch.float32 and not one}
        hooks = []
        for j, (p, t) in enumerate(zip(leaves, want)):
            p.requires_grad_(True)
            p.grad = None
            if j in acc or (shard and t is not None):
                hooks.append(p.register_post_accumulate_grad_hook(
                    functools.partial(_take_grad, j=j, acc=acc,
                                      placements=t if shard else None)))
        weight = mask / denom if one else mask
        loss_sum = torch.zeros((), dtype=torch.float32, device=mask.device)
        try:
            for i in range(n_micro):
                with micro_scope():
                    mb = {k: x[i] for k, x in micro.items()}
                    loss, _ = model.loss_fn(params, mb)
                    (weight[i] * loss).backward()
                    loss_sum = loss_sum + mask[i] * loss.detach()
        finally:
            for h in hooks:
                h.remove()

        # a leaf the loss does not use (audio's `embed`) gets no gradient;
        # jax.grad gives it zeros, and so does this
        def grad(j, p, t):
            g = acc[j] if j in acc else p.grad
            if g is None:
                return torch.zeros_like(
                    p, dtype=torch.float32 if j in acc else p.dtype)
            g = _reduced(g, t)
            return g if one else g.div_(denom)

        grads = [grad(j, p, t) for j, (p, t) in enumerate(zip(leaves, want))]
        for p in leaves:
            p.grad = None
        return loss_sum, grads

    def grads_accumulated(params, micro, mask, denom):
        """The reference's path: a gradient a microbatch, added in."""
        def compute(p):
            if ("bf16_params" in opts and p.dtype == torch.float32
                    and p.dim() >= 2):
                p = p.to(torch.bfloat16)
            return p.detach().requires_grad_(True)

        cparams = tree_rebuild(params, iter([compute(p) for p in
                                             tree_leaves(params)]))
        leaves = tree_leaves(cparams)
        want = targets(leaves)
        acc = [None] * len(leaves)
        loss_sum = torch.zeros((), dtype=torch.float32, device=mask.device)
        for i in range(n_micro):
            with micro_scope():
                mb = {k: x[i] for k, x in micro.items()}
                loss, _ = model.loss_fn(cparams, mb)
                gs = torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True)
                for j, (g, t) in enumerate(zip(gs, want)):
                    g = (mask[i] * g.to(torch.float32)).to(acc_dt)
                    if shard:
                        g = _reduced(g, t)
                    if acc[j] is None:
                        acc[j] = torch.zeros_like(g)
                    acc[j].add_(g)
                loss_sum = loss_sum + mask[i] * loss.detach()
        return loss_sum, [_reduced(a, t).to(torch.float32) / denom
                          for a, t in zip(acc, want)]

    def train_step(state: TrainState, batch, shard_mask):
        params = state.params
        device = state.step.device
        mask = torch.as_tensor(shard_mask, dtype=torch.float32,
                               device=device)
        micro = micro_of(batch, device)
        denom = torch.clamp(torch.sum(mask), min=1.0)
        run = grads_accumulated if separate else grads_in_place
        loss_sum, grads = run(params, micro, mask, denom)
        mean_loss = loss_sum / denom
        lr_scale = lr_schedule(state.step) if lr_schedule else 1.0
        grad_tree = tree_rebuild(params, iter(grads))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(_sum_squares(g) for g in grads))
        new_params, new_opt = optimizer.update(grad_tree, state.opt_state,
                                               params, lr_scale=lr_scale)
        del grads, grad_tree
        ref = tree_leaves(params)[0]
        metrics = {"loss": _replicated(mean_loss),
                   "grad_norm": _replicated(gnorm),
                   "active_shards": replicate_like(torch.sum(mask), ref)}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


def _reduced(g, placements):
    """A DTensor gradient in `placements` (a partial sum reduced, a
    replica scattered); `g` itself where it is there already or is not a
    DTensor."""
    if placements is None or tuple(g.placements) == placements:
        return g
    return g.redistribute(g.device_mesh, placements)


def _take_grad(p, j, acc, placements):
    """Post-accumulate-grad hook of leaf j: the accumulated `.grad` into
    `placements` (with "shard_grads"), so that the next microbatch's
    gradient is reduced into it rather than kept as a partial sum; for a
    leaf of `acc` (not f32), this microbatch's gradient widened and added
    into its f32 sum, and `.grad` freed."""
    g = p.grad if placements is None else _reduced(p.grad, placements)
    if j not in acc:
        p.grad = g
        return
    g = g.to(torch.float32)
    acc[j] = g if acc[j] is None else acc[j].add_(g)
    p.grad = None


def _sum_squares(g):
    """The sum of g's squares in f32: an f32 gradient as the reference
    squares it; another type widened a slice at a time (`leaf_slices`)."""
    if g.dtype == torch.float32:
        return torch.sum(g * g)
    total = 0.0
    for s in leaf_slices(g.contiguous(), SLICE_ELEMS):
        s = s.to(torch.float32)
        total = total + torch.sum(s * s)
    return total


def _replicated(x):
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def micro_rows(x, n_micro):
    """A DTensor batch leaf (rows sharded by the plan's `batch_spec`) as
    (n_micro, rows / n_micro, ...), each microbatch's rows sharded as
    the batch's were: microbatch i is rows [i m, (i + 1) m), as the
    reference reshapes it. The rows are gathered once (tokens: a few
    bytes a row) and cut again on each rank without a collective; one
    microbatch needs neither."""
    from torch.distributed.tensor import Replicate, Shard
    if n_micro == 1:
        return x.unsqueeze(0)
    mesh = x.device_mesh
    full = x.redistribute(mesh, [Replicate()] * mesh.ndim)
    full = full.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))
    return full.redistribute(mesh, [Shard(1) if p == Shard(0) else p
                                    for p in batch_placements(x)])


def cosine_schedule(base=1.0, warmup=100, total=10_000, floor=0.1):
    """Linear warm-up to `base`, then a cosine down to `base * floor`;
    fn(step) on an integer tensor, in f32."""
    def fn(step):
        step = step.to(torch.float32)
        warm = torch.clamp(step / warmup, max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base * warm * cos
    return fn
