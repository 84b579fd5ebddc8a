"""Converters from the reference's state to the port's.

The simulator's state is the trace (a JobSet), the per-job Algorithm-1
inputs (a JobSpec), the simulator parameters and, under capacity, a
strategy's AttemptTable; the model's is its parameter tree, and the
trainer's adds the optimizer's state. These functions take that state as plain numpy arrays
and numbers, e.g. `{f: np.asarray(getattr(ref_jobs, f)) for f in ...}`,
so that both packages can be fed the same inputs without this package
importing the reference.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.utility import JobSpec
from .device import resolve_device
from .sim.strategies import SimParams
from .sim.trace import JobSet
from .strategies.table import AttemptTable


def _tensor(a, dtype, device) -> torch.Tensor:
    # a writable copy: arrays viewed from another framework are read-only
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)


def jobset(n_jobs: int, columns: Mapping[str, np.ndarray], *,
           device=None) -> JobSet:
    """A JobSet from the reference JobSet's array leaves by field name.

    Per-job and per-task columns are copied as they are (no recompute), so
    the port sees the reference's exact floats; job_id becomes int64.
    """
    dev = resolve_device(device)
    fields = JobSet._fields[1:]
    missing = [f for f in fields if f not in columns]
    if missing:
        raise ValueError(f"jobset: missing columns {missing}")
    dtypes = {"n_tasks": np.int32, "job_class": np.int32,
              "job_id": np.int64}
    out = {f: _tensor(columns[f], dtypes.get(f, np.float32), dev)
           for f in fields}
    return JobSet(n_jobs=int(n_jobs), **out)


def jobspec(columns: Mapping[str, np.ndarray], *, device=None) -> JobSpec:
    """A JobSpec of f32 tensors from the reference JobSpec's leaves."""
    dev = resolve_device(device)
    return JobSpec(*(_tensor(columns[f], np.float32, dev)
                     for f in JobSpec._fields))


def simparams(fields: Mapping[str, float]) -> SimParams:
    """SimParams from the reference SimParams' `_asdict()`."""
    unknown = set(fields) - set(SimParams._fields)
    if unknown:
        raise ValueError(f"simparams: unknown fields {sorted(unknown)}")
    return SimParams(**fields)


def attempt_table(columns: Mapping[str, np.ndarray], *,
                  device=None) -> AttemptTable:
    """An AttemptTable from the reference AttemptTable's arrays by field
    name: task_id / job_id become int64, the times f32, the flags bool."""
    dev = resolve_device(device)
    dtypes = {"task_id": np.int64, "job_id": np.int64, "can_win": np.bool_,
              "active": np.bool_, "is_primary": np.bool_}
    return AttemptTable(*(_tensor(columns[f], dtypes.get(f, np.float32), dev)
                          for f in AttemptTable._fields))


def _param(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bf16: widen exactly
        return _tensor(a, np.float32, dev).to(torch.bfloat16)
    return _tensor(a, a.dtype, dev)


def model_params(tree: Mapping, cfg, *, device=None) -> dict:
    """The port's parameters (`models.model.build(cfg).init` layout) from
    the reference's `values_of(model.init(key))` as a numpy pytree.

    Transformer families: the reference stacks each block leaf with a
    leading `steps` axis, one dict per spec of the block pattern; layer l
    of the port is step l // len(specs) of spec l % len(specs). ssm:
    "blocks" leaves are (L, ...); layer l is index l. hybrid: "groups"
    leaves are (n_groups, inner, ...), "shared_attn" is one block,
    "tail" leaves are (tail, ...) (None without a tail: an empty list
    here). A 0-dim block leaf (an optimizer's placeholder) goes to every
    layer as it is. Every leaf keeps its type: a moe block's router stays
    f32 whatever `param_dtype` is, as the reference keeps it; the expert
    weights (`moe.wi_gate`, `wi_up`, `wo`, arctic's `moe.dense`) and the
    stub front ends' `vision_proj` and `frame_proj` come across as they
    are."""
    from .models.model import _hybrid_layout
    from .models.transformer import block_pattern, check_supported
    check_supported(cfg)
    dev = resolve_device(device)

    def at(a, idx):
        a = np.asarray(a)
        return a if a.ndim == 0 else a[idx]

    def layer(sub, idx=()):
        return {k: layer(v, idx) if isinstance(v, Mapping)
                else _param(at(v, idx), dev)
                for k, v in sub.items()}

    out = {"embed": _param(tree["embed"], dev)}
    if cfg.family == "ssm":
        out["blocks"] = [layer(tree["blocks"], (i,))
                         for i in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        n_groups, inner, tail = _hybrid_layout(cfg)
        out["groups"] = [[layer(tree["groups"], (g, i)) for i in range(inner)]
                         for g in range(n_groups)]
        out["shared_attn"] = layer(tree["shared_attn"])
        out["tail"] = [layer(tree["tail"], (i,)) for i in range(tail)]
    else:
        pat = block_pattern(cfg)
        stacked = tuple(tree["blocks"])
        if len(stacked) != len(pat.specs):
            raise ValueError(f"model_params: {len(stacked)} stacked block "
                             f"dicts, the pattern has {len(pat.specs)}")
        n = len(pat.specs)
        out["blocks"] = [layer(stacked[i % n], (i // n,))
                         for i in range(cfg.n_layers)]
    out["final_norm"] = _param(tree["final_norm"], dev)
    out["lm_head"] = _param(tree["lm_head"], dev)
    for name in ("vision_proj", "frame_proj"):
        if name in tree:
            out[name] = _param(tree[name], dev)
    return out


def _step(a, dev) -> torch.Tensor:
    return _tensor(a, np.int32, dev).reshape(())


def adamw_state(fields: Mapping, cfg, *, device=None):
    """The port's `AdamWState` from the reference's `AdamWState._asdict()`
    (numpy leaves; m, v and master in the reference's parameter layout).
    The port keeps no master copy of an f32 parameter (it is its own), so
    master becomes None there: the reference's f32 master equals the
    parameter."""
    from .ckpt.checkpoint import tree_map
    from .train.optimizer import AdamWState
    dev = resolve_device(device)
    master = model_params(fields["master"], cfg, device=dev)
    if cfg.param_dtype == "float32":
        master = tree_map(lambda _: None, master)
    return AdamWState(step=_step(fields["step"], dev),
                      m=model_params(fields["m"], cfg, device=dev),
                      v=model_params(fields["v"], cfg, device=dev),
                      master=master)


def adafactor_state(fields: Mapping, cfg, *, device=None):
    """The port's `AdafactorState` from the reference's
    `AdafactorState._asdict()` (numpy leaves in the reference's parameter
    layout; the 0-dim placeholders of factored or unfactored leaves go to
    every layer)."""
    from .train.optimizer import AdafactorState
    dev = resolve_device(device)
    return AdafactorState(step=_step(fields["step"], dev),
                          **{f: model_params(fields[f], cfg, device=dev)
                             for f in ("vr", "vc", "v")})
