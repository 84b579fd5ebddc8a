"""Elastic scaling: rebuild the mesh after the loss of ranks and
re-shard the state; counterpart of `repro.runtime.elastic`.

On a cluster the coordinator finds the failed hosts, builds a mesh over
the surviving ranks and restarts from the latest checkpoint with new
shardings. `shrink_mesh` picks the largest (data', model) grid of the
surviving ranks (the model axis kept whole: it carries tensor-parallel
layouts), with a `DeviceMesh` over it where a process group spans those
ranks; `reshard_state` places full host tensors (a checkpoint's) or
DTensors of the old mesh on the new plan.

Chronos connection: losing a pod is the extreme straggler. The governor
treats a shrunk mesh as a cost change (fewer cards, a higher price a
step) and solves r* again.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..sharding.planner import Plan, make_plan, place


@dataclass
class ElasticEvent:
    step: int
    lost_devices: int
    new_shape: tuple
    failed_ids: tuple = ()    # explicit failed ranks (may be empty)


def device_id(d) -> int:
    """The rank of a mesh point: an int, or anything with an `id`."""
    return int(getattr(d, "id", d))


@dataclass
class RankGrid:
    """The surviving (data', model) grid of ranks; a mesh to plan on
    (`axis_names`, `shape`), with `device_mesh` the `DeviceMesh` over it
    where a process group spans its ranks, else None."""
    ranks: np.ndarray
    device_mesh: object = None
    axis_names: tuple = ("data", "model")

    @property
    def shape(self) -> tuple:
        return tuple(self.ranks.shape)


def shrink_mesh(ranks, data: int, model: int, lost: int = 0, failed=None,
                device=None) -> RankGrid:
    """The largest (data', model) grid of the surviving ranks.

    Whole data rows (the FSDP axis) are dropped: model groups stay
    intact, so only the batch and FSDP dimension re-shards.

    failed: explicit failed ranks: every data row holding one is dropped,
        wherever it sits, so a loss in the middle of the grid re-shards
        correctly; the surviving rows keep their order.
    lost: the count-based form: the trailing `lost` ranks of the flat
        list failed (valid only where the loss is the trailing slice).

    Where a process group is started and holds every surviving rank,
    every rank of the group must call this (building a `DeviceMesh` is
    collective over the group), on `device` (None: cuda)."""
    grid = np.asarray(ranks).reshape(data, model)
    if failed is not None:
        failed_ids = {device_id(d) for d in failed}
        seen = {device_id(d) for d in grid.reshape(-1)}
        unknown = failed_ids - seen
        if unknown:
            raise ValueError(f"failed device ids {sorted(unknown)} are not "
                             f"in the mesh")
        row_ok = np.array([all(device_id(d) not in failed_ids for d in row)
                           for row in grid])
        rows = grid[row_ok]
    else:
        alive = grid.reshape(-1)[: data * model - lost]
        data_new = len(alive) // model
        rows = alive[: data_new * model].reshape(data_new, model)
    if len(rows) < 1:
        raise RuntimeError("not enough devices for one model group")
    rows = np.vectorize(device_id)(np.asarray(rows)).reshape(len(rows),
                                                            model)
    return RankGrid(rows, _device_mesh(rows, device))


def _device_mesh(rows: np.ndarray, device):
    import torch
    import torch.distributed as dist
    if not dist.is_initialized() or \
            rows.max() >= dist.get_world_size():
        return None
    from torch.distributed.device_mesh import DeviceMesh
    from ..device import resolve_device
    return DeviceMesh(resolve_device(device).type, torch.as_tensor(rows),
                      mesh_dim_names=("data", "model"))


def replan(cfg, mesh) -> Plan:
    return make_plan(cfg, mesh)


def reshard_state(state, old_plan: Plan, new_plan: Plan, axes):
    """Place every leaf of `state` on the new plan's `DeviceMesh` with
    its spec's placements (`axes`: `param_axes` of the state's layout).
    A leaf may be a full host tensor (a checkpoint's) or a DTensor of the
    old mesh, which is gathered first: every rank of the old mesh calls
    this (`sharding.planner.place`)."""
    mesh = new_plan.mesh
    if isinstance(mesh, RankGrid):
        mesh = mesh.device_mesh
    return place(state, new_plan.param_specs(state, axes), mesh)
