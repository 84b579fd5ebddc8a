"""Device meshes; counterpart of `repro.launch.mesh`. Importing this
module touches no device and starts no process group.

The reference's production meshes are (16, 16) ("data", "model") per pod
and (2, 16, 16) ("pod", "data", "model") across two pods, over TPU chips.
Here each mesh point is one rank of a `torch.distributed` process group
(one card a rank): these functions take the group the caller started
and raise when its world size is not the mesh's. `card_mesh` is the one
mesh that one H100 holds in full: (1, 1) over a one-rank group that it
starts itself, in process, with no TCP port and no environment.
"""
from __future__ import annotations

import math

import torch

from ..device import resolve_device

PRODUCTION_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)
AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")


def _mesh(shape: tuple, names: tuple, device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != need:
        raise RuntimeError(
            f"a {shape} mesh needs a process group of {need} ranks (one "
            f"card a rank); " + ("no process group is started" if have is None
                                 else f"this one has {have}"))
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=names)


def make_production_mesh(multi_pod: bool = False, device=None):
    """(16, 16) = 256 ranks per pod; (2, 16, 16) = 512 across two."""
    if multi_pod:
        return _mesh(MULTI_POD_SHAPE, MULTI_POD_AXES, device)
    return _mesh(PRODUCTION_SHAPE, AXES, device)


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0,
                    device=None):
    """A small mesh over the started process group (tests: gloo with
    `device="cpu"`)."""
    if pod:
        return _mesh((pod, data, model), MULTI_POD_AXES, device)
    return _mesh((data, model), AXES, device)


def card_mesh(device=None):
    """The (1, 1) ("data", "model") mesh on one card. Starts a one-rank
    process group over an in-process `HashStore` when none is started:
    NCCL on `cuda` (the default), gloo only for `device="cpu"`. The
    caller destroys the group (`torch.distributed.destroy_process_group`)
    when done."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    elif dist.get_world_size() != 1:
        raise RuntimeError(f"card_mesh: the started process group has "
                           f"{dist.get_world_size()} ranks, not 1")
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=AXES)
