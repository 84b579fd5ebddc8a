"""The fleet's ("rep", "job") mesh and its pad+mask arithmetic;
counterpart of `repro.fleet.mesh`.

The reference runs every strategy over a 2-D device mesh: replications
over "rep", job blocks over "job". The port runs on one card, so its mesh
is the 1 x 1 record `FleetMesh` and every larger extent raises; sharding
over several cards is a later item (ROADMAP A). `pad_count` keeps the
reference's pad+mask rounding, which `pad_to=` (a test-only override)
still exercises: padded replications and blocks are computed and dropped,
so results do not depend on them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

AXES = ("rep", "job")


class FleetMesh(NamedTuple):
    """A ("rep", "job") mesh: its two extents and the devices it spans."""
    rep_extent: int
    job_extent: int
    devices: Tuple[str, ...]

    @property
    def size(self) -> int:
        return self.rep_extent * self.job_extent


def _one_card(shape) -> None:
    raise ValueError(
        f"fleet mesh {shape} spans {shape[0] * shape[1]} devices; the port "
        f"runs on one card (a 1 x 1 mesh): sharding the fleet over several "
        f"cards is ROADMAP A, item 11")


def fleet_mesh(devices: Optional[int] = None,
               shape: Optional[Tuple[int, int]] = None,
               reps: int = 1, *, device=None) -> FleetMesh:
    """The 1 x 1 mesh on `device` (default the card). `devices` None or 1
    and `shape` None or (1, 1) are accepted; any larger mesh raises
    ValueError, as does a non-positive extent."""
    from ..device import resolve_device
    if shape is None:
        n = 1 if devices is None else int(devices)
        if n < 1:
            raise ValueError(f"devices must be >= 1, got {n}")
        shape = (1, n)
    r_ext, j_ext = int(shape[0]), int(shape[1])
    if r_ext < 1 or j_ext < 1:
        raise ValueError(f"mesh shape must be positive, got {shape}")
    if r_ext * j_ext > 1:
        _one_card((r_ext, j_ext))
    return FleetMesh(1, 1, (str(resolve_device(device)),))


def mesh_extents(mesh: Optional[FleetMesh]) -> Tuple[int, int]:
    """(rep_extent, job_extent) of a fleet mesh; (1, 1) when mesh is None."""
    if mesh is None:
        return (1, 1)
    return (mesh.rep_extent, mesh.job_extent)


def check_mesh(mesh: Optional[FleetMesh]) -> None:
    """Raise unless `mesh` is None or a 1 x 1 FleetMesh."""
    if mesh is None:
        return
    if not isinstance(mesh, FleetMesh):
        raise TypeError(f"mesh must be a FleetMesh from fleet_mesh, got "
                        f"{type(mesh).__name__}")
    if mesh.size > 1:
        _one_card(mesh_extents(mesh))


def shrink_fleet_mesh(mesh: FleetMesh, failed,
                      reps: int = 1) -> FleetMesh:
    """The mesh over the devices that survive `failed` (indices into
    `mesh.devices`) on the port's 1 x 1 mesh: `mesh` itself when its
    device did not fail, RuntimeError when it did (nothing survives: an
    outage, not an elastic event). Larger meshes wait for the fleet over
    several cards (ROADMAP A item 11); `check_mesh` refuses them."""
    check_mesh(mesh)
    if any(int(d) in range(len(mesh.devices)) for d in failed):
        raise RuntimeError("no devices survive the loss: cannot reshard")
    return mesh


def pad_count(n: int, extent: int) -> int:
    """Round n up to a multiple of the mesh extent (pad+mask fallback)."""
    if extent < 1:
        raise ValueError(f"extent must be >= 1, got {extent}")
    return -(-n // extent) * extent
