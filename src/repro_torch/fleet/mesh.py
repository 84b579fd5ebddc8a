"""The fleet's ("rep", "job") mesh and its pad+mask arithmetic;
counterpart of `repro.fleet.mesh`.

The fleet runs every strategy over a 2-D grid of devices: replications
over "rep", job blocks over "job". The reference builds a `jax` Mesh and
runs under `shard_map`; the port's `FleetMesh` is the same grid as a
record of indexed `torch.device` points, built in one process, and the
runners launch each point's share of a chunk on that point's device, then
gather the raw per-(replication, block) results to the host and reduce
them there in one fixed order. Nothing reduces across points on a device,
so no process group or collective is needed (the reference's fleet is a
single controller too), and a run's metrics do not depend on the mesh.

A point's id is its position in the list the mesh was built from; chaos
`device_loss` events name these ids (`shrink_fleet_mesh`), as the
reference's name `jax.devices()` ids. Neither axis has to divide its
extent: `pad_count` rounds the replication count and the block count up
to the extents, and the padding is computed and dropped.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

AXES = ("rep", "job")


class FleetMesh(NamedTuple):
    """A ("rep", "job") grid of device points, row-major: point (r, j) is
    `devices[r * job_extent + j]`, with id `ids[r * job_extent + j]`."""
    rep_extent: int
    job_extent: int
    devices: Tuple[torch.device, ...]
    ids: Tuple[int, ...]

    @property
    def size(self) -> int:
        return self.rep_extent * self.job_extent

    def point(self, r: int, j: int) -> torch.device:
        return self.devices[r * self.job_extent + j]


def _points(device) -> Tuple[list, Optional[int]]:
    """(the candidate points in order, how many are visible; None: as many
    as asked) of `fleet_mesh`'s `device` argument."""
    from ..device import resolve_device
    if isinstance(device, (list, tuple)):
        pts = [resolve_device(d) for d in device]
        if not pts:
            raise ValueError("device: an empty list of mesh points")
        n_cards = torch.cuda.device_count() if any(
            d.type == "cuda" for d in pts) else 0
        for i, d in enumerate(pts):
            if d.type == "cuda":
                if d.index is None:
                    pts[i] = d = torch.device("cuda",
                                              torch.cuda.current_device())
                if d.index >= n_cards:
                    raise ValueError(f"mesh point {d} is not visible: "
                                     f"{n_cards} card(s)")
        return pts, len(pts)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        n_cards = torch.cuda.device_count()
        return [torch.device("cuda", i) for i in range(n_cards)], n_cards
    if dev.type == "cuda":
        return _points([dev])
    return [dev], None


def fleet_mesh(devices: Optional[int] = None,
               shape: Optional[Tuple[int, int]] = None,
               reps: int = 1, *, device=None) -> FleetMesh:
    """Build the ("rep", "job") fleet mesh.

    devices: use the first N points (None: all of them; one on the CPU).
    shape:   explicit (rep_extent, job_extent), overriding the default
             factorization; rep_extent * job_extent points are used.
    reps:    the replication count the default factorization balances:
             the "rep" extent is gcd(N, reps), the rest goes to "job".
    device:  where the points lie. "cuda" (the default): the cards
             cuda:0, cuda:1, ...; a mesh larger than the visible cards
             raises ("cuda:k" is that one card). "cpu": N logical points
             on the host (the counterpart of XLA's forced host devices).
             A sequence of devices: its entries, in order, as the points;
             entries may repeat (a (2, 2) mesh laid on one card).
    """
    pts, visible = _points(device)
    if shape is None:
        n = (len(pts) if visible is not None else 1) if devices is None \
            else int(devices)
        if n < 1:
            raise ValueError(f"devices must be >= 1, got {n}")
        r_ext = math.gcd(n, max(int(reps), 1))
        shape = (r_ext, n // r_ext)
    r_ext, j_ext = int(shape[0]), int(shape[1])
    if r_ext < 1 or j_ext < 1:
        raise ValueError(f"mesh shape must be positive, got {shape}")
    n = r_ext * j_ext
    if visible is not None and n > visible:
        raise ValueError(
            f"mesh shape {shape} needs {n} devices but only {visible} are "
            f"visible (pass device=[...] to lay several points on one "
            f"card, or device='cpu' for logical host points)")
    chosen = pts[:n] if visible is not None else pts * n
    return FleetMesh(r_ext, j_ext, tuple(chosen), tuple(range(n)))


def mesh_extents(mesh: Optional[FleetMesh]) -> Tuple[int, int]:
    """(rep_extent, job_extent) of a fleet mesh; (1, 1) when mesh is None."""
    if mesh is None:
        return (1, 1)
    return (mesh.rep_extent, mesh.job_extent)


def check_mesh(mesh: Optional[FleetMesh]) -> None:
    """Raise unless `mesh` is None or a FleetMesh."""
    if mesh is not None and not isinstance(mesh, FleetMesh):
        raise TypeError(f"mesh must be a FleetMesh from fleet_mesh, got "
                        f"{type(mesh).__name__}")


def mesh_device(mesh: Optional[FleetMesh],
                dev: torch.device) -> torch.device:
    """The device a run on `mesh` keeps its solve and outputs on: the
    first point (`dev` itself without a mesh). Raises when the mesh lies
    on another kind of device than the run was asked for."""
    check_mesh(mesh)
    if mesh is None:
        return dev
    first = mesh.devices[0]
    if first.type != dev.type:
        raise ValueError(f"the mesh lies on {first.type} but the run was "
                         f"asked for {dev}")
    return first


def shrink_fleet_mesh(mesh: FleetMesh, failed,
                      reps: int = 1) -> Optional[FleetMesh]:
    """Re-factorize a fleet mesh over the points that survive `failed`
    (point ids; they may sit anywhere in the grid). The survivors keep
    their order and go through `fleet_mesh`'s gcd rule again. Returns the
    mesh itself when none of its points failed, None when one point
    survives (the runners' no-mesh path), and raises RuntimeError when
    none survives (an outage, not an elastic event).

    Metrics do not move: every (replication, block) cell draws at its
    global coordinates, so the chunks replayed on the smaller mesh give
    what they would have given on the whole one."""
    check_mesh(mesh)
    failed_ids = {int(d) for d in failed}
    alive = [(d, i) for d, i in zip(mesh.devices, mesh.ids)
             if i not in failed_ids]
    if not alive:
        raise RuntimeError("no devices survive the loss: cannot reshard")
    if len(alive) == mesh.size:
        return mesh
    if len(alive) == 1:
        return None
    r_ext = math.gcd(len(alive), max(int(reps), 1))
    return FleetMesh(r_ext, len(alive) // r_ext,
                     tuple(d for d, _ in alive), tuple(i for _, i in alive))


def pad_count(n: int, extent: int) -> int:
    """Round n up to a multiple of the mesh extent (pad+mask fallback)."""
    if extent < 1:
        raise ValueError(f"extent must be >= 1, got {extent}")
    return -(-n // extent) * extent


def job_split(mesh: Optional[FleetMesh],
              n: int) -> Sequence[Tuple[int, int]]:
    """The contiguous [lo, hi) lane range of each "job" column of an axis
    of n lanes: the split that the reference's P("job") makes. n must be
    a multiple of the "job" extent (pad it with `pad_count`)."""
    j_ext = mesh_extents(mesh)[1]
    if n % j_ext:
        raise ValueError(f"{n} lanes do not split over a job extent of "
                         f"{j_ext}: pad them with pad_count")
    return [split_range(n, j_ext, j) for j in range(j_ext)]


def split_range(n: int, parts: int, k: int) -> Tuple[int, int]:
    """The k-th of `parts` equal contiguous ranges of n (n a multiple)."""
    m = n // parts
    return k * m, (k + 1) * m
