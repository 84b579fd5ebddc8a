"""Chunked fleet execution of the Chronos evaluation stack; counterpart
of `repro.fleet`.

* `mesh`: the ("rep", "job") grid of device points (`fleet_mesh`,
  `shrink_fleet_mesh`, `job_split`) and the pad+mask arithmetic.
* `blocks`: a JobSet as fixed-shape job blocks, the unit that keys the
  draws, and the flat view the runner simulates.
* `runner`: `run_fleet_strategy` / `run_all_fleet`, the flat simulation
  streamed in chunks through `sim.metrics.StreamCombiner`.
* `cluster`: `run_cluster_fleet_strategy` / `run_cluster_fleet`, the
  capacity replay window by window, every (window, replication) a segment
  of the batched dispatch launch.

Every task row draws through `source.uniform_rows` at its global
(block, task row) coordinates, one call per (replication, chunk, draw
name), and every cross-job reduction runs on the host in one fixed
order, so a chunked run gives the bits of a monolithic one, and a run on
a mesh (each point's share launched on its own device, the raw results
gathered to the host) the bits of a run without one.
`run_all(devices=, mesh=, chunk_jobs=)` and `run_cluster(devices=,
mesh=, chunk_jobs=)` route here; without them the flat paths are
untouched.
"""
from .blocks import FleetBlocks, block_jobset, gather_index, make_blocks
from .cluster import run_cluster_fleet, run_cluster_fleet_strategy
from .mesh import (AXES, FleetMesh, fleet_mesh, job_split, mesh_extents,
                   pad_count, shrink_fleet_mesh)
from .runner import job_columns, run_all_fleet, run_fleet_strategy

__all__ = [
    "AXES",
    "FleetBlocks",
    "FleetMesh",
    "block_jobset",
    "fleet_mesh",
    "gather_index",
    "job_columns",
    "job_split",
    "make_blocks",
    "mesh_extents",
    "pad_count",
    "run_all_fleet",
    "run_cluster_fleet",
    "run_cluster_fleet_strategy",
    "run_fleet_strategy",
    "shrink_fleet_mesh",
]
