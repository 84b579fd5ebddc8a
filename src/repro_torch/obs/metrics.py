"""Capacity-replay metrics; counterpart of `repro.obs.metrics`
(`CapacityMetrics`, `capacity_metrics`, `reduce_reps`).

`capacity_metrics` computes one replication's observables from the arrays
the replay already produced (table, release, start, realized), on their
device and with no host read:

* `depth_hist`: histogram of each active unit's queue depth at its own
  release (units released but not yet started, by order-statistic
  counting over sorted releases and starts), in log2 bins (0, 1, 2-3,
  4-7, ...), the last bin clipping, so its mass equals `n_dispatched`;
* `occupancy`: billed slot-seconds; `wait_total`: summed waits;
* `spec_launched` / `spec_killed`: active non-primary units / attempts
  killed before finishing;
* `busy_windows`: waiting units per window, over `N_WINDOWS` equal
  slices of the replay span (sustained growth is the instability signal);
* `depth_max`.

Integer histograms are `index_add_` on int32, exact in any order.
`reduce_reps` sums every field over replications (`depth_max` takes the
max); `reps` counts them. The fleet layer's reductions, `reduce_reps_host`
(a window's replications) and `combine_windows` (a run's windows), run
on the host in numpy in one fixed order and return numpy fields.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import to_host

__all__ = ["CapacityMetrics", "DEPTH_BINS", "N_WINDOWS", "capacity_metrics",
           "combine_windows", "reduce_reps", "reduce_reps_host"]

DEPTH_BINS = 16      # queue-depth histogram bins (the last clips)
N_WINDOWS = 32       # busy-period windows over the replay span


#: how each field reduces over replications and windows
_REDUCE = {"depth_hist": "sum", "depth_max": "max", "occupancy": "sum",
           "spec_launched": "sum", "spec_killed": "sum",
           "busy_windows": "sum", "wait_total": "sum",
           "n_dispatched": "sum", "reps": "sum"}


class CapacityMetrics(NamedTuple):
    depth_hist: torch.Tensor     # (DEPTH_BINS,) int32
    depth_max: torch.Tensor      # int32
    occupancy: torch.Tensor      # f32, billed slot-seconds
    spec_launched: torch.Tensor  # int32
    spec_killed: torch.Tensor    # int32
    busy_windows: torch.Tensor   # (N_WINDOWS,) int32
    wait_total: torch.Tensor     # f32
    n_dispatched: torch.Tensor   # int32, active attempt units
    reps: torch.Tensor           # int32, replications reduced in


def capacity_metrics(table, release, start, realized,
                     depth_bins: int = DEPTH_BINS,
                     n_windows: int = N_WINDOWS) -> CapacityMetrics:
    """One replication's metrics; `table` is the (narrowed) AttemptTable,
    `release` / `start` the (U,) schedule of the final pass, `realized`
    its `cluster.events.Realized`."""
    active = table.active
    act_i = active.to(torch.int32)
    i32 = dict(dtype=torch.int32, device=release.device)

    # depth at each unit's release: (# releases <= t) - (# starts <= t)
    # over active units
    rel_a = torch.where(active, release, torch.inf)
    st_a = torch.where(active, start, torch.inf)
    released = torch.searchsorted(torch.sort(rel_a).values, release,
                                  right=True)
    started = torch.searchsorted(torch.sort(st_a).values, release,
                                 right=True)
    depth = torch.clamp(released - started, min=0).to(torch.int32)
    dbin = torch.where(
        depth > 0,
        torch.floor(torch.log2(torch.clamp(depth, min=1).to(torch.float32)))
        .to(torch.int32) + 1, 0)
    dbin = torch.clamp(dbin, 0, depth_bins - 1)
    hist = torch.zeros(depth_bins, **i32).index_add_(0, dbin, act_i)
    depth_max = torch.where(active, depth, 0).amax().to(torch.int32)

    # busy-period indicator: waiting units bucketed over the span
    t0 = rel_a.amin()
    t0 = torch.where(torch.isfinite(t0), t0, 0.0)
    frac = (release - t0) / realized.span
    widx = torch.clamp((frac * n_windows).to(torch.int32), 0, n_windows - 1)
    waiting = (active & (realized.wait > 0.0)).to(torch.int32)
    busy = torch.zeros(n_windows, **i32).index_add_(0, widx, waiting)

    return CapacityMetrics(
        depth_hist=hist, depth_max=depth_max,
        occupancy=realized.busy_time.to(torch.float32),
        spec_launched=(act_i * (~table.is_primary).to(torch.int32)).sum(
            dtype=torch.int32),
        spec_killed=realized.preempted.to(torch.int32),
        busy_windows=busy,
        wait_total=realized.wait.sum().to(torch.float32),
        n_dispatched=act_i.sum(dtype=torch.int32),
        reps=torch.ones((), **i32))


def reduce_reps(per_rep) -> CapacityMetrics:
    """Reduce a list of per-replication CapacityMetrics, in rep order:
    sums, but the max for `depth_max`."""
    out = {}
    for f in CapacityMetrics._fields:
        stacked = torch.stack([getattr(m, f) for m in per_rep])
        out[f] = (stacked.amax(dim=0) if f == "depth_max"
                  else stacked.sum(dim=0, dtype=stacked.dtype))
    return CapacityMetrics(**out)


def _reduce_host(stacked: CapacityMetrics) -> CapacityMetrics:
    return CapacityMetrics(**{
        f: (np.sum(getattr(stacked, f), axis=0) if op == "sum"
            else np.max(getattr(stacked, f), axis=0))
        for f, op in _REDUCE.items()})


def reduce_reps_host(stacked, reps: int) -> CapacityMetrics:
    """Reduce a CapacityMetrics whose fields carry a leading replication
    axis (tensors or arrays) on the host: drop padded replications, then
    reduce the real ones in replication order with numpy."""
    return _reduce_host(CapacityMetrics(*(to_host(x)[:reps] for x in stacked)))


def combine_windows(parts) -> CapacityMetrics:
    """Combine per-window metrics in window order (host numpy): counters,
    histograms and integrals sum, `depth_max` takes the max, and `reps`
    stays the per-window replication count (every window replays the same
    replications, so it takes the max)."""
    parts = list(parts)
    if not parts:
        raise ValueError("combine_windows of no parts")
    stacked = CapacityMetrics(
        *(np.stack([to_host(getattr(m, f)) for m in parts])
          for f in CapacityMetrics._fields))
    out = _reduce_host(stacked)
    return out._replace(reps=np.max(stacked.reps, axis=0))
