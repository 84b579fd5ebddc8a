"""Finite slot pool and dispatch disciplines; counterpart of
`repro.cluster.slots`.

The pool is the only mutable state of the dispatch recursion: `free[i]`
is the time at which slot i next becomes idle. The reference keeps it as
a two-level (G, g) grid with a cached minimum per group so that its scan
finds the earliest-idle slot in O(G + g); `make_pool` builds that grid,
and the port's kernel (`kernels/csrc/dispatch_scan.cu`) uses the same
layout inside.

Disciplines decide the order in which queued attempt-units are offered a
slot:

  * FIFO: release-time order; with identical slots the exact G/G/K
    recursion start_i = max(release_i, earliest idle slot);
  * EDF: strict non-preemptive earliest-deadline-first, units sorted by
    absolute job deadline, ties by release; a unit with an early deadline
    but a late release blocks later-deadline units (strict priority, not
    work-conserving).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device

DISCIPLINES = ("fifo", "edf")


class SlotPool(NamedTuple):
    """Two-level grid of slot next-idle times and cached group minima."""
    free: torch.Tensor   # (G, g) next-idle time per slot
    gmin: torch.Tensor   # (G,) minimum over each group row


def make_pool(slots: int, t0: float = 0.0, *, device=None) -> SlotPool:
    """A pool of `slots` slots idle at t0 on `device` (default the card),
    padded to a (G, g) grid, G = floor(sqrt(slots)); padding slots are
    +inf, so the earliest-idle choice never takes them."""
    if slots <= 0:
        raise ValueError(f"slots must be positive, got {slots}")
    G = max(int(np.sqrt(slots)), 1)
    g = -(-slots // G)
    free = np.full((G * g,), np.inf, np.float32)
    free[:slots] = t0
    free = free.reshape(G, g)
    dev = resolve_device(device)
    return SlotPool(free=torch.from_numpy(free).to(dev),
                    gmin=torch.from_numpy(free.min(axis=1)).to(dev))


def _check(discipline: str) -> None:
    if discipline not in DISCIPLINES:
        raise ValueError(f"unknown discipline {discipline!r}; "
                         f"expected one of {DISCIPLINES}")


def dispatch_key_order(discipline: str, release, deadline_abs,
                       inactive=None) -> torch.Tensor:
    """Permutation into dispatch order along the last dimension (each row
    of a (P, n) batch on its own): FIFO is one stable sort of the release;
    EDF a stable sort by release, then a stable sort by deadline over that
    permutation (numpy's lexsort((release, deadline))). Ties break by unit
    index. With `inactive` (bool), the first key of inactive units is +inf,
    so active units pack into a dispatch-ordered prefix."""
    _check(discipline)
    key = release if discipline == "fifo" else deadline_abs
    if inactive is not None:
        key = torch.where(inactive, torch.inf, key)
    if discipline == "fifo":
        return torch.sort(key, stable=True).indices
    by_release = torch.sort(release, stable=True).indices
    return by_release.gather(-1, torch.sort(key.gather(-1, by_release),
                                            stable=True).indices)


def utilization(busy_time, slots: int, span):
    """Occupied slot-time over slots x makespan. Unclamped on purpose:
    billed occupancy never exceeding slots x span is an invariant the
    checks assert, and a clamp would hide double billing."""
    return busy_time / torch.clamp(slots * span, min=1e-9)
