"""ElasticGovernor: capacity loss -> a new price C -> a fresh r*;
counterpart of `repro.chaos.governor`.

Chronos solves r* against a fixed price C a unit of machine time. When
devices die mid-run the surviving capacity is scarcer, so a speculative
copy costs more; keeping the old speculation level on the smaller system
can push a capacity-bound queue past its stability boundary (Anselmi and
Walton, arXiv 2104.10426). The governor maps every capacity change to a
cost multiplier

    scale = (base_devices / alive_devices) ** alpha

and the fleet runner multiplies `JobSpec.C` by the chunk's scale (as an
f32, before any other transform of the specs) ahead of each chunk's
Algorithm-1 solve: chunks already run keep the r* they ran with.

The schedule is a pure function of (FaultPlan, base capacity),
precomputed for every chunk boundary when the context binds, so a
resumed run rebuilds the same trajectory without replaying events.

`ElasticGovernor` may compose an `obs.tail.TailGovernor`: on a capacity
event (`ChaosContext.begin_chunk` shrinking a fleet mesh) it re-prices
the tail governor and re-solves, so `decision` carries the (strategy, r*)
switch. A run without a mesh records `device_loss` as ignored and fires
no event; the schedule still re-prices its chunks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..obs import trace as obs_trace


@dataclass
class ElasticGovernor:
    """Re-solve policy under capacity loss (see the module doc).

    alpha:        cost elasticity: scale = (base/alive)^alpha.
    tail:         an optional `obs.tail.TailGovernor` to re-price and
                  re-solve on every capacity event.
    min_alive:    the fewest devices a loss can leave.
    base_devices: the logical base capacity; None prices against the
                  run's own mesh. Setting it lets a small host price
                  losses against the cluster the plan models.
    """
    alpha: float = 1.0
    tail: Optional[object] = None
    min_alive: int = 1
    base_devices: Optional[int] = None
    history: list = field(default_factory=list)   # (chunk, alive, scale)

    def __post_init__(self):
        if self.tail is not None:
            self._base_price = float(self.tail.price)
        self.decision = None

    def schedule(self, plan, n_chunks: int, base_devices: int) -> np.ndarray:
        """(n_chunks,) cost scale at each chunk boundary, pure in (plan,
        base_devices). device_loss events compound; a loss at chunk k
        re-prices chunk k's own solve."""
        alive = max(int(base_devices), 1)
        scales = np.ones((max(n_chunks, 1),), np.float64)
        for ci in range(n_chunks):
            for e in plan.at(ci, "device_loss"):
                lost = len(e.device_ids) if e.device_ids else e.count
                alive = max(alive - lost, self.min_alive)
            scales[ci] = (base_devices / alive) ** self.alpha
        return scales

    def on_capacity(self, chunk: int, alive: int, base_devices: int,
                    scale: float) -> None:
        """Record a capacity event; re-solve the composed tail governor at
        the new price when its window has samples to fit."""
        self.history.append((int(chunk), int(alive), float(scale)))
        if self.tail is None:
            return
        self.tail.price = self._base_price * float(scale)
        win = self.tail.registry.window(self.tail.window_name)
        if len(win) >= max(self.tail.min_samples, 2):
            with obs_trace.span("chaos.resolve", chunk=chunk, alive=alive,
                                cost_scale=float(scale)) as sp:
                self.decision = self.tail.resolve()
                if self.decision is not None:
                    sp.set(strategy=self.decision.strategy,
                           r_opt=int(self.decision.r_opt))
