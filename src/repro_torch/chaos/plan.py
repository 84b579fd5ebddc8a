"""Declarative, seeded fault schedules; counterpart of `repro.chaos.plan`.

A `FaultPlan` is a tuple of `FaultEvent`s, each pinned to a chunk
boundary of a fleet run (the only points where the chaos layer acts:
state inside a chunk's launches is not recoverable). The plan is data and
every stochastic choice it implies (which metric entries a corruption
poisons, how a generated plan is drawn) derives from `seed` alone, so a
faulted run is a pure function of (FaultPlan, uniform source): two
executions of one plan give the same metrics, retry counts and event
logs, bit for bit.

Event kinds (`FaultEvent.kind`):

* ``device_loss``: `count` devices fail at the boundary before chunk k
  (or the explicit `device_ids`, fleet mesh point ids): the fleet mesh
  shrinks over the survivors. A run without a mesh has nothing to
  shrink: the event is recorded as ignored, and an
  `ElasticGovernor(base_devices=...)` still re-prices the chunks.
* ``chunk_fail``: the next `count` execution attempts of chunk k raise
  (an injected launch failure); the runner retries with exponential
  backoff, re-running the same launches on the same inputs.
* ``corrupt``: chunk k's metrics payload is poisoned with NaNs on its
  first attempt; the runner's integrity check detects it and the chunk
  runs again.
* ``slot_change``: the slot pool shrinks or grows by the signed `count`
  for every window from k on (finite-capacity path only).
* ``crash``: the process dies right after chunk k commits its
  checkpoint; `resume_fleet` finishes the run bit for bit.

Plans, fingerprints and generated plans equal the reference's for the
same arguments.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np

KINDS = ("device_loss", "chunk_fail", "corrupt", "slot_change", "crash")


class FaultEvent(NamedTuple):
    kind: str                 # one of KINDS
    chunk: int                # chunk boundary the event fires at
    count: int = 1            # kind-specific magnitude (see module doc)
    device_ids: Tuple[int, ...] = ()   # explicit failed ids (device_loss)


@dataclass(frozen=True)
class FaultPlan:
    """An immutable, validated schedule of fault events."""
    events: Tuple[FaultEvent, ...] = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(
            e if isinstance(e, FaultEvent) else FaultEvent(*e)
            for e in self.events))
        self.validate()

    def validate(self) -> None:
        crashes = set()
        for e in self.events:
            if e.kind not in KINDS:
                raise ValueError(f"unknown fault kind {e.kind!r}; expected "
                                 f"one of {KINDS}")
            if e.chunk < 0:
                raise ValueError(f"fault chunk must be >= 0, got {e.chunk}")
            if e.kind == "chunk_fail" and e.count < 1:
                raise ValueError("chunk_fail count must be >= 1")
            if e.kind == "device_loss" and e.count < 1 and not e.device_ids:
                raise ValueError("device_loss needs count >= 1 or explicit "
                                 "device_ids")
            if e.kind == "crash":
                if e.chunk in crashes:
                    raise ValueError(f"duplicate crash at chunk {e.chunk}")
                crashes.add(e.chunk)

    def at(self, chunk: int, kind: Optional[str] = None):
        """Events firing at `chunk` (optionally of one kind), plan order."""
        return tuple(e for e in self.events
                     if e.chunk == chunk and (kind is None or e.kind == kind))

    def kinds(self) -> Tuple[str, ...]:
        return tuple(sorted({e.kind for e in self.events}))

    @property
    def n_events(self) -> int:
        return len(self.events)

    def fingerprint(self) -> str:
        """Stable text form, stored in checkpoints so a resume can refuse
        to continue under a different fault schedule."""
        ev = ";".join(f"{e.kind}@{e.chunk}x{e.count}"
                      + (f"[{','.join(map(str, e.device_ids))}]"
                         if e.device_ids else "")
                      for e in self.events)
        return f"seed={self.seed}:{ev}"


EMPTY_PLAN = FaultPlan()


def from_faults(faults, seed: int = 0) -> FaultPlan:
    """A FaultPlan from declarative event dicts or tuples, such as a
    workload scenario's `faults` (`workloads.registry`):
    `({"kind": "device_loss", "chunk": 2, "count": 2}, ...)`."""
    events = []
    for f in faults:
        if isinstance(f, FaultEvent):
            events.append(f)
        elif isinstance(f, dict):
            events.append(FaultEvent(
                kind=f["kind"], chunk=int(f["chunk"]),
                count=int(f.get("count", 1)),
                device_ids=tuple(f.get("device_ids", ()))))
        else:
            events.append(FaultEvent(*f))
    return FaultPlan(events=tuple(events), seed=seed)


def generate(seed: int, n_chunks: int, p_device_loss: float = 0.0,
             p_chunk_fail: float = 0.0, p_corrupt: float = 0.0,
             max_lost: int = 1) -> FaultPlan:
    """A random but reproducible plan: at each chunk boundary each fault
    kind fires independently with its probability. Deterministic in
    `seed` (a numpy PCG64 stream; nothing global)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    events = []
    for ci in range(n_chunks):
        if p_device_loss > 0 and rng.random() < p_device_loss:
            events.append(FaultEvent("device_loss", ci,
                                     int(rng.integers(1, max_lost + 1))))
        if p_chunk_fail > 0 and rng.random() < p_chunk_fail:
            events.append(FaultEvent("chunk_fail", ci, 1))
        if p_corrupt > 0 and rng.random() < p_corrupt:
            events.append(FaultEvent("corrupt", ci, 1))
    return FaultPlan(events=tuple(events), seed=seed)
