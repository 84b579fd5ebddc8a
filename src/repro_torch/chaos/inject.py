"""ChaosContext: the runtime that applies a FaultPlan at chunk boundaries;
counterpart of `repro.chaos.inject`.

The fleet chunk loops (`fleet/runner.py`, `fleet/cluster.py`) consult one
`ChaosContext` a run at three points, all on the host:

    begin_chunk(ci, mesh)  -> the mesh to run chunk ci on (device_loss
                              shrinks it)
    execute(ci, thunk)     -> retry and backoff around the chunk's launches
                              (chunk_fail injection, corruption detection)
    maybe_crash(ci)        -> raises SimulatedCrash after chunk ci's
                              checkpoint committed (crash events)

Everything is deterministic given (FaultPlan, uniform source): injected
failures count down a per-chunk budget, a corruption poisons NaN
positions drawn from a PCG64 stream seeded by (plan.seed, chunk,
attempt), and a retry re-runs the same launches on the same inputs, whose
draws are keyed by their global coordinates; so the recovered result
equals an unfaulted run's bit for bit. With `chaos=None` the runners
never build this object and run the chaos-free path unchanged.

On the card the integrity check reads one flag a chunk from the device
(a NaN anywhere in the payload's float tensors), and a corruption poisons
a clone: the tensors the runner reduces, or a retry reads, stay clean.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..ckpt.checkpoint import tree_leaves, tree_rebuild
from ..obs import trace as obs_trace
from .plan import FaultPlan


class SimulatedCrash(RuntimeError):
    """Raised after chunk `chunk`'s checkpoint commits: the test double
    for a killed process. Catch it, then `resume_fleet()`."""

    def __init__(self, chunk: int):
        self.chunk = int(chunk)
        super().__init__(f"simulated crash after chunk {chunk}")


class InjectedChunkFailure(RuntimeError):
    """An injected launch failure of one chunk execution attempt."""


class ChunkCorruptionDetected(RuntimeError):
    """The integrity check found NaN in a chunk's metrics payload: the
    chunk must run again."""


class ChaosExhausted(RuntimeError):
    """A chunk kept failing past max_attempts: the fault is treated as
    permanent and surfaced instead of retried forever."""


def _is_float(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return np.asarray(x).dtype.kind == "f"


def _poison(tree, rng: np.random.Generator):
    """NaN-poison a deterministic subset (an eighth) of every float leaf
    of a copy: tensors are cloned on their device, arrays copied."""
    def one(x):
        if isinstance(x, torch.Tensor):
            if not x.is_floating_point() or x.numel() == 0:
                return x
            out = x.clone()
            n = max(1, x.numel() // 8)
            idx = rng.choice(x.numel(), size=min(n, x.numel()),
                             replace=False)
            out.view(-1)[torch.from_numpy(idx).to(x.device)] = torch.nan
            return out
        a = np.array(x)
        if a.dtype.kind != "f" or a.size == 0:
            return a
        flat = a.reshape(-1)
        n = max(1, flat.size // 8)
        idx = rng.choice(flat.size, size=min(n, flat.size), replace=False)
        flat[idx] = np.nan
        return a
    return tree_rebuild(tree, iter([one(x) for x in tree_leaves(tree)]))


def _has_nan(tree) -> bool:
    """Whether any float leaf holds a NaN: one host read for all the
    tensors. NaN only: the raw chunk payloads carry -inf in padded cells
    legitimately, while the simulator's metrics never hold a NaN."""
    leaves = [x for x in tree_leaves(tree) if _is_float(x)]
    flags = [torch.isnan(x).any() for x in leaves
             if isinstance(x, torch.Tensor)]
    if any(np.isnan(np.asarray(x)).any() for x in leaves
           if not isinstance(x, torch.Tensor)):
        return True
    return bool(torch.stack(flags).any()) if flags else False


def _failed_ids(event, mesh) -> tuple:
    """The point ids a device_loss event fails: its explicit ids, or else
    the trailing `count` points of the current grid."""
    if event.device_ids:
        return tuple(event.device_ids)
    return tuple(mesh.ids[-event.count:])


class ChaosContext:
    """One run's fault-injection state machine (see the module doc).

    backoff_base: first retry delay in seconds, doubling an attempt (0 =
        no sleeping, as the tests use; the delays are recorded either
        way, so the schedule is observable).
    max_attempts: attempts a chunk before ChaosExhausted.
    governor: an optional `chaos.governor.ElasticGovernor`: its cost-scale
        schedule re-prices every chunk's Algorithm-1 solve.
    """

    def __init__(self, plan: FaultPlan, governor=None,
                 max_attempts: int = 4, backoff_base: float = 0.05,
                 sleep=time.sleep):
        plan.validate()
        self.plan = plan
        self.governor = governor
        self.max_attempts = int(max_attempts)
        self.backoff_base = float(backoff_base)
        self._sleep = sleep
        self.records: list = []        # (chunk, kind, detail) audit log
        self._fail_left: dict = {}     # chunk -> injected failures left
        self._corrupt_left: dict = {}  # chunk -> poisonings left
        for e in plan.events:
            if e.kind == "chunk_fail":
                self._fail_left[e.chunk] = \
                    self._fail_left.get(e.chunk, 0) + e.count
            elif e.kind == "corrupt":
                self._corrupt_left[e.chunk] = \
                    self._corrupt_left.get(e.chunk, 0) + e.count
        self._bound = False

    def bind(self, n_chunks: int, mesh, reps: int,
             slots: Optional[int] = None) -> None:
        """Precompute the per-chunk schedules (cost scale, slots), pure in
        the plan, so every phase of a run and any resume see the same
        trajectories without replaying events. The runner calls this once
        before its chunk loop."""
        self.n_chunks = int(n_chunks)
        self.base_devices = mesh.size if mesh is not None else 1
        if self.governor is not None and self.governor.base_devices:
            # price losses against the cluster size the plan models, not
            # the card the run is on
            self.base_devices = int(self.governor.base_devices)
        if self.governor is not None:
            self.cost_scales = self.governor.schedule(
                self.plan, n_chunks, self.base_devices)
        else:
            self.cost_scales = np.ones((max(n_chunks, 1),), np.float64)
        # the slot pool's trajectory: signed deltas compound from their
        # chunk on
        sl = np.full((max(n_chunks, 1),), -1, np.int64)
        if slots is not None:
            cur = int(slots)
            for ci in range(n_chunks):
                for e in self.plan.at(ci, "slot_change"):
                    cur = max(1, cur + int(e.count))
                sl[ci] = cur
        self.slots_schedule = sl
        self._bound = True

    def cost_scale(self, ci: int) -> float:
        return float(self.cost_scales[ci]) if self._bound else 1.0

    def slots_at(self, ci: int, default: Optional[int]) -> Optional[int]:
        if not self._bound or self.slots_schedule[ci] < 0:
            return default
        return int(self.slots_schedule[ci])

    def begin_chunk(self, ci: int, mesh, reps: int):
        """Apply this boundary's device-loss events; returns the mesh to
        run chunk ci on: the mesh shrunk over the surviving points
        (`fleet.mesh.shrink_fleet_mesh`; None when one survives), or the
        mesh itself when the boundary has none."""
        events = self.plan.at(ci, "device_loss")
        if not events:
            return mesh
        from ..fleet.mesh import shrink_fleet_mesh
        for e in events:
            if mesh is None or mesh.size <= 1:
                # nothing to shrink on a single-device run: the event is
                # recorded (the plan stays portable across hosts) and the
                # governor's schedule still re-prices the chunks
                self._record(ci, "device_loss",
                             "ignored: single-device run")
                continue
            failed = _failed_ids(e, mesh)
            mesh = shrink_fleet_mesh(mesh, failed, reps=reps)
            alive = mesh.size if mesh is not None else 1
            self._record(ci, "device_loss",
                         f"failed={list(failed)} alive={alive}")
            with obs_trace.span("chaos.device_loss", chunk=ci,
                                failed=list(failed), alive=alive,
                                cost_scale=self.cost_scale(ci)):
                if self.governor is not None:
                    self.governor.on_capacity(ci, alive, self.base_devices,
                                              self.cost_scale(ci))
        return mesh

    def execute(self, ci: int, thunk):
        """Run one chunk's launches under injection and retry.

        thunk() must be idempotent and deterministic (the fleet's are:
        their draws are keyed by (source, global coordinates)), so a retry
        after an injected failure or a detected corruption reproduces the
        clean result bit for bit. An injected failure raises before the
        thunk runs, so it launches nothing.
        """
        attempt = 0
        while True:
            try:
                if self._fail_left.get(ci, 0) > 0:
                    self._fail_left[ci] -= 1
                    raise InjectedChunkFailure(
                        f"injected failure of chunk {ci}")
                out = thunk()
                checked = out
                if self._corrupt_left.get(ci, 0) > 0:
                    self._corrupt_left[ci] -= 1
                    rng = np.random.Generator(np.random.PCG64(
                        (self.plan.seed, ci, attempt)))
                    checked = _poison(out, rng)
                    self._record(ci, "corrupt", f"attempt={attempt}")
                # the simulator's metric payloads hold no NaN, so a NaN
                # means the payload was corrupted in flight: run again
                if _has_nan(checked):
                    raise ChunkCorruptionDetected(
                        f"NaN metrics payload in chunk {ci}")
                return out
            except (InjectedChunkFailure, ChunkCorruptionDetected) as err:
                attempt += 1
                if attempt >= self.max_attempts:
                    raise ChaosExhausted(
                        f"chunk {ci} failed {attempt} attempts; last: "
                        f"{err}") from err
                backoff = self.backoff_base * (2.0 ** (attempt - 1))
                self._record(ci, "retry",
                             f"attempt={attempt} backoff={backoff:.3f}s "
                             f"cause={type(err).__name__}")
                with obs_trace.span("chaos.retry", chunk=ci,
                                    attempt=attempt, backoff_s=backoff,
                                    cause=type(err).__name__):
                    if backoff > 0:
                        self._sleep(backoff)

    def maybe_crash(self, ci: int) -> None:
        """Raise SimulatedCrash if the plan kills the process after chunk
        ci (the runner calls this after the chunk's checkpoint commits)."""
        if self.plan.at(ci, "crash"):
            self._record(ci, "crash", "simulated process death")
            raise SimulatedCrash(ci)

    def mesh_through(self, start_chunk: int, mesh, reps: int):
        """The mesh a resumed run continues on: the device-loss shrinks of
        chunks [0, start_chunk) replayed silently, with no audit record
        and no governor hook (the mesh is never checkpointed: it is pure
        in the plan)."""
        from ..fleet.mesh import shrink_fleet_mesh
        for ci in range(start_chunk):
            for e in self.plan.at(ci, "device_loss"):
                if mesh is None or mesh.size <= 1:
                    continue
                mesh = shrink_fleet_mesh(mesh, _failed_ids(e, mesh),
                                         reps=reps)
        return mesh

    def catch_up(self, start_chunk: int) -> None:
        """Fast-forward the injection state over the chunks a resume skips
        (the schedules are pure: only the countdown budgets and the audit
        log advance)."""
        for ci in range(start_chunk):
            self._fail_left.pop(ci, None)
            self._corrupt_left.pop(ci, None)
        self._record(start_chunk, "resume",
                     f"resumed at chunk {start_chunk}")

    def _record(self, chunk: int, kind: str, detail: str) -> None:
        self.records.append((int(chunk), kind, detail))

    def report(self) -> str:
        """The audit log of everything the context did, as text."""
        if not self.records:
            return "chaos: no events fired"
        lines = [f"chaos: {len(self.records)} event(s) "
                 f"[plan: {self.plan.fingerprint()}]"]
        lines += [f"  chunk {c:>3d}  {k:<12s} {d}"
                  for c, k, d in self.records]
        return "\n".join(lines)


def as_context(chaos) -> Optional[ChaosContext]:
    """Normalize the runners' `chaos=` argument: None, a FaultPlan (with
    default context settings) or a ChaosContext."""
    if chaos is None:
        return None
    if isinstance(chaos, ChaosContext):
        return chaos
    if isinstance(chaos, FaultPlan):
        return ChaosContext(chaos)
    raise TypeError(f"chaos must be a FaultPlan or ChaosContext, "
                    f"got {type(chaos).__name__}")
