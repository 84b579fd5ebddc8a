"""SpeculativeTaskRunner: Chronos strategies for host-side tasks;
counterpart of `repro.runtime.speculation`, copied (host threads, with the
port's `handoff_offset`).

The independently-restartable units of a training job are host tasks:
input-shard fetch/preprocess, checkpoint writes, eval shards. This runner
executes a batch ("job") of such tasks under a deadline using the strategy +
r* chosen by the governor:

  clone     — launch r+1 attempts per task at t=0; first result wins, the
              rest are cancelled at tau_kill (cooperative cancellation).
  srestart  — launch 1 attempt; at tau_est, tasks whose Eq. 30 estimate
              misses the deadline get r fresh attempts from scratch.
  sresume   — same detection, but the original is cancelled and r+1 attempts
              resume from its recorded progress offset (work-preserving;
              tasks expose resumable state via the `resume_from` argument and
              the Eq. 31 handoff anticipates restart overhead).

Attempts run on a thread pool (host tasks are IO/preprocess-bound); progress
is reported through a shared ProgressBoard the estimator reads.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..core.estimator import handoff_offset


@dataclass
class ProgressBoard:
    """Shared progress state for one attempt. All times are relative to the
    runner's job start (float32-safe for the Eq. 30 estimator)."""
    t_lau: float
    clock: Callable[[], float] = time.monotonic
    t_fp: Optional[float] = None
    fp: float = 0.0
    progress: float = 0.0
    offset: float = 0.0          # work units completed (resume handoff)
    cancelled: bool = False
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def report(self, progress: float, offset: float = 0.0):
        with self._lock:
            now = self.clock()
            if self.t_fp is None and progress > 0:
                self.t_fp = now
                self.fp = progress
            self.progress = progress
            self.offset = max(self.offset, offset)

    def cancel(self):
        self.cancelled = True

    def estimate(self, now: float) -> float:
        """Eq. 30 startup-aware completion estimate (pure-python fast path —
        same formula as core.estimator.estimate_completion_chronos)."""
        with self._lock:
            if self.t_fp is None or self.progress <= self.fp:
                return float("inf")
            dp = max(self.progress - self.fp, 1e-9)
            return self.t_lau + (self.t_fp - self.t_lau) + \
                (now - self.t_fp) / dp


@dataclass
class TaskResult:
    index: int
    value: object
    attempts: int
    wall: float
    machine_time: float
    speculated: bool


class SpeculativeTaskRunner:
    """Run N tasks with speculative redundancy.

    task_fn(index, board, resume_from) -> value. Implementations must poll
    `board.cancelled` and call `board.report(progress, offset)`.
    """

    def __init__(self, max_workers: int = 16):
        self.pool = ThreadPoolExecutor(max_workers=max_workers)

    def run(self, task_fn: Callable, n_tasks: int, *, strategy: str, r: int,
            deadline: float, tau_est: float, tau_kill: float) -> list:
        t0 = time.monotonic()
        results: list[Optional[TaskResult]] = [None] * n_tasks

        clock = lambda: time.monotonic() - t0

        def launch(idx, resume_from=0.0):
            board = ProgressBoard(t_lau=clock(), clock=clock)
            fut = self.pool.submit(task_fn, idx, board, resume_from)
            return board, fut

        attempts: dict[int, list] = {
            i: [launch(i)] + ([launch(i) for _ in range(r)]
                              if strategy == "clone" else [])
            for i in range(n_tasks)
        }
        speculated = set()

        def first_done(i):
            for board, fut in attempts[i]:
                if fut.done() and not fut.cancelled() and \
                        fut.exception() is None and fut.result() is not None:
                    # None = cooperative-cancellation sentinel, not a result
                    return fut
            return None

        detection_done = False
        kill_done = False
        while True:
            now = time.monotonic() - t0
            # straggler detection at tau_est (reactive strategies)
            if strategy in ("srestart", "sresume") and not detection_done \
                    and now >= tau_est:
                detection_done = True
                for i in range(n_tasks):
                    if first_done(i) is not None:
                        continue
                    board, fut = attempts[i][0]
                    if board.estimate(now) > deadline:
                        speculated.add(i)
                        if strategy == "sresume":
                            off = float(handoff_offset(
                                0.0, board.offset, now,
                                board.t_fp if board.t_fp is not None else now,
                                board.t_lau))
                            board.cancel()
                            fut.cancel()
                            attempts[i] = [launch(i, resume_from=off)
                                           for _ in range(r + 1)]
                        else:
                            attempts[i] += [launch(i) for _ in range(r)]
            # kill all-but-best at tau_kill
            if not kill_done and now >= tau_kill and \
                    (strategy == "clone" or detection_done):
                kill_done = True
                for i in range(n_tasks):
                    if len(attempts[i]) <= 1:
                        continue
                    best_j, best_p = 0, -1.0
                    for j, (board, fut) in enumerate(attempts[i]):
                        if fut.done() and not fut.cancelled() and \
                                fut.exception() is None and \
                                fut.result() is not None:
                            best_j = j
                            break
                        if board.progress > best_p:
                            best_j, best_p = j, board.progress
                    for j, (board, fut) in enumerate(attempts[i]):
                        if j != best_j:
                            board.cancel()
                            fut.cancel()
                    attempts[i] = [attempts[i][best_j]]
            # collect
            all_done = True
            for i in range(n_tasks):
                if results[i] is not None:
                    continue
                fut = first_done(i)
                if fut is None:
                    alive = any(not f.done() for _, f in attempts[i])
                    if not alive:
                        # every attempt failed/cancelled: restart (fault
                        # tolerance — a crashed host task is re-dispatched)
                        attempts[i] = [launch(i)]
                    all_done = False
                    continue
                wall = time.monotonic() - t0
                for board, f in attempts[i]:
                    if f is not fut:
                        board.cancel()
                        f.cancel()
                results[i] = TaskResult(
                    index=i, value=fut.result(), attempts=len(attempts[i]),
                    wall=wall, machine_time=wall * len(attempts[i]),
                    speculated=i in speculated)
            if all_done and all(r is not None for r in results):
                break
            time.sleep(0.002)
        return results
