"""Event encoding and the dispatch recursion; counterpart of
`repro.cluster.events`.

Every strategy lowers to a flat table of attempt-units
(`strategies.table.AttemptTable`), one row per potential attempt of a
task, and each row encodes its whole lifecycle: ARRIVAL (job arrival for
primaries, primary start + rel_offset for copies), FINISH (start + dur),
the straggler check folded into `active` / `can_win`, and KILL (a
kill-timer loser holds its slot for `hold_cap`, a race loser until the
task completes). The events then collapse into one recursion over units
in dispatch order whose only state is the slot pool; on the card it is
the kernel `kernels/csrc/dispatch_scan.cu`.

Per-task reductions use the table's layout (row t*A + a is attempt a of
task t): a minimum is the (T, A) view's `amin` (exact in any order), and
a task's billed machine time is summed over its A columns in column
order, never by an atomic scatter, so its bits repeat run to run.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.dispatch_scan import dispatch_scan as _scan
from ..strategies.table import AttemptTable
from .slots import SlotPool, dispatch_key_order


class Realized(NamedTuple):
    """Outcome of one strategy replay."""
    task_completion: torch.Tensor  # (T,) FINISH of each task
    task_machine: torch.Tensor     # (T,) billed slot-time over its attempts
    wait: torch.Tensor             # (U,) start - release (0 for inactive)
    busy_time: torch.Tensor        # total billed slot-time
    span: torch.Tensor             # makespan of the replay
    preempted: torch.Tensor        # attempts killed before FINISH, int32


def _by_task(x: torch.Tensor, n_tasks: int) -> torch.Tensor:
    """(T, A) view of a (U,) unit column."""
    return x.view(n_tasks, x.shape[0] // n_tasks)


def _winner_mask(finish, eligible, task_id, n_tasks):
    """Exactly one winner per task: the earliest FINISH among eligible
    units, ties to the lower unit index (S-Resume's t_min floor makes
    exact ties common, and billing both of a tied pair would inflate
    machine time). Returns (is_winner (U,), best (T,))."""
    U = finish.shape[0]
    masked = torch.where(eligible, finish, torch.inf)
    best = _by_task(masked, n_tasks).amin(dim=1)
    idx = torch.arange(U, dtype=torch.int64, device=finish.device)
    cand = eligible & (masked <= best[task_id])
    widx = _by_task(torch.where(cand, idx, U), n_tasks).amin(dim=1)
    return idx == widx[task_id], best


def predicted_holds(table: AttemptTable, race: bool, n_tasks: int):
    """Slot-hold time per unit from the infinite-capacity outcome.

    The predicted winner (least rel_offset + dur among can_win units)
    holds `dur`; losers hold `hold_cap` (kill-timer strategies) or until
    the predicted completion (race strategies). Under capacity the
    realized winner can differ; `realize` re-derives it from the starts,
    capped by these holds, so billed occupancy never exceeds what the pool
    reserved."""
    is_winner, pred_completion = _winner_mask(
        table.rel_offset + table.dur, table.active & table.can_win,
        table.task_id, n_tasks)
    if race:
        lose_hold = torch.clamp(
            pred_completion[table.task_id] - table.rel_offset, min=0.0)
        lose_hold = torch.where(torch.isfinite(lose_hold), lose_hold, 0.0)
        lose_hold = torch.minimum(lose_hold, table.hold_cap)
    else:
        lose_hold = table.hold_cap
    hold = torch.where(is_winner, table.dur, lose_hold)
    return torch.where(table.active, hold, 0.0)


def _scan_sorted(release, hold, order, count, free):
    """The recursion over rows taken in `order`, the first `count` of them
    dispatching; starts returned in the original row order."""
    st = _scan(release[order].contiguous(), hold[order].contiguous(), count,
               free)
    out = torch.empty_like(release)
    out[order] = st
    return out


def dispatch_scan(pool: SlotPool, release, hold, active):
    """Offer each unit, in the given (dispatch) order, the earliest-idle
    slot: it starts at max(release, that slot's idle time) and holds the
    slot for `hold`. Inactive units pass through with their release and
    touch no slot. Returns (pool', starts).

    Through the kernel wrapper: active units are packed to the front in
    their order by one stable sort, and the recursion walks that prefix.
    """
    order = torch.sort((~active).to(torch.int8), stable=True).indices
    free = pool.free.reshape(-1).clone()
    starts = _scan_sorted(release, hold, order,
                          active.sum(dtype=torch.int32), free)
    free = free.view(pool.free.shape)
    return SlotPool(free=free, gmin=free.amin(dim=1)), starts


def masked_dispatch(slots: int, discipline: str, release, hold, active,
                    deadline_abs):
    """One scheduling pass over all units on a pool of `slots` slots idle
    at t = 0: a stable key sort packs the active units into a
    dispatch-ordered prefix (inactive ones keyed +inf), the recursion walks
    that prefix (its length stays on the device), and the starts go back
    to unit order. Inactive units report their release."""
    order = dispatch_key_order(discipline, release, deadline_abs,
                               inactive=~active)
    free = torch.zeros(slots, dtype=torch.float32, device=release.device)
    return _scan_sorted(release, hold, order, active.sum(dtype=torch.int32),
                        free)


def realize(table: AttemptTable, release, start, sched_hold, race: bool,
            n_tasks: int) -> Realized:
    """Task completions, billing and queue metrics from the starts.

    Completion is the earliest FINISH over a task's eligible units, those
    that finish before their own kill timer (dur <= sched_hold): an
    attempt the schedule killed can never complete a task on slot-time
    the pool already freed. The realized winner is billed `dur`; losers
    `hold_cap` (kill-timer) or the time to completion (race), capped at
    the scheduled hold.
    """
    eligible = table.active & table.can_win & (table.dur <= sched_hold)
    is_winner, completion = _winner_mask(start + table.dur, eligible,
                                         table.task_id, n_tasks)
    if race:
        lose = torch.clamp(completion[table.task_id] - start, min=0.0)
        lose = torch.where(torch.isfinite(lose), lose, 0.0)
    else:
        lose = table.hold_cap
    billed = torch.where(is_winner, table.dur,
                         torch.minimum(lose, sched_hold))
    billed = torch.where(table.active, torch.minimum(billed, sched_hold),
                         0.0)
    cols = _by_task(billed, n_tasks)
    task_machine = cols[:, 0]
    for a in range(1, cols.shape[1]):
        task_machine = task_machine + cols[:, a]

    wait = torch.where(table.active, torch.clamp(start - release, min=0.0),
                       0.0)
    end = torch.where(table.active, start + billed, -torch.inf)
    t0 = torch.where(table.active, release, torch.inf).amin()
    span = torch.clamp(end.amax() - t0, min=1e-9)
    preempted = (table.active & ~is_winner
                 & (billed < table.dur - 1e-6)).sum(dtype=torch.int32)
    return Realized(task_completion=completion,
                    task_machine=task_machine.contiguous(), wait=wait,
                    busy_time=billed.sum(), span=span, preempted=preempted)
