"""AttemptTable: the flat per-attempt-unit encoding every strategy lowers to
under finite capacity; counterpart of `repro.strategies.table`.

One row per potential attempt of a task, each encoding its whole analytic
lifecycle (release offset, duration, slot-hold cap, win eligibility); the
capacity replay (`repro_torch.cluster`) schedules the rows on a bounded
slot pool. It is the target of every `StrategySpec.build_table`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AttemptTable(NamedTuple):
    """Flat per-attempt-unit tensors, (U,) each; U = total_tasks * width."""
    task_id: torch.Tensor      # int64, flat task index
    job_id: torch.Tensor       # int64
    rel_offset: torch.Tensor   # f32, ARRIVAL offset from the primary's start
    dur: torch.Tensor          # f32, time from start to FINISH
    hold_cap: torch.Tensor     # f32, KILL: slot-hold if the unit loses
    can_win: torch.Tensor      # bool, may its FINISH complete the task?
    active: torch.Tensor       # bool, does this unit ever dispatch?
    is_primary: torch.Tensor   # bool


def assemble(jobs, rel, dur, hold_cap, can_win, active) -> AttemptTable:
    """Flatten (T, A) per-attempt tensors (or (T, 1) columns broadcast to
    A) into a (T*A,) AttemptTable.

    Layout contract, which the replay's primary slice relies on: row
    t*A + a is attempt a of task t, and attempt 0 is the primary.
    """
    T, A = dur.shape
    dev = dur.device

    def flat(x):
        return torch.broadcast_to(x, (T, A)).reshape(-1)

    task_id = torch.arange(T, device=dev).repeat_interleave(A)
    is_primary = flat(torch.arange(A, device=dev)[None, :] == 0)
    return AttemptTable(
        task_id=task_id, job_id=jobs.job_id[task_id],
        rel_offset=flat(rel).to(torch.float32),
        dur=flat(dur).to(torch.float32),
        hold_cap=flat(hold_cap).to(torch.float32),
        can_win=flat(can_win), active=flat(active), is_primary=is_primary)
