"""Baseline specs: Hadoop-NS, default Hadoop speculation, Mantri; they run
at r = 0 with empirical outcomes only. Counterpart of
`repro.strategies.baselines`: the Monte-Carlo draws and the capacity
replay's AttemptTable lowerings, which draw the same numbers."""
from __future__ import annotations

import torch

from ..sim.strategies import (_pareto, hadoop_s_launch, mantri_launch,
                              sim_hadoop_ns, sim_hadoop_s, sim_mantri)
from .spec import StrategySpec, register
from .table import assemble


def _race_table(jobs, rel, dur, active):
    """Race strategies: every attempt may win, and losers hold their slot
    until the task completes (an infinite kill cap)."""
    T, A = dur.shape
    return assemble(jobs, rel, dur,
                    torch.full((T, A), torch.inf, device=dur.device),
                    torch.ones((T, A), dtype=torch.bool, device=dur.device),
                    active)


def build_hadoop_ns(draw, jobs, r_task, choice_task, p, *, max_r=8,
                    oracle=True):
    T = jobs.total_tasks
    T1 = _pareto(draw("key", (T,)), jobs.task_t_min, jobs.task_beta)
    ones = torch.ones((T, 1), dtype=torch.bool, device=T1.device)
    return assemble(jobs, torch.zeros((T, 1), device=T1.device), T1[:, None],
                    torch.full((T, 1), torch.inf, device=T1.device), ones,
                    ones)


def build_hadoop_s(draw, jobs, r_task, choice_task, p, *, max_r=8,
                   oracle=True):
    T1, T2, s_launch = hadoop_s_launch(draw, jobs, p)
    rel = torch.stack([torch.zeros_like(T1), s_launch], 1)
    active = torch.stack([torch.ones_like(T1, dtype=torch.bool),
                          T1 > s_launch], 1)
    return _race_table(jobs, rel, torch.stack([T1, T2], 1), active)


def build_mantri(draw, jobs, r_task, choice_task, p, *, max_r=8,
                 oracle=True):
    T1, extras, launch = mantri_launch(draw, jobs, p)
    rel = torch.cat([torch.zeros_like(T1)[:, None], launch], 1)
    dur = torch.cat([T1[:, None], extras], 1)
    active = torch.cat([torch.ones_like(T1, dtype=torch.bool)[:, None],
                        T1[:, None] > launch], 1)
    return _race_table(jobs, rel, dur, active)


HADOOP_NS = register(StrategySpec(
    name="hadoop_ns", kind="baseline", detectable=False,
    draw=lambda draw_u, jobs, r_task, choice_task, p, *, max_r, oracle:
        sim_hadoop_ns(draw_u, jobs, p),
    build_table=build_hadoop_ns))

HADOOP_S = register(StrategySpec(
    name="hadoop_s", kind="baseline", detectable=False,
    draw=lambda draw_u, jobs, r_task, choice_task, p, *, max_r, oracle:
        sim_hadoop_s(draw_u, jobs, p),
    race=True, build_table=build_hadoop_s))

MANTRI = register(StrategySpec(
    name="mantri", kind="baseline", detectable=False,
    draw=lambda draw_u, jobs, r_task, choice_task, p, *, max_r, oracle:
        sim_mantri(draw_u, jobs, p),
    race=True, build_table=build_mantri))
