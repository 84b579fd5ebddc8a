"""`hedge`: one delayed duplicate per task at the per-job Pareto quantile
t_q = t_min (1 - q)^(-1/beta), iff the original still runs then; the two
race and the loser runs until the task completes. Counterpart of
`repro.strategies.hedge`, with its capacity lowering."""
from __future__ import annotations

import torch

from ..core.pareto import quantile
from ..sim.strategies import _pareto
from .baselines import _race_table
from .spec import StrategySpec, register


def _hedge_draws(draw, jobs, p):
    """(T1, T2, t_q): the original, the duplicate and its launch time."""
    T = jobs.total_tasks
    t_min, beta = jobs.task_t_min, jobs.task_beta
    T1 = _pareto(draw("k1", (T,)), t_min, beta)
    T2 = _pareto(draw("k2", (T,)), t_min, beta)
    return T1, T2, quantile(p.hedge_quantile, t_min, beta)


def sim_hedge(draw, jobs, p):
    """(completion, machine) per task; draws as in sim_hadoop_s."""
    T1, T2, t_q = _hedge_draws(draw, jobs, p)
    hedged = T1 > t_q                         # still running at launch
    completion = torch.where(hedged, torch.minimum(T1, t_q + T2), T1)
    machine = torch.where(
        hedged, completion + torch.clamp(completion - t_q, min=0.0), T1)
    return completion, machine


def build_hedge(draw, jobs, r_task, choice_task, p, *, max_r=8,
                oracle=True):
    T1, T2, t_q = _hedge_draws(draw, jobs, p)
    rel = torch.stack([torch.zeros_like(T1), t_q], 1)
    active = torch.stack([torch.ones_like(T1, dtype=torch.bool), T1 > t_q],
                         1)
    return _race_table(jobs, rel, torch.stack([T1, T2], 1), active)


HEDGE = register(StrategySpec(
    name="hedge", kind="baseline", detectable=False,
    draw=lambda draw_u, jobs, r_task, choice_task, p, *, max_r, oracle:
        sim_hedge(draw_u, jobs, p),
    race=True, build_table=build_hedge))
