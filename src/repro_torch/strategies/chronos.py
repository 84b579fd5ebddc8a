"""The three Chronos strategies (paper Section IV) as StrategySpecs;
counterpart of `repro.strategies.chronos`: closed forms (Thms 1-6) and the
Monte-Carlo draw."""
from __future__ import annotations

from ..core.cost import cost_clone, cost_srestart, cost_sresume
from ..core.pocd import (log_task_fail_clone, log_task_fail_srestart,
                         log_task_fail_sresume)
from ..sim.strategies import sim_clone, sim_srestart, sim_sresume
from .spec import StrategySpec, register


def log_fail_clone(r, job):
    return log_task_fail_clone(r, job.t_min, job.beta, job.D)


def closed_cost_clone(r, job):
    return cost_clone(r, job.t_min, job.beta, job.D, job.N, job.tau_kill)


def draw_clone(draw_u, jobs, r_task, choice_task, p, *, max_r, oracle):
    return sim_clone(draw_u, jobs, r_task, p, max_r=max_r)


CLONE = register(StrategySpec(
    name="clone", kind="chronos", detectable=False, draw=draw_clone,
    log_task_fail=log_fail_clone, cost=closed_cost_clone, form="clone"))

SRESTART = register(StrategySpec(
    name="srestart", kind="chronos", detectable=True,
    draw=lambda draw_u, jobs, r_task, choice_task, p, *, max_r, oracle:
        sim_srestart(draw_u, jobs, r_task, p, max_r=max_r, oracle=oracle),
    log_task_fail=lambda r, job:
        log_task_fail_srestart(r, job.t_min, job.beta, job.D, job.tau_est),
    cost=lambda r, job:
        cost_srestart(r, job.t_min, job.beta, job.D, job.N, job.tau_est,
                      job.tau_kill),
    form="srestart"))

SRESUME = register(StrategySpec(
    name="sresume", kind="chronos", detectable=True,
    draw=lambda draw_u, jobs, r_task, choice_task, p, *, max_r, oracle:
        sim_sresume(draw_u, jobs, r_task, p, max_r=max_r, oracle=oracle),
    log_task_fail=lambda r, job:
        log_task_fail_sresume(r, job.t_min, job.beta, job.D, job.tau_est,
                              job.phi_est),
    cost=lambda r, job:
        cost_sresume(r, job.t_min, job.beta, job.D, job.N, job.tau_est,
                     job.tau_kill, job.phi_est),
    form="sresume"))
