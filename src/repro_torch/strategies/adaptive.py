"""`adaptive`: per job, the (sub-strategy, r) pair with the best net
utility across the three Chronos closed forms, U(r) = max_s U_s(r).
Counterpart of `repro.strategies.adaptive`.

Draw layout: one primary T1 ("k1") plus one shared (T, max_r + 1) extras
block ("k2"), read per chosen mode (clone: all race from t = 0 beside the
primary; srestart: fresh restarts at tau_est; sresume: resumed remainders
at tau_est).
"""
from __future__ import annotations

import torch

from ..sim.strategies import _detect, _masked_min, _pareto
from .chronos import CLONE, SRESTART, SRESUME, slope_reactive
from .spec import StrategySpec, register, utility_of

_SUBS = (CLONE, SRESTART, SRESUME)


def _sub_utilities(r, job):
    """(n_subs, ...) stacked U_s(r); argmax over dim 0 is the pick."""
    return torch.stack([utility_of(s, r, job) for s in _SUBS])


def _select(vals, best):
    """vals[best] elementwise; vals a list of (...) tensors, best (...)."""
    return torch.gather(torch.stack(vals), 0, best[None].long())[0]


def _log_task_fail(r, job):
    best = torch.argmax(_sub_utilities(r, job), dim=0)
    return _select([s.log_task_fail(r, job) for s in _SUBS], best)


def _cost(r, job):
    best = torch.argmax(_sub_utilities(r, job), dim=0)
    return _select([s.cost(r, job) for s in _SUBS], best)


def _choose(r, jobs):
    """Per-job argmax sub-strategy id at the solved r."""
    return torch.argmax(_sub_utilities(r, jobs), dim=0).to(torch.int32)


def sim_adaptive(draw, jobs, r_task, choice_task, p, *, max_r=8,
                 oracle=True):
    T = jobs.total_tasks
    t_min, beta, D = jobs.task_t_min, jobs.task_beta, jobs.task_D
    tau_est = p.tau_est_frac * t_min
    tau_kill = tau_est + p.tau_kill_gap_frac * t_min
    T1 = _pareto(draw("k1", (T,)), t_min, beta)
    extras = _pareto(draw("k2", (T, max_r + 1)), t_min[:, None],
                     beta[:, None])
    straggler = _detect(T1, t_min, D, tau_est, p, oracle)
    slot = torch.arange(max_r + 1, device=T1.device)[None, :]
    r = r_task[:, None]
    rf = r_task.to(T1.dtype)

    # clone: primary + extras all race from t = 0; killed clones bill tau_kill
    att = torch.cat([T1[:, None], extras[:, :max_r]], dim=1)
    best_c = _masked_min(slot <= r, att)
    comp_c, mach_c = best_c, rf * tau_kill + best_c

    # srestart: r fresh restarts at tau_est for detected stragglers
    act_r = (slot[:, :max_r] < r) & straggler[:, None]
    best_e = _masked_min(act_r, extras[:, :max_r])
    w_all = torch.minimum(T1 - tau_est, best_e)
    use = straggler & (r_task > 0)
    comp_r = torch.where(use, tau_est + w_all, T1)
    mach_r = torch.where(use, tau_est + rf * (tau_kill - tau_est) + w_all, T1)

    # sresume: original killed at tau_est; r+1 resumed attempts with floor
    resumed = torch.maximum(t_min[:, None], (1.0 - p.phi_est) * extras)
    act_m = (slot <= r) & straggler[:, None]
    w_new = _masked_min(act_m, resumed)
    comp_m = torch.where(straggler, tau_est + w_new, T1)
    mach_m = torch.where(straggler,
                         tau_est + rf * (tau_kill - tau_est) + w_new, T1)

    completion = _select([comp_c, comp_r, comp_m], choice_task)
    machine = _select([mach_c, mach_r, mach_m], choice_task)
    return completion, machine


ADAPTIVE = register(StrategySpec(
    name="adaptive", kind="meta", detectable=True, draw=sim_adaptive,
    log_task_fail=_log_task_fail, cost=_cost, r_slope=slope_reactive,
    choose=_choose,
    # choose-id order; must match _SUBS
    components=("clone", "srestart", "sresume")))
