"""The three Chronos strategies (paper Section IV) as StrategySpecs;
counterpart of `repro.strategies.chronos`: closed forms (Thms 1-6), the
Thm-8 concavity thresholds, the certified grid-bound slopes, the
Monte-Carlo draw, the capacity replay's AttemptTable lowerings (the same
draws as the sims), and the tile bodies of the `kernels.pocd_mc` modes."""
from __future__ import annotations

import numpy as np
import torch

from ..core.cost import cost_clone, cost_srestart, cost_sresume
from ..core.pocd import (log_task_fail_clone, log_task_fail_srestart,
                         log_task_fail_sresume)
from ..sim.strategies import (_detect, _pareto, sim_clone, sim_srestart,
                              sim_sresume)
from .spec import StrategySpec, register
from .table import assemble


# ---------------------------------------------------------------------------
# Thm-8 concavity thresholds (Algorithm 1 phase split)
# ---------------------------------------------------------------------------


def gamma_clone(job):
    """Gamma_Clone = -1/beta log_{t_min/D} N - 1: R_Clone(r) is concave iff
    (t_min/D)^(beta(r+1)) <= 1/N."""
    log_ratio = torch.log(job.t_min / job.D)  # < 0
    return -torch.log(job.N) / (job.beta * log_ratio) - 1.0


def gamma_srestart(job):
    """Gamma_S-Restart: the r where the task failure probability
    (t_min/D)^beta (t_min/(D-tau))^(beta r) reaches 1/N."""
    lr = torch.log(job.t_min / (job.D - job.tau_est))  # < 0
    target = job.beta * torch.log(job.D / job.t_min) - torch.log(job.N)
    return target / (job.beta * lr)


def gamma_sresume(job):
    """Gamma_S-Resume: the same condition with the resumed-attempt
    failure ratio (1-phi) t_min / (D - tau)."""
    lr = torch.log1p(-job.phi_est) + torch.log(job.t_min
                                               / (job.D - job.tau_est))
    target = job.beta * torch.log(job.D / job.t_min) - torch.log(job.N)
    return target / (job.beta * lr) - 1.0


# ---------------------------------------------------------------------------
# Certified grid-bound slopes (host floats; see core.optimizer.r_upper_bound)
# ---------------------------------------------------------------------------


def slope_clone(job) -> float:
    """Every task kills r clones at tau_kill."""
    return float(job.N) * float(job.tau_kill)


def slope_reactive(job) -> float:
    """Only stragglers pay: N p_straggler (tau_kill - tau_est)."""
    p_s = float(np.power(float(job.t_min) / float(job.D), float(job.beta)))
    return float(job.N) * p_s * (float(job.tau_kill) - float(job.tau_est))


# ---------------------------------------------------------------------------
# Monte-Carlo tile bodies (shared Pareto attempt times; kernels/pocd_mc.py)
# att (J, N, R); t_min (J, 1, 1); tau_est, tau_kill, D (J, 1); r (J, 1) i32.
# Each returns (completion, machine), both (J, N). An r past the slots
# activates every slot.
# ---------------------------------------------------------------------------


def _slots(n: int, att: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=att.device)


def tile_clone(att, t_min, tau_est, tau_kill, D, r, *, phi):
    """r + 1 attempts race from t = 0; killed clones bill tau_kill."""
    active = _slots(att.shape[2], att) <= r[:, :, None]
    best = torch.amin(torch.where(active, att, torch.inf), dim=2)
    machine = r.to(att.dtype) * tau_kill + best
    return best, machine


def tile_srestart(att, t_min, tau_est, tau_kill, D, r, *, phi):
    """Stragglers (T1 > D) get r fresh restarts at tau_est."""
    T1 = att[:, :, 0]
    strag = T1 > D
    active = ((_slots(att.shape[2] - 1, att) < r[:, :, None])
              & strag[:, :, None])
    extras = torch.amin(torch.where(active, att[:, :, 1:], torch.inf), dim=2)
    w_all = torch.minimum(T1 - tau_est, extras)
    use = strag & (r > 0)
    completion = torch.where(use, tau_est + w_all, T1)
    machine = torch.where(
        use, tau_est + r.to(att.dtype) * (tau_kill - tau_est) + w_all, T1)
    return completion, machine


def tile_sresume(att, t_min, tau_est, tau_kill, D, r, *, phi):
    """Stragglers are killed at tau_est; r + 1 resumed attempts run the
    remaining (1 - phi) of the work with a t_min startup floor."""
    T1 = att[:, :, 0]
    strag = T1 > D
    resumed = torch.maximum(t_min, (1.0 - phi) * att[:, :, 1:])
    active = ((_slots(att.shape[2] - 1, att) <= r[:, :, None])
              & strag[:, :, None])
    w_new = torch.amin(torch.where(active, resumed, torch.inf), dim=2)
    completion = torch.where(strag, tau_est + w_new, T1)
    machine = torch.where(
        strag, tau_est + r.to(att.dtype) * (tau_kill - tau_est) + w_new, T1)
    return completion, machine


# ---------------------------------------------------------------------------
# AttemptTable lowerings (draws as in sim/strategies.py)
# ---------------------------------------------------------------------------


def build_clone(draw, jobs, r_task, choice_task, p, *, max_r=8,
                oracle=True):
    """r + 1 attempts from t = 0; losers are killed at tau_kill."""
    T = jobs.total_tasks
    t_min, beta = jobs.task_t_min, jobs.task_beta
    tau_kill = (p.tau_est_frac + p.tau_kill_gap_frac) * t_min
    att = _pareto(draw("key", (T, max_r + 1)), t_min[:, None], beta[:, None])
    active = _slots(max_r + 1, att)[None, :] <= r_task[:, None]
    return assemble(jobs, torch.zeros((T, 1), device=att.device), att,
                    tau_kill[:, None],
                    torch.ones((T, 1), dtype=torch.bool, device=att.device),
                    active)


def build_srestart(draw, jobs, r_task, choice_task, p, *, max_r=8,
                   oracle=True):
    """A detected straggler gets r fresh restarts at tau_est. A losing
    primary is killed at tau_kill; losing copies at tau_kill too, billed
    from their tau_est launch (Thm 3's r (tau_kill - tau_est) term)."""
    T = jobs.total_tasks
    t_min, beta, D = jobs.task_t_min, jobs.task_beta, jobs.task_D
    tau_est = p.tau_est_frac * t_min
    tau_kill = tau_est + p.tau_kill_gap_frac * t_min
    T1 = _pareto(draw("k1", (T,)), t_min, beta)
    extras = _pareto(draw("k2", (T, max_r)), t_min[:, None], beta[:, None])
    straggler = _detect(T1, t_min, D, tau_est, p, oracle)
    spec_active = ((_slots(max_r, T1)[None, :] < r_task[:, None])
                   & straggler[:, None])
    rel = torch.cat([torch.zeros((T, 1), device=T1.device),
                     tau_est[:, None].expand(T, max_r)], 1)
    dur = torch.cat([T1[:, None], extras], 1)
    hold = torch.cat([tau_kill[:, None],
                      (tau_kill - tau_est)[:, None].expand(T, max_r)], 1)
    active = torch.cat([torch.ones((T, 1), dtype=torch.bool,
                                   device=T1.device), spec_active], 1)
    return assemble(jobs, rel, dur, hold,
                    torch.ones((T, 1), dtype=torch.bool, device=T1.device),
                    active)


def build_sresume(draw, jobs, r_task, choice_task, p, *, max_r=8,
                  oracle=True):
    """A detected straggler is killed at tau_est (its work handed off) and
    can never win; r + 1 resumed attempts start at tau_est, and losers
    are killed at tau_kill."""
    T = jobs.total_tasks
    t_min, beta, D = jobs.task_t_min, jobs.task_beta, jobs.task_D
    tau_est = p.tau_est_frac * t_min
    tau_kill = tau_est + p.tau_kill_gap_frac * t_min
    T1 = _pareto(draw("k1", (T,)), t_min, beta)
    fresh = _pareto(draw("k2", (T, max_r + 1)), t_min[:, None],
                    beta[:, None])
    resumed = torch.maximum(t_min[:, None], (1.0 - p.phi_est) * fresh)
    straggler = _detect(T1, t_min, D, tau_est, p, oracle)
    spec_active = ((_slots(max_r + 1, T1)[None, :] <= r_task[:, None])
                   & straggler[:, None])
    rel = torch.cat([torch.zeros((T, 1), device=T1.device),
                     tau_est[:, None].expand(T, max_r + 1)], 1)
    dur = torch.cat([T1[:, None], resumed], 1)
    hold = torch.cat([torch.where(straggler, tau_est, T1)[:, None],
                      (tau_kill - tau_est)[:, None].expand(T, max_r + 1)], 1)
    can_win = torch.cat([~straggler[:, None],
                         torch.ones((T, max_r + 1), dtype=torch.bool,
                                    device=T1.device)], 1)
    active = torch.cat([torch.ones((T, 1), dtype=torch.bool,
                                   device=T1.device), spec_active], 1)
    return assemble(jobs, rel, dur, hold, can_win, active)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def log_fail_clone(r, job):
    return log_task_fail_clone(r, job.t_min, job.beta, job.D)


def closed_cost_clone(r, job):
    return cost_clone(r, job.t_min, job.beta, job.D, job.N, job.tau_kill)


def draw_clone(draw_u, jobs, r_task, choice_task, p, *, max_r, oracle):
    return sim_clone(draw_u, jobs, r_task, p, max_r=max_r)


CLONE = register(StrategySpec(
    name="clone", kind="chronos", detectable=False, draw=draw_clone,
    log_task_fail=log_fail_clone, cost=closed_cost_clone, form="clone",
    gamma=gamma_clone, r_slope=slope_clone, tile_outcome=tile_clone,
    build_table=build_clone))

SRESTART = register(StrategySpec(
    name="srestart", kind="chronos", detectable=True,
    draw=lambda draw_u, jobs, r_task, choice_task, p, *, max_r, oracle:
        sim_srestart(draw_u, jobs, r_task, p, max_r=max_r, oracle=oracle),
    log_task_fail=lambda r, job:
        log_task_fail_srestart(r, job.t_min, job.beta, job.D, job.tau_est),
    cost=lambda r, job:
        cost_srestart(r, job.t_min, job.beta, job.D, job.N, job.tau_est,
                      job.tau_kill),
    form="srestart", gamma=gamma_srestart, r_slope=slope_reactive,
    tile_outcome=tile_srestart, build_table=build_srestart))

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
    form="sresume", gamma=gamma_sresume, r_slope=slope_reactive,
    tile_outcome=tile_sresume, build_table=build_sresume))
