"""Deadline-aware admission control and the load-adaptive r* governor;
counterpart of `repro.cluster.admission`.

Both act on the offered load visible at each job's arrival: the primary
work N E[T1] (E[T1] = t_min beta / (beta - 1)) released into the pool over
a trailing window, over the pool's capacity in that window. It comes from
the trace alone, so, as in the reference, it is host preprocessing in
float64 numpy over the trace's (J,) columns, copied off the device once
per call.

Governor: where the windowed load rho passes `util_threshold`, theta is
scaled by 1 + gain (rho - threshold) before r* is solved, so speculation
backs off under load. Admission: a job is rejected when its estimated
queueing delay (released work / slots, less the time the pool has had)
already exceeds `slack * D`; a rejected job counts as missed and costs
nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.utility import JobSpec
from ..sim.trace import JobSet


class GovernorConfig(NamedTuple):
    util_threshold: float = 0.7   # rho above which r* is rescaled
    gain: float = 4.0             # theta inflation per unit of excess rho
    window: float = 3600.0        # trailing load-estimation window (s)


class AdmissionConfig(NamedTuple):
    slack: float = 1.0            # reject when est. wait > slack * D
    window: float = 3600.0


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


def _windowed_work(jobs: JobSet, window: float):
    """(order, a_s, win_work): jobs sorted by arrival, and for each the
    primary work released over the trailing `window`, itself included."""
    beta, t_min = _host(jobs.beta), _host(jobs.t_min)
    mean_t = t_min * beta / np.maximum(beta - 1.0, 1e-3)
    work = _host(jobs.n_tasks) * mean_t
    a = _host(jobs.arrival)
    order = np.argsort(a, kind="stable")
    a_s = a[order]
    cum = np.cumsum(work[order])
    lo = np.searchsorted(a_s, a_s - window, side="left")
    win_work = cum - np.where(lo > 0, cum[np.maximum(lo - 1, 0)], 0.0)
    return order, a_s, win_work


def _unsort(values_s: np.ndarray, order: np.ndarray) -> np.ndarray:
    out = np.empty_like(values_s)
    out[order] = values_s
    return out


def offered_load(jobs: JobSet, slots: int, window: float) -> np.ndarray:
    """(J,) float64 windowed offered load rho at each job's arrival."""
    order, _, win_work = _windowed_work(jobs, window)
    return _unsort(win_work / (slots * window), order)


def apply_governor(specs: JobSpec, jobs: JobSet, slots: int,
                   cfg: GovernorConfig) -> JobSpec:
    """Scale theta where the windowed load exceeds the threshold (on the
    specs' device, in f32); the caller solves r* on the returned specs."""
    rho = offered_load(jobs, slots, cfg.window)
    scale = 1.0 + cfg.gain * np.maximum(rho - cfg.util_threshold, 0.0)
    return specs._replace(theta=specs.theta * torch.from_numpy(
        scale.astype(np.float32)).to(specs.theta.device))


def admit_jobs(jobs: JobSet, slots: int, cfg: AdmissionConfig) -> np.ndarray:
    """(J,) bool: admit each job or not."""
    order, a_s, win_work = _windowed_work(jobs, cfg.window)
    # the backlog this job queues behind: the work released over the
    # window against the time the pool has had to serve it (any backlog
    # from before the window is taken as drained)
    served = np.minimum(a_s - a_s[0], cfg.window)
    wait_est = _unsort(np.maximum(win_work / slots - served, 0.0), order)
    return wait_est <= cfg.slack * _host(jobs.D)
