"""Theorem 7 strategy-dominance results; counterpart of
`repro.core.theory`."""
from __future__ import annotations

import torch

from .pocd import pocd_clone, pocd_srestart, pocd_sresume
from .utility import JobSpec


def clone_beats_srestart(job: JobSpec, r):
    """Thm 7(1): R_Clone >= R_S-Restart for any r (strict for r > 0)."""
    rc = pocd_clone(r, job.t_min, job.beta, job.D, job.N)
    rr = pocd_srestart(r, job.t_min, job.beta, job.D, job.N, job.tau_est)
    return rc >= rr


def sresume_beats_srestart(job: JobSpec, r):
    """Thm 7(2): R_S-Resume >= R_S-Restart when D - tau >= t_min (1-phi)."""
    rs = pocd_sresume(r, job.t_min, job.beta, job.D, job.N, job.tau_est,
                      job.phi_est)
    rr = pocd_srestart(r, job.t_min, job.beta, job.D, job.N, job.tau_est)
    return rs >= rr


def _log_fail_exponents(job: JobSpec):
    """a = ln(t_min/D), b = ln((1-phi) t_min/(D-tau)): log q_clone(r) =
    beta (r+1) a, log q_resume(r) = beta a + beta (r+1) b."""
    a = torch.log(job.t_min / job.D)
    b = torch.log1p(-job.phi_est) + torch.log(job.t_min
                                              / (job.D - job.tau_est))
    return a, b


def clone_vs_sresume_threshold(job: JobSpec):
    """Thm 7(3): Clone beats S-Resume iff r exceeds this threshold, the
    exact crossing (r+1)(a - b) = a of the two log-failure exponents."""
    a, b = _log_fail_exponents(job)
    return a / (a - b) - 1.0


def clone_beats_sresume(job: JobSpec, r):
    """q_clone < q_resume <=> beta (r+1) a < beta a + beta (r+1) b."""
    a, b = _log_fail_exponents(job)
    return (r + 1.0) * a < a + (r + 1.0) * b
