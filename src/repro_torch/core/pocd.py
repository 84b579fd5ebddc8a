"""PoCD closed forms, paper Theorems 1, 3, 5, in log space.

Counterpart of `repro.core.pocd`; same arithmetic in the same order, so
the plain path and the CUDA grid solve (`kernels/csrc/grid_solve.cu`,
which repeats these lines in C) agree with the reference to f32 rounding.
Arguments are tensors that broadcast; `r` is a float tensor.
"""
from __future__ import annotations

import numpy as np
import torch

# `1.0 - 1e-12` as the reference writes it, rounded to f32 as the reference
# computes it: the clip is a no-op (1.0f), so p == 1 gives log1p(-1) = -inf
# and R == 0, exactly as in the reference
_P_CLIP = float(np.float32(1.0 - 1e-12))


def _log_ratio(t_min, D):
    """log(t_min / D)."""
    return torch.log(t_min) - torch.log(D)


def _log_sf_ratio(log_ratio):
    """P(T > t) = min(1, (t_min/t)^beta): clamp the log term at 0."""
    return torch.clamp(log_ratio, max=0.0)


def log_task_fail_clone(r, t_min, beta, D):
    """Thm 1: P_fail = (t_min/D)^(beta (r+1))."""
    return beta * (r + 1.0) * _log_sf_ratio(_log_ratio(t_min, D))


def log_task_fail_srestart(r, t_min, beta, D, tau_est):
    """Thm 3: P_fail = (t_min/D)^beta (t_min/(D-tau_est))^(beta r)."""
    return beta * _log_sf_ratio(_log_ratio(t_min, D)) + \
        beta * r * _log_sf_ratio(_log_ratio(t_min, D - tau_est))


def log_task_fail_sresume(r, t_min, beta, D, tau_est, phi_est):
    """Thm 5: P_fail = (t_min/D)^beta ((1-phi) t_min/(D-tau))^(beta (r+1)),
    with the t_min startup floor (exactly 1 when D - tau < t_min)."""
    window = D - tau_est
    resid = torch.log1p(-phi_est) + _log_ratio(t_min, window)
    resid = torch.where(window >= t_min, torch.clamp(resid, max=0.0),
                        torch.zeros_like(resid))
    return beta * _log_sf_ratio(_log_ratio(t_min, D)) + \
        beta * (r + 1.0) * resid


def _job_pocd_from_log_fail(log_p_fail, N):
    """R = (1 - P_fail)^N = exp(N log1p(-exp(log P_fail)))."""
    p = torch.exp(torch.clamp(log_p_fail, max=0.0))
    return torch.exp(N * torch.log1p(-torch.clamp(p, max=_P_CLIP)))


def pocd_clone(r, t_min, beta, D, N):
    """R_Clone (Theorem 1)."""
    return _job_pocd_from_log_fail(log_task_fail_clone(r, t_min, beta, D), N)


def pocd_srestart(r, t_min, beta, D, N, tau_est):
    """R_S-Restart (Theorem 3); r == 0 is no speculation."""
    return _job_pocd_from_log_fail(
        log_task_fail_srestart(r, t_min, beta, D, tau_est), N)


def pocd_sresume(r, t_min, beta, D, N, tau_est, phi_est):
    """R_S-Resume (Theorem 5); r extra attempts are r + 1 resumed ones."""
    return _job_pocd_from_log_fail(
        log_task_fail_sresume(r, t_min, beta, D, tau_est, phi_est), N)
