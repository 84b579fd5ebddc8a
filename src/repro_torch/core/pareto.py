"""Pareto task-time model (paper Eq. 2); counterpart of `repro.core.pareto`.

T ~ Pareto(t_min, beta): S(t) = P(T > t) = (t_min / t)^beta, t >= t_min.
Only the moments the trace pipeline needs are ported here.
"""
from __future__ import annotations

import torch


def mean(t_min, beta):
    """E[T] = t_min * beta / (beta - 1) for beta > 1."""
    return t_min * beta / (beta - 1.0)


def quantile(q, t_min, beta):
    """Inverse CDF: t_q = t_min * (1 - q)^(-1/beta)."""
    return t_min * torch.pow(1.0 - q, -1.0 / beta)


def truncated_mean_below(t_min, beta, D):
    """E[T | T <= D] (paper Eq. 40/53), in the overflow-free form
    beta/(beta-1) * (t_min - D q) / (1 - q), q = (t_min/D)^beta, with the
    beta == 1 limit t_min ln(D/t_min) / (1 - t_min/D)."""
    q = torch.pow(t_min / D, beta)
    general = beta / (beta - 1.0) * (t_min - D * q) / (1.0 - q)
    at_one = t_min * torch.log(D / t_min) / (1.0 - t_min / D)
    return torch.where(torch.abs(beta - 1.0) < 1e-6, at_one, general)
