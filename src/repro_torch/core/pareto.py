"""Pareto task-time model (paper Eq. 2); counterpart of `repro.core.pareto`.

T ~ Pareto(t_min, beta): f(t) = beta t_min^beta / t^(beta+1), t >= t_min;
S(t) = P(T > t) = (t_min / t)^beta. Functions take tensors or Python
numbers and broadcast; numbers become f32 tensors (the reference's jnp
arrays are f32), on the device of the first tensor argument.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ParetoParams(NamedTuple):
    t_min: torch.Tensor   # scale (minimum execution time), > 0
    beta: torch.Tensor    # tail index, > 1 for a finite mean


def _f32(*xs):
    """Each argument as a tensor; numbers as f32 on the first tensor's
    device (the CPU when there is none)."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    return [x if isinstance(x, torch.Tensor)
            else torch.tensor(x, dtype=torch.float32, device=dev) for x in xs]


def pdf(t, t_min, beta):
    t, t_min, beta = _f32(t, t_min, beta)
    val = beta * torch.pow(t_min, beta) / torch.pow(t, beta + 1.0)
    return torch.where(t >= t_min, val, 0.0)


def cdf(t, t_min, beta):
    t, t_min, beta = _f32(t, t_min, beta)
    return torch.where(t >= t_min, 1.0 - torch.pow(t_min / t, beta), 0.0)


def sf(t, t_min, beta):
    """Survival function P(T > t)."""
    t, t_min, beta = _f32(t, t_min, beta)
    return torch.where(t >= t_min, torch.pow(t_min / t, beta), 1.0)


def log_sf(t, t_min, beta):
    t, t_min, beta = _f32(t, t_min, beta)
    return torch.where(t >= t_min, beta * (torch.log(t_min) - torch.log(t)),
                       0.0)


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


def from_uniform(u, t_min, beta):
    """Inverse-transform sampling from uniforms u in (0, 1]:
    t_min * u^(-1/beta), `sample`'s transform."""
    return t_min * torch.pow(u, -1.0 / beta)


def sample(generator: torch.Generator, t_min, beta, shape=()):
    """Pareto draws of `shape` on the generator's device, from uniforms in
    [tiny, 1) as the reference draws them (`jax.random.uniform` with
    minval the smallest normal f32): the draws differ from the
    reference's, the transform (`from_uniform`) is the same."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    u = torch.clamp(tiny + (1.0 - tiny) * u, min=tiny)
    return from_uniform(u, *_f32(t_min, beta))


def min_of_n_mean(t_min, beta, n):
    """Lemma 1: E[min of n iid Pareto] = t_min n beta / (n beta - 1): the
    min of n iid Pareto(t_min, beta) is Pareto(t_min, n beta). Needs
    n beta > 1."""
    nb = n * beta
    return t_min * nb / (nb - 1.0)


def truncated_mean_above(t_min, beta, D):
    """E[T | T > D] = D beta / (beta - 1) (Pareto is self-similar above
    D)."""
    return D * beta / (beta - 1.0)


def fit_mle(samples, mask=None) -> ParetoParams:
    """Maximum-likelihood fit of (t_min, beta) from observed durations:
    t_min = min(samples), beta = n / sum(log(samples / t_min)), in f32.
    `mask` optionally marks the valid entries (ragged telemetry buffers).
    beta is clipped to (1.01, 20) for the finite-mean formulas."""
    x = torch.as_tensor(samples, dtype=torch.float32)
    if mask is None:
        mask = torch.ones_like(x, dtype=torch.bool)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=x.device)
    big = torch.finfo(torch.float32).max
    t_min_hat = torch.min(torch.where(mask, x, big))
    n = torch.sum(mask)
    logs = torch.where(mask, torch.log(torch.clamp(x, min=1e-30) / t_min_hat),
                       0.0)
    denom = torch.clamp(torch.sum(logs), min=1e-9)
    beta_hat = torch.clamp(n / denom, 1.01, 20.0)
    return ParetoParams(t_min=t_min_hat, beta=beta_hat)
