"""Samplers for heterogeneous workloads on tensors; counterpart of
`repro.workloads.generators`.

Three ingredients compose into a trace (`traces.synthesize`): a
`JobClass` mixture (per-job parameters gathered from stacked class
columns at a categorical class draw), an arrival process (Poisson, batch
Poisson, diurnal NHPP and cyclic MMPP, the last two by time-rescaling a
unit-rate Poisson process), and `hill_estimator` for the tail index.

Every sampler takes a workload source (`sim.draws.WorkloadPhilox`, or a
test's replay source) and draws under the reference's key names, on the
caller's device. Running sums use `sim.metrics.scan_sum`, which gives
the same bits on every device and every run (`torch.cumsum` on CUDA does
not).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..sim.metrics import scan_sum


class JobClass(NamedTuple):
    """One component of a workload mixture."""

    name: str
    weight: float                      # mixture weight (normalized)
    mean_tasks: float                  # E[tasks/job] for this class
    sigma_tasks: float                 # lognormal sigma (task-count tail)
    t_min_range: Tuple[float, float]   # per-job Pareto scale, uniform
    beta_range: Tuple[float, float]    # per-job Pareto tail, uniform
    deadline_ratio: float              # D = ratio * E[task time]
    theta_scale: float = 1.0           # SLA-weight multiplier (tenant tier)
    price: float = 1.0                 # VM price C for this class
    min_tasks: int = 4
    max_tasks: int = 5000


def _column(classes: Sequence[JobClass], field: str, device) -> torch.Tensor:
    """One JobClass field as a (K,) f32 column."""
    return torch.tensor([float(getattr(c, field)) for c in classes],
                        dtype=torch.float32, device=device)


def _range_columns(classes: Sequence[JobClass], field: str, device):
    lo = torch.tensor([float(getattr(c, field)[0]) for c in classes],
                      dtype=torch.float32, device=device)
    hi = torch.tensor([float(getattr(c, field)[1]) for c in classes],
                      dtype=torch.float32, device=device)
    return lo, hi


def sample_classes(source, n_jobs: int, classes: Sequence[JobClass], *,
                   device=None) -> torch.Tensor:
    """(J,) int32 class ids ~ Categorical(normalized weights)."""
    dev = resolve_device(device)
    logits = torch.log(_column(classes, "weight", dev))
    return source.categorical("classes", logits, (n_jobs,))


def sample_task_counts(source, cls: torch.Tensor,
                       classes: Sequence[JobClass]) -> torch.Tensor:
    """(J,) int32 lognormal task counts with mu = log(mean) - sigma^2 / 2
    (E[n] = mean_tasks before clipping), clipped to the class bounds and
    truncated."""
    dev = cls.device
    c = cls.long()
    sigma = _column(classes, "sigma_tasks", dev)[c]
    mu = torch.log(_column(classes, "mean_tasks", dev))[c] - 0.5 * sigma**2
    lo = _column(classes, "min_tasks", dev)[c]
    hi = _column(classes, "max_tasks", dev)[c]
    raw = torch.exp(mu + sigma * source.normal("task_counts", cls.shape, dev))
    return torch.clamp(raw, lo, hi).to(torch.int32)


def sample_pareto_params(source, cls: torch.Tensor,
                         classes: Sequence[JobClass]):
    """Per-job (t_min, beta, D): uniform within the class ranges, with
    D = deadline_ratio * E[Pareto(t_min, beta)]."""
    dev = cls.device
    c = cls.long()
    t_lo, t_hi = _range_columns(classes, "t_min_range", dev)
    b_lo, b_hi = _range_columns(classes, "beta_range", dev)
    t_min = t_lo[c] + (t_hi - t_lo)[c] * source.uniform("t_min", cls.shape,
                                                         dev)
    beta = b_lo[c] + (b_hi - b_lo)[c] * source.uniform("beta", cls.shape,
                                                        dev)
    mean_task = t_min * beta / (beta - 1.0)
    D = _column(classes, "deadline_ratio", dev)[c] * mean_task
    return t_min, beta, D


# ---------------------------------------------------------------------------
# Arrival processes: each returns (J,) f32 arrival times in seconds
# ---------------------------------------------------------------------------


def poisson_arrivals(source, n_jobs: int, rate: float, *,
                     device=None) -> torch.Tensor:
    """Homogeneous Poisson: running sum of Exp gaps at `rate` (1/s)."""
    dev = resolve_device(device)
    return scan_sum(source.exponential("arrival", (n_jobs,), dev) / rate)


def batch_poisson_arrivals(source, n_jobs: int, rate: float,
                           mean_batch: float = 10.0, *,
                           device=None) -> torch.Tensor:
    """Batch Poisson (flash crowd): batch epochs arrive as a Poisson
    process at rate / mean_batch, batch sizes are geometric with mean
    `mean_batch`, and every job of a batch lands at its epoch.

    The reference sums where(new_batch, gap, 0); adding 0 keeps a sum, so
    every job of a crowd takes its epoch's sum. Here each job reads the sum
    at its epoch's index, which is that value under any summation order.
    """
    dev = resolve_device(device)
    new_batch = source.bernoulli("arrival.new_batch", 1.0 / mean_batch,
                                 (n_jobs,), dev).clone()
    new_batch[0] = True
    gaps = source.exponential("arrival.gap", (n_jobs,), dev) * (
        mean_batch / rate)
    total = scan_sum(torch.where(new_batch, gaps, 0.0))
    idx = torch.arange(n_jobs, device=dev)
    epoch = torch.cummax(torch.where(new_batch, idx, 0), dim=0).values
    return total[epoch]


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
    """`jnp.interp(x, xp, fp)`: linear interpolation on sorted xp, fp[0]
    left of the grid and fp[-1] right of it; a zero-width interval takes
    its left value."""
    i = torch.searchsorted(xp, x, right=True).clamp_(1, xp.shape[0] - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    df = fp[i] - f0
    dx = xp[i] - x0
    tiny = float(np.spacing(np.finfo(np.float32).eps))   # f32 grids
    dx0 = dx.abs() <= tiny
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _rescale_unit_poisson(source, name: str, n_jobs: int, t_grid, lam_grid):
    """An NHPP sampled exactly: unit-rate epochs (a running sum of Exp(1))
    mapped through the inverse of the integrated intensity, linear between
    the (t_grid, lam_grid) points and clamped into the covered horizon."""
    unit = scan_sum(source.exponential(name, (n_jobs,), t_grid.device))
    unit = torch.minimum(unit, lam_grid[-1])
    return interp(unit, lam_grid, t_grid)


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """f32 `jnp.linspace(start, stop, num)`, formed as the reference forms
    it: start (1 - s) + stop s with s = iota / (num - 1), then stop."""
    f32 = dict(dtype=torch.float32, device=device)
    lo = torch.tensor(start, **f32)
    hi = torch.tensor(stop, **f32)
    div = num - 1
    step = torch.arange(div, **f32) / torch.tensor(float(div), **f32)
    return torch.cat([lo * (1 - step) + hi * step, hi[None]])


def diurnal_arrivals(source, n_jobs: int, rate: float,
                     amplitude: float = 0.8, period: float = 86400.0,
                     grid_points: int = 4096, *,
                     device=None) -> torch.Tensor:
    """Diurnal NHPP, rate(t) = rate (1 + amplitude sin(2 pi t / T)): the
    integrated intensity in closed form on a grid whose horizon covers the
    expected n_jobs-th arrival twice over."""
    if not 0.0 <= amplitude < 1.0:
        raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
    dev = resolve_device(device)
    horizon = 2.0 * n_jobs / rate + period
    t = _linspace(0.0, horizon, grid_points, dev)
    w = 2.0 * math.pi / period
    lam = rate * (t + amplitude / w * (1.0 - torch.cos(w * t)))
    return _rescale_unit_poisson(source, "arrival", n_jobs, t, lam)


def mmpp_arrivals(source, n_jobs: int, rate: float,
                  phase_shape: Sequence[float] = (3.0, 0.2),
                  mean_dwell: float = 3600.0, *,
                  device=None) -> torch.Tensor:
    """Cyclic MMPP: phases cycle with Exp(mean_dwell) dwells and arrivals
    are Poisson at the phase's rate; `phase_shape` gives the relative
    phase rates, scaled so their mean is the long-run `rate`."""
    dev = resolve_device(device)
    shape = torch.tensor([float(x) for x in phase_shape],
                         dtype=torch.float32, device=dev)
    rates = rate * shape / (shape.sum() / shape.shape[0])
    n_phases = rates.shape[0]
    # enough dwell segments to cover the expected horizon 4x over
    n_seg = int(4.0 * (n_jobs / rate) / mean_dwell) + 4 * n_phases
    dwell = source.exponential("arrival.dwell", (n_seg,), dev) * mean_dwell
    seg_rate = rates[torch.arange(n_seg, device=dev) % n_phases]
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    t_grid = torch.cat([zero, scan_sum(dwell)])
    lam_grid = torch.cat([zero, scan_sum(seg_rate * dwell)])
    return _rescale_unit_poisson(source, "arrival.unit", n_jobs, t_grid,
                                 lam_grid)


ARRIVAL_PROCESSES = {
    "poisson": poisson_arrivals,
    "batch": batch_poisson_arrivals,
    "diurnal": diurnal_arrivals,
    "mmpp": mmpp_arrivals,
}


def sample_arrivals(source, n_jobs: int, process: str, rate: float, *,
                    device=None, **kwargs) -> torch.Tensor:
    """Dispatch to a named arrival process at long-run job rate `rate`."""
    if process not in ARRIVAL_PROCESSES:
        raise ValueError(
            f"unknown arrival process {process!r}; "
            f"expected one of {tuple(ARRIVAL_PROCESSES)}")
    return ARRIVAL_PROCESSES[process](source, n_jobs, rate, device=device,
                                      **kwargs)


def hill_estimator(samples: torch.Tensor, k: int) -> torch.Tensor:
    """Hill estimate of the Pareto tail index from the k largest order
    statistics, k / sum(log(x_(i) / x_(k+1))); for Pareto(t_min, beta)
    samples it converges to beta."""
    x = torch.sort(samples.reshape(-1).to(torch.float32)).values
    if not 0 < k < x.shape[0]:
        raise ValueError(
            f"need 0 < k < n_samples, got k={k}, n={x.shape[0]}")
    return k / torch.sum(torch.log(x[-k:] / x[-(k + 1)]))
