"""Multi-wave executions — the paper's stated future work (Conclusion:
"Multi-wave executions will be considered in our future work").

When a job's N tasks exceed the M available containers they run in
W = ceil(N/M) waves; wave w starts when wave w-1 finishes, so job time is a
SUM of wave makespans (each a max of M task times) rather than a single max.
No elementary closed form exists for the sum of maxima, but each wave
makespan's CDF is known exactly under the paper's model (Clone with r extra
attempts; the min of r+1 Pareto attempts is Pareto(t_min, beta(r+1))):

    F_wave(t) = [1 - (t_min/t)^(beta (r+1))]^M,  t >= t_min

so we compute PoCD = P(sum_w T_w <= D) by numerical convolution of the wave
makespan density on a uniform grid (exact up to discretization; validated
against Monte-Carlo in tests). The same machinery gives the multi-wave
expected machine time, so the paper's net-utility optimization extends to
wave scheduling unchanged: U_W(r) = lg(PoCD_W(r) - R_min) - theta*C*E_W[T].

Counterpart of `repro.core.multiwave`: the same float64 numpy, copied, on
the port's JobSpec (0-dim tensor fields, read with float()).
"""
from __future__ import annotations

import numpy as np

from .utility import JobSpec


def wave_cdf(t, t_min, beta, r, m):
    """CDF of one wave's makespan: max of m clone-raced tasks."""
    t = np.asarray(t, dtype=np.float64)
    be = beta * (r + 1.0)
    per_task = np.where(t >= t_min, 1.0 - (t_min / np.maximum(t, t_min)) ** be,
                        0.0)
    return per_task ** m


def multiwave_pocd(r, t_min, beta, D, N, n_slots, tau_kill=None,
                   grid: int = 4096):
    """P(sum of W wave makespans <= D) for the Clone strategy.

    Waves: W-1 full waves of n_slots tasks + a remainder wave. Computed by
    FFT-free direct convolution of the discretized wave densities (W is
    small; grid is fine enough that discretization error < MC noise).
    """
    n_full, rem = divmod(int(N), int(n_slots))
    waves = [n_slots] * n_full + ([rem] if rem else [])
    if not waves:
        return 1.0
    # grid over [0, D]: everything beyond D only matters as "fail"
    dt = D / grid
    dens = []
    for m in waves:
        cdf = wave_cdf(np.arange(grid + 1) * dt, t_min, beta, r, m)
        dens.append(np.diff(cdf))          # mass per cell, mass>D implicit
    acc = dens[0]
    for d in dens[1:]:
        acc = np.convolve(acc, d)[:grid]   # truncate: tail mass = failure
    return float(np.sum(acc))


def multiwave_cost(r, t_min, beta, N, tau_kill):
    """E[machine time]: per-task cost is wave-independent under Clone
    (Thm 2 applies to each task regardless of start time)."""
    nb = beta * (r + 1.0)
    return N * (r * tau_kill + t_min * nb / (nb - 1.0))


def multiwave_utility(r, job: JobSpec, n_slots, theta=None):
    """Net utility with wave scheduling (paper Eq. 23 with PoCD_W)."""
    theta = float(job.theta) if theta is None else theta
    R = multiwave_pocd(r, float(job.t_min), float(job.beta), float(job.D),
                       int(job.N), n_slots)
    E = multiwave_cost(r, float(job.t_min), float(job.beta), float(job.N),
                       float(job.tau_kill))
    gap = R - float(job.R_min)
    if gap <= 0:
        return -np.inf
    return float(np.log10(gap) - theta * float(job.C) * E)


def solve_multiwave(job: JobSpec, n_slots, r_max: int = 16):
    """Optimal r under wave scheduling (exhaustive — W makes U non-concave)."""
    best_r, best_u = 0, -np.inf
    for r in range(r_max):
        u = multiwave_utility(r, job, n_slots)
        if u > best_u:
            best_r, best_u = r, u
    return best_r, best_u
