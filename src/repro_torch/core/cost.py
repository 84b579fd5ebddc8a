"""Expected machine time E[T] per strategy, paper Theorems 2, 4, 6.

Counterpart of `repro.core.cost`, same arithmetic in the same order. The
Thm-4 integral I(r) = int_{D-tau}^inf (D/(w+tau))^beta (t_min/w)^(beta r) dw
is a 128-node Gauss-Legendre quadrature after w = (D - tau)/u, u in (0, 1].
"""
from __future__ import annotations

import numpy as np
import torch

from .pareto import truncated_mean_below

# The port's own copy of the reference's constants: leggauss(128) mapped
# from [-1, 1] to (0, 1), rounded to f32. The CUDA grid solve takes these
# same tensors as operands.
_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(128)
GL_U = torch.from_numpy(((_GL_NODES + 1.0) / 2.0).astype(np.float32))
GL_W = torch.from_numpy((_GL_WEIGHTS / 2.0).astype(np.float32))


def _p_straggler(t_min, beta, D):
    """P(T_{j,1} > D) = (t_min / D)^beta."""
    return torch.pow(t_min / D, beta)


def cost_clone(r, t_min, beta, D, N, tau_kill):
    """Thm 2: E[T] = N (r tau_kill + t_min beta(r+1) / (beta(r+1) - 1))."""
    nb = beta * (r + 1.0)
    e_win = t_min * nb / (nb - 1.0)
    return N * (r * tau_kill + e_win)


def _srestart_integral(r, t_min, beta, D, tau_est):
    """I(r) by quadrature over the trailing node axis."""
    u = GL_U.to(t_min.device)
    gl_w = GL_W.to(t_min.device)
    r_, t_, b_, D_, tau_ = (x[..., None] for x in (r, t_min, beta, D,
                                                     tau_est))
    Dm_ = torch.maximum(D_ - tau_, t_)
    w_ = Dm_ / u
    f = torch.pow(D_ / (w_ + tau_), b_) * torch.pow(t_ / w_, b_ * r_)
    # dw = Dm / u^2 du
    return torch.sum(f * (Dm_ / (u * u)) * gl_w, dim=-1)


def _srestart_cond_above(r, t_min, beta, D, tau_est, tau_kill):
    """E(T_j | T_{j,1} > D), Eq. (16), with D - tau clamped at t_min and
    t_min^(br) / Dm^(br-1) taken in log space (the powers overflow f32)."""
    br = beta * r
    Dm = torch.maximum(D - tau_est, t_min)
    head = tau_est + r * (tau_kill - tau_est)
    ratio = torch.exp(br * torch.log(t_min / Dm) + torch.log(Dm))
    part1 = (t_min - ratio) / (br - 1.0)
    part2 = _srestart_integral(r, t_min, beta, D, tau_est)
    return head + part1 + part2 + t_min


def cost_srestart(r, t_min, beta, D, N, tau_est, tau_kill):
    """Thm 4: E_S-Restart[T], N tasks."""
    p_s = _p_straggler(t_min, beta, D)
    e_fast = truncated_mean_below(t_min, beta, D)
    e_slow = _srestart_cond_above(r, t_min, beta, D, tau_est, tau_kill)
    return N * (e_fast * (1.0 - p_s) + e_slow * p_s)


def cost_sresume(r, t_min, beta, D, N, tau_est, tau_kill, phi_est):
    """Thm 6: E_S-Resume[T], N tasks; the winner bills
    t_min + t_min (1-phi)^(beta(r+1)) / (beta(r+1) - 1)."""
    p_s = _p_straggler(t_min, beta, D)
    e_fast = truncated_mean_below(t_min, beta, D)
    nb = beta * (r + 1.0)
    e_win = t_min + t_min * torch.pow(1.0 - phi_est, nb) / (nb - 1.0)
    e_slow = tau_est + r * (tau_kill - tau_est) + e_win
    return N * (e_fast * (1.0 - p_s) + e_slow * p_s)
