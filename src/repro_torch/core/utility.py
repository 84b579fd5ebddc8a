"""JobSpec and name-keyed closed-form dispatch; counterpart of
`repro.core.utility`.

U(r) = lg(R(r) - R_min) - theta C E[T](r), -inf where R(r) <= R_min. The
registry import is function-local: `repro_torch.strategies` imports this
package's leaf math.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device


class JobSpec(NamedTuple):
    """Everything Algorithm 1 needs per job: ten f32 tensors of one shape."""
    t_min: torch.Tensor
    beta: torch.Tensor
    D: torch.Tensor
    N: torch.Tensor
    tau_est: torch.Tensor
    tau_kill: torch.Tensor
    phi_est: torch.Tensor         # average straggler progress at tau_est
    C: torch.Tensor               # VM price per unit machine time
    theta: torch.Tensor           # PoCD / cost tradeoff factor
    R_min: torch.Tensor           # SLA floor on PoCD

    @classmethod
    def make(cls, t_min, beta, D, N, tau_est=None, tau_kill=None,
             phi_est=0.5, C=1.0, theta=1e-4, R_min=0.0, *,
             device=None) -> "JobSpec":
        """One job's spec as 0-dim f32 tensors on `device` (default the
        card). tau_est defaults to 0.3 t_min (the paper's Table I) and
        tau_kill to tau_est + 0.5 t_min, both computed in f32."""
        dev = resolve_device(device)

        def f(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        t_min = f(t_min)
        tau_est = 0.3 * t_min if tau_est is None else f(tau_est)
        tau_kill = tau_est + 0.5 * t_min if tau_kill is None else f(tau_kill)
        return cls(t_min, f(beta), f(D), f(N), tau_est, tau_kill,
                   f(phi_est), f(C), f(theta), f(R_min))


def jobspec_to(job: JobSpec, device) -> JobSpec:
    return JobSpec(*(x.to(device) for x in job))


def pocd_of(strategy: str, r, job: JobSpec):
    from ..strategies import get, pocd_of_spec
    return pocd_of_spec(get(strategy), r, job)


def cost_of(strategy: str, r, job: JobSpec):
    from ..strategies import cost_of_spec, get
    return cost_of_spec(get(strategy), r, job)


def utility(strategy: str, r, job: JobSpec):
    from ..strategies import get, utility_of
    return utility_of(get(strategy), r, job)


def gamma(strategy: str, job: JobSpec):
    """Thm-8 concavity threshold of the named strategy's PoCD."""
    from ..strategies import get
    spec = get(strategy)
    if spec.gamma is None:
        raise ValueError(f"strategy {strategy!r} has no concavity threshold "
                         f"(Algorithm 1's gradient phase needs one)")
    return spec.gamma(job)
