"""JobSpec and name-keyed closed-form dispatch; counterpart of
`repro.core.utility`.

U(r) = lg(R(r) - R_min) - theta C E[T](r), -inf where R(r) <= R_min. The
registry import is function-local: `repro_torch.strategies` imports this
package's leaf math.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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
