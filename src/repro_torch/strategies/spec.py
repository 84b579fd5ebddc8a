"""StrategySpec, the strategy registry, and the Algorithm-1 solve;
counterpart of `repro.strategies.spec`.

Registration order is public: `index_of` seeds each strategy's random
numbers (`sim.draws.Philox`), and the test's replay source derives the
reference's keys from it (`fold_in(key, index_of(name))`). The order must
therefore equal the reference's: hadoop_ns, hadoop_s, mantri, clone,
srestart, sresume, hedge, adaptive, clone_prop, clone_sjf.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

#: "chronos" strategies solve r* per job from closed forms; "baseline"
#: ones run at r = 0; "meta" ones solve r* over composed specs.
KINDS = ("baseline", "chronos", "meta")

#: the paper's closed-form families (Thms 1-6); the CUDA grid solve
#: evaluates these natively, in this order of ids
FORMS = ("clone", "srestart", "sresume")


class StrategySpec(NamedTuple):
    """One strategy's closures (jobs: JobSet, job: JobSpec, p: SimParams):

      draw(draw_u, jobs, r_task, choice_task, p, *, max_r, oracle)
          -> (completion (T,), machine (T,)); draw_u(name, shape) gives
          uniforms (`sim.draws`)
      log_task_fail(r, job) -> log P(one task misses D)    [optional]
      cost(r, job)          -> E[T] machine time per job   [optional]
      gamma(job)            -> Thm-8 concavity threshold   [optional]
      r_slope(job)          -> host float lower bound on the marginal
                               machine time of one extra attempt [optional]
      choose(r, job)        -> (J,) int32 sub-strategy id  [optional]
      tile_outcome(att, t_min, tau_est, tau_kill, D, r, *, phi)
          -> (completion, machine) (J, N) Monte-Carlo body of the
          `kernels.pocd_mc` mode of this name              [optional]
      allocate(job, U, cost, budget) -> (J,) int32 r per job [optional]
      build_table(draw_u, jobs, r_task, choice_task, p, *, max_r, oracle)
          -> AttemptTable: the capacity replay's lowering
          (`repro_torch.cluster`), drawing what `draw` draws, under the
          same names and shapes

    `race` marks strategies whose losing attempts hold their slot until
    the task completes (a kill timer, `hold_cap`, otherwise). `form`
    names the closed-form family of `log_task_fail`/`cost` (one of FORMS)
    for the CUDA grid solve; `components` names the registered
    sub-strategies a composite maximizes over, in `choose`-id order.
    """
    name: str
    kind: str
    detectable: bool          # straggler detection honours `oracle=False`
    draw: Callable
    log_task_fail: Optional[Callable] = None
    cost: Optional[Callable] = None
    gamma: Optional[Callable] = None
    r_slope: Optional[Callable] = None
    choose: Optional[Callable] = None
    tile_outcome: Optional[Callable] = None
    allocate: Optional[Callable] = None
    form: Optional[str] = None
    components: Optional[tuple] = None
    race: bool = False
    build_table: Optional[Callable] = None

    @property
    def optimized(self) -> bool:
        """Does Algorithm 1 solve a per-job r* for this strategy?"""
        return self.kind != "baseline"


_REGISTRY: dict[str, StrategySpec] = {}


def register(spec: StrategySpec) -> StrategySpec:
    if spec.kind not in KINDS:
        raise ValueError(f"unknown kind {spec.kind!r}; expected one of {KINDS}")
    if spec.optimized and (spec.log_task_fail is None or spec.cost is None):
        raise ValueError(f"strategy {spec.name!r} is kind={spec.kind!r} but "
                         f"lacks the closed forms Algorithm 1 needs")
    if spec.build_table is None:
        raise ValueError(f"strategy {spec.name!r} lacks the build_table "
                         f"lowering the capacity replay needs")
    if spec.form is not None and spec.form not in FORMS:
        raise ValueError(f"unknown closed-form family {spec.form!r}")
    if spec.components:
        missing = [n for n in spec.components if n not in _REGISTRY]
        if missing or spec.choose is None:
            raise ValueError(f"composite {spec.name!r} needs registered "
                             f"components and a choose closure")
    if spec.name in _REGISTRY:
        raise ValueError(f"strategy {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> StrategySpec:
    if name not in _REGISTRY:
        known = ", ".join(_REGISTRY)
        raise ValueError(f"unknown strategy {name!r}; registered: {known}")
    return _REGISTRY[name]


def names(kind: Optional[str] = None) -> tuple:
    """Registered names in registration order; `kind="optimized"` selects
    every strategy with a per-job r* solve."""
    if kind is None:
        return tuple(_REGISTRY)
    if kind == "optimized":
        return tuple(n for n, s in _REGISTRY.items() if s.optimized)
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")
    return tuple(n for n, s in _REGISTRY.items() if s.kind == kind)


def index_of(name: str) -> int:
    """Stable registration index of a strategy (its random-number slot)."""
    get(name)
    return list(_REGISTRY).index(name)


# ---------------------------------------------------------------------------
# Analytic lowering: job PoCD, net utility, the Algorithm-1 solve
# ---------------------------------------------------------------------------


def job_pocd(log_p_fail, N):
    from ..core.pocd import _job_pocd_from_log_fail
    return _job_pocd_from_log_fail(log_p_fail, N)


def pocd_of_spec(spec: StrategySpec, r, job):
    """Job-level PoCD R(r) from the spec's per-task closed form."""
    if spec.log_task_fail is None:
        raise ValueError(f"strategy {spec.name!r} has no analytic PoCD")
    return job_pocd(spec.log_task_fail(r, job), job.N)


def cost_of_spec(spec: StrategySpec, r, job):
    """Expected machine time E[T](r) from the spec's closed form."""
    if spec.cost is None:
        raise ValueError(f"strategy {spec.name!r} has no analytic cost")
    return spec.cost(r, job)


def utility_of(spec: StrategySpec, r, job):
    """U(r) = lg(R(r) - R_min) - theta C E[T]; -inf below the SLA floor."""
    R = pocd_of_spec(spec, r, job)
    E = cost_of_spec(spec, r, job)
    gap = R - job.R_min
    log_term = torch.where(gap > 0.0,
                           torch.log10(torch.clamp(gap, min=1e-30)),
                           -torch.inf)
    return log_term - job.theta * job.C * E


def solve_jobs(strategy: str, jobs, r_max: int, *, device=None):
    """Exact integer solve over r in {0, ..., r_max - 1} for a batched
    JobSpec, on `device` (default the card).

    Returns (r_opt i32, choice i32, utility, pocd, cost, sat i32), all
    (J,). `choice` is the composite's sub-strategy pick (zeros for pure
    specs); `sat` flags jobs whose argmax landed on the last grid point.
    On the card this is the CUDA kernel; on the CPU its plain version.
    """
    from ..core.utility import jobspec_to
    from ..device import resolve_device
    from ..kernels.grid_solve import grid_solve
    return grid_solve(get(strategy),
                      jobspec_to(jobs, resolve_device(device)), r_max)
