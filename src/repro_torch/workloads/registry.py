"""Named scenario presets; counterpart of `repro.workloads.registry`.

Every scenario is a declarative `Scenario` (class mixture, arrival
process, default size); `make_jobset("diurnal-burst", device=...)`
resolves it to a JobSet, and `sim.runner.run_all` accepts the names
directly. The seven built-ins carry the reference's exact parameters:
``paper-hadoop`` (Section VII.B, calibrated to `PAPER_TRACE_STATS`),
``heavy-tail``, ``diurnal-burst``, ``multi-tenant-sla``,
``flash-crowd``, ``pod-loss-flash-crowd`` and ``request-storm``.

A scenario's seed seeds the port's own draws
(`sim.draws.WorkloadPhilox`: Philox on the card, torch's CPU generator on
the CPU), so a name and seed give the same trace on every run on one
kind of device, but not the reference's trace, which comes from
`jax.random`. To run the reference's trace, load the `.npz` it saved
(`traces.load_trace`).

`register` adds user scenarios at runtime (name-keyed, overwrite refused
unless replace=True).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

from ..obs import trace as obs_trace
from .generators import JobClass
from .traces import WorkloadTrace, synthesize, to_jobset


class Scenario(NamedTuple):
    name: str
    description: str
    classes: Tuple[JobClass, ...]
    arrival: str = "poisson"          # generators.ARRIVAL_PROCESSES key
    arrival_kw: Optional[dict] = None  # None = process defaults
    n_jobs: int = 600                 # default size; callers may override
    hours: float = 30.0               # sets the long-run job rate
    seed: int = 0
    # declarative fault schedule as plain event dicts, lowered by
    # `chaos.from_faults` (no chaos import here). None = no faults.
    faults: Optional[Tuple[dict, ...]] = None


# Three-class mix calibrated to PAPER_TRACE_STATS: weighted mean tasks
# 0.55*40 + 0.35*400 + 0.10*2000 = 362 ~ 370, beta spanning [1.1, 2.0].
_PAPER_CLASSES = (
    JobClass(name="interactive", weight=0.55, mean_tasks=40.0,
             sigma_tasks=0.8, t_min_range=(8.0, 12.0),
             beta_range=(1.4, 2.0), deadline_ratio=2.0),
    JobClass(name="batch", weight=0.35, mean_tasks=400.0,
             sigma_tasks=1.0, t_min_range=(8.0, 15.0),
             beta_range=(1.2, 1.8), deadline_ratio=2.0),
    JobClass(name="analytics", weight=0.10, mean_tasks=2000.0,
             sigma_tasks=1.2, t_min_range=(10.0, 15.0),
             beta_range=(1.1, 1.5), deadline_ratio=2.5),
)

SCENARIOS = {}


def register(scenario: Scenario, replace: bool = False) -> Scenario:
    if scenario.name in SCENARIOS and not replace:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    SCENARIOS[scenario.name] = scenario
    return scenario


register(Scenario(
    name="paper-hadoop",
    description="Sec VII.B Google/Hadoop-trace mix, Poisson arrivals",
    classes=_PAPER_CLASSES,
    n_jobs=2700,
))

register(Scenario(
    name="heavy-tail",
    description="beta ~ 1 stress mix: stragglers dominate, speculation "
                "is most valuable",
    classes=(
        JobClass(name="short-fat", weight=0.7, mean_tasks=60.0,
                 sigma_tasks=1.8, t_min_range=(5.0, 10.0),
                 beta_range=(1.05, 1.25), deadline_ratio=3.0),
        JobClass(name="long-fat", weight=0.3, mean_tasks=600.0,
                 sigma_tasks=2.0, t_min_range=(8.0, 15.0),
                 beta_range=(1.05, 1.15), deadline_ratio=4.0),
    ),
))

register(Scenario(
    name="diurnal-burst",
    description="paper mix on a sinusoidal NHPP (day/night swing)",
    classes=_PAPER_CLASSES,
    arrival="diurnal",
    arrival_kw={"amplitude": 0.85, "period": 86400.0},
    hours=48.0,
))

register(Scenario(
    name="multi-tenant-sla",
    description="gold/silver/bronze tenants: per-tier theta, deadlines, "
                "prices -> per-class r*",
    classes=(
        JobClass(name="gold", weight=0.2, mean_tasks=200.0,
                 sigma_tasks=0.9, t_min_range=(8.0, 12.0),
                 beta_range=(1.2, 1.8), deadline_ratio=1.5,
                 theta_scale=0.2, price=2.0),
        JobClass(name="silver", weight=0.5, mean_tasks=300.0,
                 sigma_tasks=1.0, t_min_range=(8.0, 15.0),
                 beta_range=(1.2, 1.8), deadline_ratio=2.0,
                 theta_scale=1.0, price=1.0),
        JobClass(name="bronze", weight=0.3, mean_tasks=400.0,
                 sigma_tasks=1.1, t_min_range=(8.0, 15.0),
                 beta_range=(1.1, 1.6), deadline_ratio=3.0,
                 theta_scale=5.0, price=0.5),
    ),
))

register(Scenario(
    name="flash-crowd",
    description="batch-Poisson crowds (~25 jobs/burst) of interactive "
                "jobs",
    classes=(
        JobClass(name="crowd", weight=0.8, mean_tasks=50.0,
                 sigma_tasks=0.7, t_min_range=(5.0, 10.0),
                 beta_range=(1.3, 2.0), deadline_ratio=1.8),
        JobClass(name="background", weight=0.2, mean_tasks=500.0,
                 sigma_tasks=1.2, t_min_range=(8.0, 15.0),
                 beta_range=(1.1, 1.6), deadline_ratio=3.0),
    ),
    arrival="batch",
    arrival_kw={"mean_batch": 25.0},
    hours=12.0,
))


register(Scenario(
    name="pod-loss-flash-crowd",
    description="flash-crowd arrivals under a pod loss: 2 devices die at "
                "chunk 2 (2 more at chunk 5), a transient chunk failure "
                "retries at chunk 3 — the elastic-recovery benchmark "
                "scenario",
    classes=(
        JobClass(name="crowd", weight=0.8, mean_tasks=50.0,
                 sigma_tasks=0.7, t_min_range=(5.0, 10.0),
                 beta_range=(1.3, 2.0), deadline_ratio=1.8),
        JobClass(name="background", weight=0.2, mean_tasks=500.0,
                 sigma_tasks=1.2, t_min_range=(8.0, 15.0),
                 beta_range=(1.1, 1.6), deadline_ratio=3.0),
    ),
    arrival="batch",
    arrival_kw={"mean_batch": 25.0},
    hours=12.0,
    faults=(
        {"kind": "device_loss", "chunk": 2, "count": 2},
        {"kind": "chunk_fail", "chunk": 3, "count": 1},
        {"kind": "device_loss", "chunk": 5, "count": 2},
    ),
))


register(Scenario(
    name="request-storm",
    description="online-serving stream: sub-second single-unit requests, "
                "diurnal NHPP traffic, interactive/standard/batch SLA "
                "tiers (repro.serve's default scenario)",
    classes=(
        JobClass(name="interactive", weight=0.3, mean_tasks=1.0,
                 sigma_tasks=0.0, t_min_range=(0.08, 0.15),
                 beta_range=(1.2, 1.8), deadline_ratio=2.0,
                 theta_scale=0.3, price=2.0),
        JobClass(name="standard", weight=0.55, mean_tasks=1.0,
                 sigma_tasks=0.0, t_min_range=(0.10, 0.30),
                 beta_range=(1.2, 2.0), deadline_ratio=2.5,
                 theta_scale=1.0, price=1.0),
        JobClass(name="batch", weight=0.15, mean_tasks=1.0,
                 sigma_tasks=0.0, t_min_range=(0.20, 0.60),
                 beta_range=(1.1, 1.6), deadline_ratio=4.0,
                 theta_scale=3.0, price=0.5),
    ),
    arrival="diurnal",
    arrival_kw={"amplitude": 0.7, "period": 86400.0},
    n_jobs=20000,
    hours=24.0,
))


def list_scenarios() -> dict:
    """name -> one-line description of every registered scenario."""
    return {name: s.description for name, s in sorted(SCENARIOS.items())}


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        known = ", ".join(sorted(SCENARIOS))
        raise KeyError(f"unknown scenario {name!r}; registered: {known}")
    return SCENARIOS[name]


def make_trace(name: str, n_jobs: Optional[int] = None,
               seed: Optional[int] = None, *, device=None) -> WorkloadTrace:
    """Synthesize the named scenario's trace on `device` (default the
    card); size and seed overridable."""
    s = get_scenario(name)
    n = s.n_jobs if n_jobs is None else n_jobs
    with obs_trace.span("workloads.synthesize", scenario=name, n_jobs=n):
        return synthesize(
            s.classes, n_jobs=n, seed=s.seed if seed is None else seed,
            arrival=s.arrival, hours=s.hours, arrival_kw=s.arrival_kw,
            device=device)


def make_jobset(name: str, n_jobs: Optional[int] = None,
                seed: Optional[int] = None, *, device=None):
    """Resolve a scenario name to a JobSet on `device` (default the card);
    `to_jobset` records the workloads.jobset_build span."""
    return to_jobset(make_trace(name, n_jobs=n_jobs, seed=seed,
                                device=device), device=device)
