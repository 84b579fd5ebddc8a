"""One config, one entry point; counterpart of `repro.api`.

The simulator's entry points (`run_all`, `run_cluster`, `run_serve` and
the fleet's) each take the same sprawl of keywords. `RunConfig` holds
them in one frozen dataclass, with the reference's fields and defaults,
and `simulate` routes a run by it:

    from repro_torch import RunConfig, simulate
    outs, r_min = simulate(Philox(0), "flash-crowd",
                           cfg=RunConfig(chunk_jobs=4096))

  flat      `sim.runner.run_all` (its fleet, chunked and chaos variants
            included: run_all routes on devices/mesh/chunk_jobs/chaos/
            checkpoint/resume itself)
  capacity  `cluster.engine.run_cluster` when a finite-capacity knob is
            set (slots/discipline/passes/governor/admission/
            collect_metrics)
  serve     `serve.run_serve` when `serve=True` or a serving knob is set

Every route returns the backend's `(outs, r_min)` and equals calling it
directly bit for bit: the facade only forwards. `device` is a keyword of
`simulate`, not a field: where a run executes is not part of what it
computes.

Passing the old entry-point keywords straight to
`simulate(source, jobs, p, chunk_jobs=4096)` still works: they fold into
the config with a DeprecationWarning; an unknown keyword raises
TypeError.

This module imports only the standard library at module level and each
backend inside `simulate`, so `from repro_torch import RunConfig` loads
no simulator.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any, Optional, Sequence

__all__ = ["RunConfig", "simulate"]

_PATHS = ("auto", "flat", "capacity", "serve")

#: capacity-engine knobs whose non-default value routes to run_cluster
_CAPACITY_FIELDS = ("slots", "discipline", "passes", "governor",
                    "admission", "collect_metrics")
#: serving knobs whose non-default value routes to run_serve
_SERVE_FIELDS = ("serve", "window", "refit_every", "probe_every",
                 "r_override")


@dataclass(frozen=True)
class RunConfig:
    """Everything the run entry points take as keywords.

    Field groups (all optional; the zero config is a plain `run_all`):

    policy      theta, strategies, r_min_from_ns, max_r, oracle, reps,
                budget (the joint budget solve, repro_torch.coupled)
    capacity    slots, discipline, passes, governor, admission,
                collect_metrics             -> routes to run_cluster
    fleet       devices, mesh, block_jobs, chunk_jobs
    robustness  chaos, checkpoint, resume (repro_torch.chaos)
    serving     serve, window, refit_every, probe_every, r_override
                                            -> routes to run_serve
    path        "auto" (route by the groups above) or an explicit
                "flat" | "capacity" | "serve"
    """

    # -- policy (Algorithm 1 / Monte Carlo) -------------------------------
    theta: float = 1e-4
    strategies: Optional[Sequence[str]] = None
    r_min_from_ns: bool = True
    max_r: int = 8
    oracle: bool = True
    reps: int = 1
    #: shared priced machine-time cap sum(C * E[T]) <= budget, solved by
    #: the joint optimizer; None = independent per-job solves
    budget: Optional[float] = None
    # -- finite capacity (repro_torch.cluster) ----------------------------
    slots: Optional[int] = None
    discipline: str = "fifo"
    passes: int = 2
    governor: Optional[Any] = None        # cluster.GovernorConfig
    admission: Optional[Any] = None       # cluster.AdmissionConfig
    collect_metrics: bool = False
    # -- fleet streaming (repro_torch.fleet) ------------------------------
    devices: Optional[int] = None
    mesh: Optional[Any] = None
    block_jobs: int = 64
    chunk_jobs: Optional[int] = None
    # -- robustness (repro_torch.chaos) -----------------------------------
    chaos: Optional[Any] = None           # chaos.FaultPlan
    checkpoint: Optional[Any] = None      # chaos.CheckpointConfig or dir
    resume: bool = False
    # -- online serving (repro_torch.serve) -------------------------------
    serve: bool = False
    window: int = 256
    refit_every: Optional[int] = None
    probe_every: int = 8
    r_override: Optional[int] = None
    # -- routing override -------------------------------------------------
    path: str = "auto"

    def replace(self, **changes) -> "RunConfig":
        return dataclasses.replace(self, **changes)

    def _differs(self, names) -> tuple:
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        return tuple(n for n in names if getattr(self, n) != defaults[n])

    def resolve_path(self) -> str:
        """The backend this config routes to: "flat", "capacity" or
        "serve"."""
        if self.path != "auto":
            if self.path not in _PATHS:
                raise ValueError(f"unknown path {self.path!r}; "
                                 f"expected one of {_PATHS}")
            return self.path
        if self.serve or self._differs(_SERVE_FIELDS):
            return "serve"
        if self._differs(_CAPACITY_FIELDS):
            return "capacity"
        return "flat"


#: the legacy keywords simulate() folds into the config: exactly the
#: fields, so a typo fails instead of minting a field
_LEGACY_KWARGS = frozenset(f.name for f in dataclasses.fields(RunConfig))


def simulate(source, jobs, params=None, cfg: Optional[RunConfig] = None,
             *, device=None, **legacy):
    """Run the configured pipeline on `device` (default the card);
    returns (outs, r_min).

    source: the uniform source every strategy draws through
        (`sim.draws.Philox`); per-strategy streams are keyed inside the
        backend by registry index, as always.
    jobs: a JobSet, a WorkloadTrace, a RequestTrace (serving) or a
        workload scenario's name.
    params: a SimParams (None = defaults).
    cfg: a RunConfig (None = a plain run_all).
    **legacy: the old entry-point keywords, folded into `cfg` with a
        DeprecationWarning.
    """
    if cfg is None:
        cfg = RunConfig()
    if legacy:
        unknown = set(legacy) - _LEGACY_KWARGS
        if unknown:
            raise TypeError(
                f"simulate() got unexpected keyword(s) {sorted(unknown)}; "
                f"RunConfig fields: {sorted(_LEGACY_KWARGS)}")
        warnings.warn(
            "passing run keywords to simulate() directly is deprecated; "
            f"use cfg=RunConfig({', '.join(sorted(legacy))}=...) instead",
            DeprecationWarning, stacklevel=2)
        cfg = cfg.replace(**legacy)

    if params is None:
        from .sim import SimParams
        params = SimParams()
    path = cfg.resolve_path()
    strategies = (None if cfg.strategies is None
                  else tuple(cfg.strategies))

    if path == "serve":
        if cfg.budget is not None:
            raise ValueError(
                "budget= is an offline (flat/capacity) knob: the joint "
                "solve needs the whole trace's grids up front, which an "
                "online request stream cannot provide; drop budget or "
                "set path explicitly")
        from .serve import run_serve
        return run_serve(
            source, jobs, params, theta=cfg.theta, strategies=strategies,
            r_min_from_ns=cfg.r_min_from_ns, max_r=cfg.max_r,
            oracle=cfg.oracle, window=cfg.window,
            refit_every=cfg.refit_every, probe_every=cfg.probe_every,
            r_override=cfg.r_override, mesh=cfg.mesh, devices=cfg.devices,
            device=device)
    if path == "capacity":
        from .cluster.engine import run_cluster
        return run_cluster(
            source, jobs, params, slots=cfg.slots, theta=cfg.theta,
            strategies=strategies, r_min_from_ns=cfg.r_min_from_ns,
            max_r=cfg.max_r, oracle=cfg.oracle,
            discipline=cfg.discipline, passes=cfg.passes,
            governor=cfg.governor, admission=cfg.admission,
            reps=cfg.reps, collect_metrics=cfg.collect_metrics,
            budget=cfg.budget, device=device, devices=cfg.devices,
            mesh=cfg.mesh, chunk_jobs=cfg.chunk_jobs, chaos=cfg.chaos,
            checkpoint=cfg.checkpoint, resume=cfg.resume)
    # flat (run_all routes its own fleet and chaos variants)
    if not cfg.oracle:
        raise ValueError(
            "oracle=False is a capacity/serve knob; the flat Monte-Carlo "
            "path always resolves stragglers exactly (run_all has no "
            "oracle parameter): set slots/serve or path explicitly")
    from .sim.runner import run_all
    return run_all(
        source, jobs, params, theta=cfg.theta, strategies=strategies,
        r_min_from_ns=cfg.r_min_from_ns, max_r=cfg.max_r, reps=cfg.reps,
        budget=cfg.budget, device=device, devices=cfg.devices,
        mesh=cfg.mesh, block_jobs=cfg.block_jobs,
        chunk_jobs=cfg.chunk_jobs, chaos=cfg.chaos,
        checkpoint=cfg.checkpoint, resume=cfg.resume)
