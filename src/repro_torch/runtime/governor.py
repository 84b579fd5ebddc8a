"""StepGovernor: the Chronos optimizer running live inside the training
loop; counterpart of `repro.runtime.governor`.

Fits Pareto(t_min, beta) to observed task / shard durations (MLE over a
telemetry window), builds a JobSpec for the next step's N tasks against
the step deadline, solves for (strategy, r*), and exposes the decision
to the data pipeline, the SpeculativeTaskRunner and the backup-shard
mask.

The durations are host floats, so the fit runs on the host; the solve
runs on `device` (default the card), where `solve_grid` launches the
grid-solve kernel once per strategy and reads its four results back.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core import JobSpec, Solution, fit_mle, solve
from ..device import resolve_device
from .telemetry import Telemetry

#: the counter bumped by each decision that solves (past warm-up)
WARM_DECISIONS = "governor.warm_decisions"


@dataclass
class GovernorConfig:
    deadline: float                 # per-step (job) deadline, seconds
    n_tasks: int                    # shards per step
    theta: float = 1e-4             # PoCD/cost tradeoff
    price: float = 1.0              # chip-second price
    r_min: float = 0.0              # SLA floor
    tau_est_frac: float = 0.3
    tau_kill_gap_frac: float = 0.5
    phi_est: float = 0.25
    min_samples: int = 8            # before this, fall back to defaults
    strategies: Optional[tuple] = None  # None = every registered Chronos
    #                                     strategy (names(kind="chronos"))
    max_r: int = 8


class StepGovernor:
    def __init__(self, cfg: GovernorConfig,
                 telemetry: Optional[Telemetry] = None,
                 window: str = "task", *, device=None):
        self.cfg = cfg
        self.telemetry = telemetry or Telemetry()
        self.window_name = window
        self.device = resolve_device(device)
        self.last: Optional[Solution] = None
        self.last_params = None
        self.last_spec: Optional[JobSpec] = None

    def observe(self, seconds: float):
        self.telemetry.window(self.window_name).record(seconds)

    def fit(self):
        xs = self.telemetry.window(self.window_name).snapshot()
        if len(xs) < self.cfg.min_samples:
            return None
        fit = fit_mle(torch.tensor(xs, dtype=torch.float32))
        self.last_params = (float(fit.t_min), float(fit.beta))
        return self.last_params

    def jobspec(self) -> Optional[JobSpec]:
        params = self.fit()
        if params is None:
            return None
        t_min, beta = params
        c = self.cfg
        if c.deadline <= t_min * 1.05:
            # deadline below the observed floor: speculation cannot help
            return None
        return JobSpec.make(
            t_min=t_min, beta=beta, D=c.deadline, N=c.n_tasks,
            tau_est=c.tau_est_frac * t_min,
            tau_kill=(c.tau_est_frac + c.tau_kill_gap_frac) * t_min,
            phi_est=c.phi_est, C=c.price, theta=c.theta, R_min=c.r_min,
            device=self.device)

    def decide(self) -> Solution:
        """(strategy, r*) for the next step; r=0 / sresume before warm-up.
        Past warm-up, one `solve_grid` per strategy (on the card, one
        grid-solve launch each), counted under WARM_DECISIONS; the JobSpec
        it solved stays in `last_spec`."""
        spec = self.jobspec()
        if spec is None:
            self.last = Solution("sresume", 0, 0.0, 0.0, 0.0)
            return self.last
        self.last = solve(spec, self.cfg.strategies,
                          r_max=self.cfg.max_r + 1, device=self.device)
        self.last_spec = spec
        self.telemetry.bump(WARM_DECISIONS)
        return self.last

    def backup_mask(self, n_micro: int, n_backup: int,
                    failed: set) -> np.ndarray:
        """Weight mask for train_step: 1 for live shards, 0 for failed ones.

        n_backup over-provisioned shards exist beyond the nominal n_micro -
        n_backup; Clone semantics: whichever shards complete count."""
        mask = np.ones((n_micro,), np.float32)
        for i in failed:
            if 0 <= i < n_micro:
                mask[i] = 0.0
        return mask
