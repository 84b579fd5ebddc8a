"""Pareto-tail telemetry: rolling duration windows with online tail fits;
counterpart of `repro.obs.tail`.

`TailWindow` keeps a `runtime.telemetry.DurationWindow` and refits it:
the Pareto MLE (t_min, beta) and the Hill tail index over the top-k order
statistics, in float64 numpy on the host (the reference's closed forms).
`TailRegistry` names the windows; `TailGovernor` is the observe -> refit
-> re-solve hook of the online serving loop (`repro_torch.serve`): every
`cadence` observations it refits and re-solves Algorithm 1 for the best
(strategy, r*) through the port's `core.solve_grid` on `device` (default
the card: the grid-solve kernel, `kernels/csrc/grid_solve.cu`).
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional

import numpy as np

from ..runtime.telemetry import DurationWindow

__all__ = ["TailFit", "TailWindow", "TailRegistry", "TailGovernor"]


class TailFit(NamedTuple):
    """One refit of a window's Pareto tail."""
    t_min: float      # MLE scale (window minimum)
    beta: float       # MLE tail index
    beta_hill: float  # Hill estimate over the top-k order statistics
    n: int            # samples in the window at fit time
    k: int            # order statistics the Hill estimate used


class TailWindow:
    """A rolling DurationWindow plus its online tail diagnostics."""

    def __init__(self, capacity: int = 512, hill_frac: float = 0.1):
        self.window = DurationWindow(capacity=capacity)
        self.hill_frac = float(hill_frac)
        self.n_observed = 0          # lifetime count (not capped)
        self.last_fit: Optional[TailFit] = None

    def observe(self, seconds: float) -> None:
        self.window.record(seconds)
        self.n_observed += 1

    def __len__(self) -> int:
        return len(self.window)

    def quantile(self, q) -> float:
        """Empirical quantile(s) of the current window."""
        xs = self.window.snapshot()
        if not xs:
            raise ValueError("quantile of an empty window")
        return float(np.quantile(np.asarray(xs, np.float64), q))

    def fit(self) -> TailFit:
        """Refit (t_min, beta) by MLE + the Hill index on the top-k."""
        xs = np.asarray(self.window.snapshot(), np.float64)
        if xs.size < 2:
            raise ValueError(f"tail fit needs >= 2 samples, have {xs.size}")
        # the MLE in closed form, in float64 numpy on the host
        t_min = float(xs.min())
        logs = np.log(np.maximum(xs, 1e-30) / max(t_min, 1e-30))
        beta = float(np.clip(xs.size / max(logs.sum(), 1e-9), 1.01, 20.0))
        k = int(np.clip(math.ceil(self.hill_frac * xs.size), 1, xs.size - 1))
        srt = np.sort(xs)
        top, x_k1 = srt[-k:], srt[-(k + 1)]
        beta_hill = float(k / max(np.log(top / max(x_k1, 1e-30)).sum(), 1e-9))
        self.last_fit = TailFit(t_min=t_min, beta=beta,
                                beta_hill=beta_hill, n=int(xs.size), k=k)
        return self.last_fit


class TailRegistry:
    """Named rolling tail windows — the runtime's duration telemetry hub.

    `observe(name, x)` creates the window on first use; `refit(name)`
    returns a TailFit and notifies any subscribed callbacks (the governor
    hook below subscribes itself). Thread-safe like the Telemetry it
    generalizes.
    """

    def __init__(self, capacity: int = 512, hill_frac: float = 0.1):
        self.capacity = capacity
        self.hill_frac = hill_frac
        self.windows: dict[str, TailWindow] = {}
        self._subs: dict[str, list[Callable]] = {}
        self._lock = threading.Lock()

    def window(self, name: str) -> TailWindow:
        with self._lock:
            if name not in self.windows:
                self.windows[name] = TailWindow(capacity=self.capacity,
                                                hill_frac=self.hill_frac)
            return self.windows[name]

    def observe(self, name: str, seconds: float) -> None:
        self.window(name).observe(seconds)

    def refit(self, name: str) -> TailFit:
        fit = self.window(name).fit()
        for cb in self._subs.get(name, ()):
            cb(name, fit)
        return fit

    def subscribe(self, name: str, callback: Callable) -> None:
        """callback(name, TailFit) fires after every refit of `name`."""
        with self._lock:
            self._subs.setdefault(name, []).append(callback)

    def snapshot(self) -> dict:
        """{name: last TailFit or None} — for trace-summary attributes."""
        with self._lock:
            return {n: w.last_fit for n, w in self.windows.items()}


@dataclass
class TailGovernor:
    """observe -> refit Pareto -> re-solve r*, on a sample-count cadence.

    The minimal online loop Chronos' scheduler needs: feed it task
    durations as they complete; every `cadence` observations it refits the
    window's Pareto tail, rebuilds the JobSpec against the configured
    deadline, and re-solves Algorithm 1 over the registered Chronos
    strategies. `decision` always holds the latest (strategy, r*)
    Solution; `on_resolve` (if set) fires with each fresh one. The online
    serving loop (`repro_torch.serve.serve_trace(refit_every=...)`) is the
    production consumer: probe-request completions drive `observe`, with
    cadence = probes-per-epoch so each re-solve lands exactly on an epoch
    boundary and governs the next epoch's hedging.
    """
    deadline: float
    n_tasks: int
    theta: float = 1e-4
    price: float = 1.0
    r_min: float = 0.0
    tau_est_frac: float = 0.3
    tau_kill_gap_frac: float = 0.5
    phi_est: float = 0.25
    cadence: int = 64           # observations between re-solves
    min_samples: int = 8
    max_r: int = 8
    strategies: Optional[tuple] = None
    registry: TailRegistry = field(default_factory=TailRegistry)
    window_name: str = "task"
    on_resolve: Optional[Callable] = None
    device: object = None       # where the re-solve runs (None: the card)

    def __post_init__(self):
        self.decision = None
        self.last_fit: Optional[TailFit] = None
        self._since_resolve = 0

    def observe(self, seconds: float):
        """Record one duration; returns the fresh Solution on re-solve
        ticks, else None."""
        self.registry.observe(self.window_name, seconds)
        self._since_resolve += 1
        win = self.registry.window(self.window_name)
        if (len(win) >= self.min_samples
                and self._since_resolve >= self.cadence):
            return self.resolve()
        return None

    def resolve(self):
        """Force a refit + Algorithm-1 re-solve now."""
        from ..core import JobSpec, solve_grid
        self._since_resolve = 0
        fit = self.registry.refit(self.window_name)
        self.last_fit = fit
        if self.deadline <= fit.t_min * 1.05:
            return self.decision   # deadline below the observed floor
        spec = JobSpec.make(
            t_min=fit.t_min, beta=fit.beta, D=self.deadline, N=self.n_tasks,
            tau_est=self.tau_est_frac * fit.t_min,
            tau_kill=(self.tau_est_frac + self.tau_kill_gap_frac)
            * fit.t_min,
            phi_est=self.phi_est, C=self.price, theta=self.theta,
            R_min=self.r_min, device=self.device)
        strategies = self.strategies
        if strategies is None:
            from ..strategies import names
            strategies = names(kind="chronos")
        best = None
        for s in strategies:
            sol = solve_grid(s, spec, r_max=self.max_r + 1,
                             device=self.device)
            if best is None or sol.utility > best.utility:
                best = sol
        self.decision = best
        if self.on_resolve is not None:
            self.on_resolve(best, fit)
        return best
