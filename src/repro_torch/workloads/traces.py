"""Columnar workload traces: schema, .npz files, synthesis; counterpart of
`repro.workloads.traces`.

A `WorkloadTrace` holds eight arrival-sorted per-job numpy columns and
the class-name table, as the reference's does, and `save_trace` /
`load_trace` use the reference's `.npz` layout, so a file written by
either package loads in the other. `synthesize` draws the columns on the
caller's device and copies them to the host once; `to_jobset` lowers a
trace to the flat JobSet the runner executes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..obs import trace as obs_trace
from ..sim.draws import WorkloadPhilox
from ..sim.trace import JobSet, build_jobset
from .generators import (JobClass, sample_arrivals, sample_classes,
                         sample_pareto_params, sample_task_counts)

# Trace-driven evaluation targets (paper Section VII.B): a Google-trace
# mix of 2700 jobs / ~1M tasks over 30 hours, per-job Pareto execution
# times with tail index in [1.1, 2.0], deadlines at 2x the mean task time.
PAPER_TRACE_STATS = {
    "n_jobs": 2700,
    "total_tasks": 1_000_000,
    "hours": 30.0,
    "mean_tasks": 370.0,
    "beta_range": (1.1, 2.0),
    "deadline_ratio": 2.0,
}

TRACE_COLUMNS = (
    "n_tasks", "t_min", "beta", "D", "arrival", "C", "theta_scale",
    "job_class",
)


class WorkloadTrace(NamedTuple):
    """Arrival-sorted per-job columns; the offline workload schema."""

    n_tasks: np.ndarray       # (J,) int32
    t_min: np.ndarray         # (J,) float32 Pareto scale
    beta: np.ndarray          # (J,) float32 Pareto tail index
    D: np.ndarray             # (J,) float32 relative deadline (s)
    arrival: np.ndarray       # (J,) float32 seconds from trace start
    C: np.ndarray             # (J,) float32 VM price
    theta_scale: np.ndarray   # (J,) float32 SLA-weight multiplier
    job_class: np.ndarray     # (J,) int32 index into class_names
    class_names: Tuple[str, ...]

    @property
    def n_jobs(self) -> int:
        return int(self.n_tasks.shape[0])

    @property
    def total_tasks(self) -> int:
        return int(self.n_tasks.sum())


def to_jobset(trace: WorkloadTrace, *, device=None) -> JobSet:
    """Lower a trace to the flat JobSet on `device` (default the card)."""
    with obs_trace.span("workloads.jobset_build", n_jobs=trace.n_jobs):
        return build_jobset(
            trace.n_tasks, trace.t_min, trace.beta, trace.D, trace.arrival,
            trace.C, job_class=trace.job_class,
            theta_scale=trace.theta_scale, device=device)


def save_trace(trace: WorkloadTrace, path) -> None:
    """Persist to one compressed .npz (columns + class-name table)."""
    np.savez_compressed(
        path,
        class_names=np.asarray(trace.class_names),
        **{c: getattr(trace, c) for c in TRACE_COLUMNS})


def load_trace(path) -> WorkloadTrace:
    with np.load(path, allow_pickle=False) as z:
        cols = {c: z[c] for c in TRACE_COLUMNS}
        names = tuple(str(s) for s in z["class_names"])
    return WorkloadTrace(class_names=names, **cols)


def synthesize(classes: Sequence[JobClass], n_jobs: int, seed: int = 0,
               arrival: str = "poisson", hours: float = 30.0,
               arrival_kw: Optional[dict] = None, *, source=None,
               device=None) -> WorkloadTrace:
    """Draw a WorkloadTrace from a class mixture and an arrival process on
    `device` (default the card).

    The long-run job rate is n_jobs / (hours * 3600) unless arrival_kw
    sets "rate". `source` hands out the variates (default
    `WorkloadPhilox(seed)`: the seed gives the port's own draws, not the
    reference's trace). Columns come back arrival-sorted, ties in the
    order the jobs were drawn.
    """
    if not classes:
        raise ValueError("need at least one JobClass")
    if n_jobs <= 0:
        raise ValueError(f"n_jobs must be positive, got {n_jobs}")
    dev = resolve_device(device)
    source = WorkloadPhilox(seed) if source is None else source
    cls = sample_classes(source, n_jobs, classes, device=dev)
    n_tasks = sample_task_counts(source, cls, classes)
    t_min, beta, D = sample_pareto_params(source, cls, classes)

    kw = dict(arrival_kw or {})
    rate = kw.pop("rate", n_jobs / (hours * 3600.0))
    arrivals = sample_arrivals(source, n_jobs, arrival, rate, device=dev,
                               **kw)

    order = torch.sort(arrivals, stable=True).indices
    c = cls.long()
    f32 = dict(dtype=torch.float32, device=dev)
    price = torch.tensor([float(k.price) for k in classes], **f32)[c]
    theta_scale = torch.tensor([float(k.theta_scale) for k in classes],
                               **f32)[c]
    cols = torch.stack([x[order].to(torch.float32) for x in
                        (t_min, beta, D, arrivals, price, theta_scale)])
    ints = torch.stack([n_tasks[order], cls[order]]).to(torch.int32)
    cols, ints = cols.cpu().numpy(), ints.cpu().numpy()
    return WorkloadTrace(
        n_tasks=ints[0], t_min=cols[0], beta=cols[1], D=cols[2],
        arrival=cols[3], C=cols[4], theta_scale=cols[5], job_class=ints[1],
        class_names=tuple(k.name for k in classes))


def summarize(trace: WorkloadTrace) -> dict:
    """The PAPER_TRACE_STATS-shaped summary of a trace (calibration
    check: compare against the target the scenario claims to match)."""
    span_h = float(trace.arrival.max() - trace.arrival.min()) / 3600.0
    mix = {
        name: float((trace.job_class == i).mean())
        for i, name in enumerate(trace.class_names)
    }
    return {
        "n_jobs": trace.n_jobs,
        "total_tasks": trace.total_tasks,
        "hours": span_h,
        "mean_tasks": float(trace.n_tasks.mean()),
        "beta_range": (float(trace.beta.min()), float(trace.beta.max())),
        "arrival_rate_per_s": trace.n_jobs / max(span_h * 3600.0, 1e-9),
        "class_mix": mix,
    }
