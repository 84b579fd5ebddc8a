"""Job-level metrics from per-task simulator outputs; counterpart of
`repro.sim.metrics`."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import to_host
from .trace import JobSet


class SimResult(NamedTuple):
    pocd: torch.Tensor           # scalar: fraction of jobs meeting D
    job_met: torch.Tensor        # (J,) bool (met frequency when reps > 1)
    job_completion: torch.Tensor  # (J,)
    job_cost: torch.Tensor       # (J,) machine-time * C
    mean_cost: torch.Tensor      # scalar


def _mean(x, dim=None):
    """sum / n, as jnp.mean computes it (torch's mean may round otherwise:
    R_min is read from Hadoop-NS's PoCD, so its last bit matters)."""
    n = x.numel() if dim is None else x.shape[dim]
    return (x.sum() if dim is None else x.sum(dim=dim)) / n


def segment_sum(x, jobs: JobSet):
    """Per-job sum of a flat per-task column, the same bits on every run.

    `job_id` is sorted, so a job's segment is its `n_tasks` contiguous
    rows; `segment_reduce` adds each segment in a fixed order and uses no
    atomics (`index_add_` would, and its last bits would vary on the
    card). unsafe: build_jobset guarantees sum(n_tasks) == len(x); the
    check would read the lengths back to the host."""
    return torch.segment_reduce(x, "sum", lengths=jobs.n_tasks, unsafe=True)


def scan_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D tensor, the same bits on the CPU and
    the card, run after run (`torch.cumsum` of floats on CUDA is not
    deterministic): doubling steps (Hillis-Steele), each one elementwise
    add."""
    out = x.clone()
    k = 1
    while k < out.shape[0]:
        out = torch.cat([out[:k], out[k:] + out[:-k]])
        k *= 2
    return out


def aggregate(jobs: JobSet, completion, machine) -> SimResult:
    """Segment max of completion and segment sum of machine time per job;
    both give the same bits on every run, on the card as on the CPU (the
    max is order-free, the sum is `segment_sum`)."""
    J = jobs.n_jobs
    job_completion = torch.full(
        (J,), -torch.inf, dtype=completion.dtype,
        device=completion.device).scatter_reduce_(
            0, jobs.job_id, completion, "amax")
    job_machine = segment_sum(machine, jobs)
    met = job_completion <= jobs.D
    cost = job_machine * jobs.C
    return SimResult(pocd=_mean(met.to(torch.float32)), job_met=met,
                     job_completion=job_completion, job_cost=cost,
                     mean_cost=_mean(cost))


def mean_over_reps(results) -> SimResult:
    """Monte-Carlo mean of per-replication results; bool job_met becomes a
    per-job met frequency in [0, 1]."""
    return SimResult(*(_mean(torch.stack([x.to(torch.float32)
                                          for x in field]), dim=0)
                       for field in zip(*results)))


def class_summary(jobs: JobSet, result: SimResult) -> dict:
    """Per-workload-class breakdown of a SimResult, on the host in
    float64: {class_id: {"n_jobs", "pocd", "mean_cost",
    "mean_completion"}}. With reps > 1 `job_met` is a met frequency, so
    `pocd` stays the class's deadline-met probability."""
    import numpy as np
    cls = jobs.job_class.cpu().numpy()
    met = result.job_met.cpu().numpy().astype(np.float64)
    cost = result.job_cost.cpu().numpy().astype(np.float64)
    comp = result.job_completion.cpu().numpy().astype(np.float64)
    out = {}
    for c in np.unique(cls):
        m = cls == c
        out[int(c)] = {
            "n_jobs": int(m.sum()),
            "pocd": float(met[m].mean()),
            "mean_cost": float(cost[m].mean()),
            "mean_completion": float(comp[m].mean()),
        }
    return out


def request_result(reqs, completion, machine) -> SimResult:
    """SimResult from per-request serving columns (`repro_torch.serve`).

    A request is a 1-task job, so its completion is the job's completion
    and its machine time, priced by C, the job's cost: the schema of
    `aggregate`, so StreamCombiner takes serving epochs as it takes
    chunks. The columns stay on `completion`'s device; `reqs.D` and
    `reqs.C` may be numpy or tensors."""
    dev = completion.device
    col = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    met = completion <= col(reqs.D)
    cost = machine * col(reqs.C)
    return SimResult(pocd=_mean(met.to(torch.float32)), job_met=met,
                     job_completion=completion, job_cost=cost,
                     mean_cost=_mean(cost))


def latency_summary(result: SimResult) -> dict:
    """Latency percentiles of a result's completion column, on the host
    in float64 numpy: {"p50", "p95", "p99", "mean"}."""
    lat = to_host(result.job_completion).astype(np.float64)
    return {"p50": float(np.percentile(lat, 50)),
            "p95": float(np.percentile(lat, 95)),
            "p99": float(np.percentile(lat, 99)),
            "mean": float(lat.mean())}


def net_utility(pocd, mean_cost, r_min, theta):
    """The paper's evaluation utility on empirical quantities (Fig 2c/3c);
    `r_min` and `theta` enter as f32, as in the reference."""
    r_min = torch.tensor(r_min, dtype=torch.float32, device=pocd.device)
    theta = torch.tensor(theta, dtype=torch.float32, device=pocd.device)
    gap = torch.clamp(pocd - r_min, min=1e-9)
    return torch.where(pocd > r_min, torch.log10(gap) - theta * mean_cost,
                       -torch.inf)


class StreamCombiner:
    """Streaming reducer over job-contiguous chunks of a trace (the fleet
    layer, `repro_torch.fleet`).

    Each chunk's per-job columns go to host numpy (a few bytes a job; what
    chunking bounds is the per-task draws), and `finalize` reduces the
    concatenated (J,) columns once, with `_mean`, on the run's device: the
    same arrays a monolithic run reduces, so a chunked run gives the same
    bits.

    Queue metrics (capacity windows) combine as means weighted by the
    chunks' job counts, in float64 on the host; `max_wait` takes the max,
    `preempted` the sum. Each window replays on its own slot pool, so the
    combined queue metrics describe per-window contention.
    """

    def __init__(self):
        self._met, self._completion, self._cost = [], [], []
        self._weights, self._queues = [], []
        self._capacity = []

    def add(self, result: SimResult, n_jobs: int, queue=None,
            capacity=None) -> None:
        self._met.append(to_host(result.job_met))
        self._completion.append(to_host(result.job_completion))
        self._cost.append(to_host(result.job_cost))
        self._weights.append(float(n_jobs))
        if queue is not None:
            # paired with this chunk's weight, so chunks without a queue
            # can never mis-weight another chunk's
            self._queues.append((float(n_jobs), queue))
        if capacity is not None:
            # one window's CapacityMetrics, combined in chunk order
            self._capacity.append(capacity)

    @property
    def n_chunks(self) -> int:
        return len(self._weights)

    def finalize(self, *, device=None) -> SimResult:
        """The whole trace's SimResult on `device` (default the card)."""
        from ..device import resolve_device
        if not self._met:
            raise ValueError("StreamCombiner.finalize before any add()")
        dev = resolve_device(device)
        t = lambda parts: torch.from_numpy(np.concatenate(parts)).to(dev)
        met, cost = t(self._met), t(self._cost)
        return SimResult(
            pocd=_mean(met.to(torch.float32)), job_met=met,
            job_completion=t(self._completion), job_cost=cost,
            mean_cost=_mean(cost))

    def finalize_queue(self, *, device=None):
        """Weighted-combined queue metrics, f32 scalars on `device`
        (default the card); None when no chunk had any."""
        from ..device import resolve_device
        if not self._queues:
            return None
        dev = resolve_device(device)
        w = np.asarray([wi for wi, _ in self._queues], np.float64)
        w = w / w.sum()
        queues = [q for _, q in self._queues]
        f32 = lambda v: torch.tensor(np.float32(v), device=dev)
        wmean = lambda field: f32(float(np.sum(
            w * np.asarray([float(getattr(q, field)) for q in queues]))))
        q0 = queues[0]
        return type(q0)(
            mean_wait=wmean("mean_wait"),
            max_wait=f32(max(float(q.max_wait) for q in queues)),
            utilization=wmean("utilization"),
            preempted=f32(sum(float(q.preempted) for q in queues)),
            admitted_frac=wmean("admitted_frac"),
            slots=q0.slots)

    def finalize_capacity(self, *, device=None):
        """The per-window CapacityMetrics combined in chunk order on the
        host (`obs.metrics.combine_windows`), as tensors on `device`
        (default the card); None when no chunk carried any."""
        from ..device import resolve_device
        if not self._capacity:
            return None
        from ..obs.metrics import combine_windows
        dev = resolve_device(device)
        out = combine_windows(self._capacity)
        return type(out)(*(torch.from_numpy(np.asarray(x)).to(dev)
                           for x in out))

    # The combiner is the resume state of a chunked run (`chaos.recovery`):
    # what is reduced lives in these host lists, what is not is
    # recomputable from the source and the chunk index. state_dict is the
    # reference's flat {name: numpy array} form; from_state restores the
    # per-chunk list boundaries from the weights, so finalize concatenates
    # the same parts in the same order and gives the same bits.

    def state_dict(self) -> dict:
        """{met, completion, cost, weights} and, where chunks carried
        them, {queue_w, queue_vals, queue_slots} and cap_<field>: host
        numpy, the reference's keys."""
        if not self._met:
            raise ValueError("state_dict of an empty StreamCombiner")
        out = {
            "met": np.concatenate(self._met),
            "completion": np.concatenate(self._completion),
            "cost": np.concatenate(self._cost),
            "weights": np.asarray(self._weights, np.float64),
        }
        if self._queues:
            out["queue_w"] = np.asarray([w for w, _ in self._queues],
                                        np.float64)
            out["queue_vals"] = np.asarray(
                [[float(q.mean_wait), float(q.max_wait),
                  float(q.utilization), float(q.preempted),
                  float(q.admitted_frac)] for _, q in self._queues],
                np.float32)
            out["queue_slots"] = np.asarray(
                [-1 if q.slots is None else int(q.slots)
                 for _, q in self._queues], np.int64)
        if self._capacity:
            for f in self._capacity[0]._fields:
                out[f"cap_{f}"] = np.stack(
                    [to_host(getattr(m, f)) for m in self._capacity])
        return out

    @classmethod
    def from_state(cls, state: dict) -> "StreamCombiner":
        """The combiner that `state_dict` snapshotted (queue values come
        back as numpy f32 scalars)."""
        acc = cls()
        w = np.asarray(state["weights"], np.float64)
        splits = np.cumsum(w.astype(np.int64))[:-1]
        acc._met = list(np.split(np.asarray(state["met"]), splits))
        acc._completion = list(np.split(np.asarray(state["completion"]),
                                        splits))
        acc._cost = list(np.split(np.asarray(state["cost"]), splits))
        acc._weights = [float(x) for x in w]
        if "queue_vals" in state:
            from ..cluster.engine import QueueMetrics
            f32 = np.float32
            acc._queues = [
                (float(wi), QueueMetrics(
                    mean_wait=f32(v[0]), max_wait=f32(v[1]),
                    utilization=f32(v[2]), preempted=f32(v[3]),
                    admitted_frac=f32(v[4]),
                    slots=None if int(s) < 0 else int(s)))
                for wi, v, s in zip(state["queue_w"], state["queue_vals"],
                                    state["queue_slots"])]
        cap_keys = [k for k in state if k.startswith("cap_")]
        if cap_keys:
            from ..obs.metrics import CapacityMetrics
            n = int(np.asarray(state[cap_keys[0]]).shape[0])
            acc._capacity = [
                CapacityMetrics(**{f: np.asarray(state[f"cap_{f}"])[i]
                                   for f in CapacityMetrics._fields})
                for i in range(n)]
        return acc
