"""Converters from the reference's state to the port's.

The port carries no weights; its state is the trace (a JobSet), the
per-job Algorithm-1 inputs (a JobSpec) and the simulator parameters. These
functions take that state as plain numpy arrays and numbers, e.g.
`{f: np.asarray(getattr(ref_jobs, f)) for f in ...}`, so that both
packages can be fed the same inputs without this package importing the
reference.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.utility import JobSpec
from .device import resolve_device
from .sim.strategies import SimParams
from .sim.trace import JobSet


def _tensor(a, dtype, device) -> torch.Tensor:
    # a writable copy: arrays viewed from another framework are read-only
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)


def jobset(n_jobs: int, columns: Mapping[str, np.ndarray], *,
           device=None) -> JobSet:
    """A JobSet from the reference JobSet's array leaves by field name.

    Per-job and per-task columns are copied as they are (no recompute), so
    the port sees the reference's exact floats; job_id becomes int64.
    """
    dev = resolve_device(device)
    fields = JobSet._fields[1:]
    missing = [f for f in fields if f not in columns]
    if missing:
        raise ValueError(f"jobset: missing columns {missing}")
    dtypes = {"n_tasks": np.int32, "job_class": np.int32,
              "job_id": np.int64}
    out = {f: _tensor(columns[f], dtypes.get(f, np.float32), dev)
           for f in fields}
    return JobSet(n_jobs=int(n_jobs), **out)


def jobspec(columns: Mapping[str, np.ndarray], *, device=None) -> JobSpec:
    """A JobSpec of f32 tensors from the reference JobSpec's leaves."""
    dev = resolve_device(device)
    return JobSpec(*(_tensor(columns[f], np.float32, dev)
                     for f in JobSpec._fields))


def simparams(fields: Mapping[str, float]) -> SimParams:
    """SimParams from the reference SimParams' `_asdict()`."""
    unknown = set(fields) - set(SimParams._fields)
    if unknown:
        raise ValueError(f"simparams: unknown fields {sorted(unknown)}")
    return SimParams(**fields)
