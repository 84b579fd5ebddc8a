"""Completion-time estimation and work-preserving handoff (paper Section
VI); counterpart of `repro.core.estimator`.

Eq. (30): startup-aware estimated completion time
    t_ect = t_lau + (t_FP - t_lau) + (t_now - t_FP) / (CP - FP)
where t_lau is the launch time, t_FP the time of the first progress
report and FP / CP the first / current progress scores. The middle term
is the measured startup overhead; the last extrapolates processing time
to 100% progress.

Hadoop's default estimator ignores startup:
    t_ect_naive = t_lau + (t_now - t_lau) / CP

Eq. (31): a re-dispatched work-preserving attempt skips the bytes the
original processes during the new attempt's startup window:
    b_extra = b_est / (tau_est - t_FP) * (t_FP - t_lau)
    b_new   = b_start + b_est + b_extra

Arguments are tensors or Python numbers; numbers are computed in f32,
as the reference's jnp computes them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .pareto import _f32


class ProgressReport(NamedTuple):
    t_lau: torch.Tensor   # launch time
    t_fp: torch.Tensor    # time of the first progress report
    fp: torch.Tensor      # first reported progress in (0, 1]
    t_now: torch.Tensor   # current time
    cp: torch.Tensor      # current progress in (0, 1]


def estimate_completion_chronos(rep: ProgressReport):
    """Eq. (30) literally: t_lau + (t_FP - t_lau) + (t_now - t_FP) /
    (CP - FP); the last term is the whole processing time at the rate
    seen since the first report."""
    t_lau, t_fp, fp, t_now, cp = _f32(*rep)
    dp = torch.clamp(cp - fp, min=1e-9)
    return t_lau + (t_fp - t_lau) + (t_now - t_fp) / dp


def estimate_completion_naive(rep: ProgressReport):
    """Hadoop's default, elapsed / progress: biased when startup >> 0."""
    t_lau, _, _, t_now, cp = _f32(*rep)
    return t_lau + (t_now - t_lau) / torch.clamp(cp, min=1e-9)


def is_straggler(rep: ProgressReport, deadline, naive: bool = False):
    est = estimate_completion_naive(rep) if naive \
        else estimate_completion_chronos(rep)
    return est > deadline


def handoff_offset(b_start, b_est, tau_est, t_fp, t_lau):
    """Eq. (31): the byte offset of a resumed attempt, anticipating its
    startup: b_extra = rate * startup, rate = b_est / (tau_est - t_FP),
    startup = t_FP - t_lau measured on the original attempt."""
    b_start, b_est, tau_est, t_fp, t_lau = _f32(b_start, b_est, tau_est,
                                                t_fp, t_lau)
    rate = b_est / torch.clamp(tau_est - t_fp, min=1e-9)
    b_extra = rate * (t_fp - t_lau)
    return b_start + b_est + b_extra
