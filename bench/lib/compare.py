"""The numbers that decide `correct`, each against its limit.

A training cell's reference follows its first `checked_steps` steps
from the same weights and tokens (`reference/transformer.py`). Compared:

- `loss_gap`: the largest |program loss - reference loss| / |reference
  loss| over those steps;
- `grad_gap`: over leaves, the largest gap between the program's norm of
  its first gradient (from AdamW's first moment after one step) and the
  reference's, over the reference's norm of that leaf or of the median
  leaf, whichever is larger;
- `update_gap`: the same of each leaf's change after the checked steps,
  over the leaves whose reference gradient is at least a thousandth of
  the median leaf's (a leaf with none moves by round-off alone);
- `update_diff`: over the same leaves, the median of ||P - R|| over the
  larger of ||R|| and the median leaf's, where P and R are the
  projections of the program's and the reference's change onto the same
  random directions (`weights.change_readings`): an estimate of the
  relative norm of the two changes' difference, which sees the
  direction that `update_gap` does not (every update reversed reads 2,
  none made 1). The median leaf, not the worst: the worst is the
  largest of many estimates from a few directions each, and swings with
  them;
- `token_mismatch`: tokens and labels that the trainer consumed in the
  checked steps and that differ from the stream's rule (`tokens.py`);
- `window_nonfinite`: window steps whose loss is not finite.

A run is correct when every number is at most its limit.
"""
from __future__ import annotations

import math
import statistics

import numpy as np

#: a leaf whose reference gradient norm is under this share of the
#: median leaf's takes no part in `update_gap`
STILL = 1e-3


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """{leaf: |prog - ref| / max(ref of the leaf, median ref)}."""
    med = statistics.median(ref.values())
    out = {}
    for n in ref:
        if keep is not None and n not in keep:
            continue
        den = max(ref[n], med)
        gap = abs(prog[n] - ref[n]) / den if den > 0 else \
            (0.0 if prog[n] == ref[n] else math.inf)
        out[n] = gap if gap == gap else math.inf     # NaN counts as inf
    return out


def diff_gaps(prog: dict, ref: dict, keep) -> dict:
    """{leaf: ||prog - ref|| / max(||ref|| of the leaf, median ||ref||)}
    of each leaf's projections."""
    size = {n: math.hypot(*v) for n, v in ref.items()}
    med = statistics.median(size.values())
    out = {}
    for n in ref:
        if n not in keep:
            continue
        gap = math.dist(prog[n], ref[n]) / max(size[n], med)
        out[n] = gap if gap == gap else math.inf     # NaN counts as inf
    return out


def details(prog: dict, ref: dict) -> dict:
    """Each step's loss gap and each leaf's gradient, update and
    difference gaps."""
    med = statistics.median(ref["grad_norms"].values())
    moving = {n for n, g in ref["grad_norms"].items() if g >= STILL * med}
    return {"loss_gaps": [abs(p - r) / abs(r) if math.isfinite(p)
                          else math.inf
                          for p, r in zip(prog["loss"], ref["loss"],
                                          strict=True)],
            "grad_gaps": leaf_gaps(prog["grad_norms"], ref["grad_norms"]),
            "update_gaps": leaf_gaps(prog["change_norms"],
                                     ref["change_norms"], moving),
            "diff_gaps": diff_gaps(prog["change_probes"],
                                   ref["change_probes"], moving)}


def _worst(gaps: dict) -> tuple:
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def readings(prog: dict, ref: dict, expected: list,
             window_losses: list) -> tuple:
    """({number: value}, {number: worst leaf}) of a run."""
    d = details(prog, ref)
    grad_gap, grad_at = _worst(d["grad_gaps"])
    upd_gap, upd_at = _worst(d["update_gaps"])
    mismatch = 0
    for got, want in zip(prog["batches"], expected, strict=True):
        for k in ("tokens", "labels"):
            mismatch += int(np.sum(np.asarray(got[k]) != want[k]))
    bad = sum(1 for x in window_losses if not math.isfinite(x))
    values = {"loss_gap": max(d["loss_gaps"]), "grad_gap": grad_gap,
              "update_gap": upd_gap,
              "update_diff": statistics.median(d["diff_gaps"].values()),
              "token_mismatch": mismatch, "window_nonfinite": bad}
    return values, {"grad_gap": grad_at, "update_gap": upd_at}


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {number: {"value", "limit"}}) with every limit named."""
    if set(values) != set(limits):
        raise ValueError(f"limits {sorted(limits)} for numbers "
                         f"{sorted(values)}")
    checks = {n: {"value": values[n], "limit": limits[n]} for n in values}
    ok = all(values[n] <= limits[n] for n in values)
    return ok, checks
