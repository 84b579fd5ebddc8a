"""One run of one cell: set-up, the window, the check, the result line.

`run_cell` is what `run.py` calls on the card. Tests call it on the CPU
with a tiny configuration, and with a fault planted (`plant`), to see
`correct` come out false; the command line never runs it on the CPU.
"""
from __future__ import annotations

import math
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

from . import compare, guard, spec
from . import tokens as T
from . import trace as TR
from .model_shape import shape_of
from .train import (OPTIMIZER_RANGE, WINDOW_END, WINDOW_START, TrainRun,
                    named_leaves)

FAULTS = ("stale", "half_batch", "token", "flip")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def plant(run: TrainRun, fault: str):
    """Break the timed path underneath the harness; returns the undo.
    - "stale": the optimizer's update returns the state it was given;
    - "half_batch": the step's shard mask drops the second half of the
      microbatches, the mean taken over the rest;
    - "token": the pipeline's shard 0 comes out with one token altered;
    - "flip": the optimizer gets each gradient with its sign reversed,
      so that every update goes the wrong way at the right size."""
    if fault == "stale":
        opt = run.tr.optimizer
        inner = opt.update
        opt.update = lambda grads, state, params, lr_scale=1.0: (params,
                                                                 state)
        return lambda: setattr(opt, "update", inner)
    if fault == "half_batch":
        inner = run.tr._step_fn
        n = run.traffic["n_micro"]

        def half(state, batch, mask):
            keep = torch.ones_like(mask)
            keep[n // 2:] = 0
            return inner(state, batch, mask * keep)

        run.tr._step_fn = half
        return lambda: setattr(run.tr, "_step_fn", inner)
    if fault == "token":
        from repro_torch.data import pipeline as P
        orig = P.make_shard
        vocab = run.shape.vocab

        def altered(cfg, step, shard):
            out = orig(cfg, step, shard)
            if shard == 0:
                out["tokens"] = out["tokens"].copy()
                out["tokens"][0, 7] = (out["tokens"][0, 7] + 1) % vocab
            return out

        P.make_shard = altered
        return lambda: setattr(P, "make_shard", orig)
    if fault == "flip":
        opt = run.tr.optimizer
        inner = opt.update

        def flipped(grads, state, params, lr_scale=1.0):
            for g in named_leaves(grads).values():
                g.neg_()
            return inner(grads, state, params, lr_scale)

        opt.update = flipped
        return lambda: setattr(opt, "update", inner)
    raise ValueError(f"fault {fault!r}: one of {FAULTS}")


def expected_batches(cfg: dict, traffic: dict, seed: int, steps: int) -> list:
    s = shape_of(cfg)
    return [T.step_batch(seed, t, s.vocab, traffic["seq_len"],
                         traffic["global_batch"], traffic["n_data_shards"])
            for t in range(steps)]


def reference_run(cfg, traffic, seed, device, precision="float32") -> dict:
    from ..reference import transformer as R
    tr = cfg["training"]
    opt = {"lr": traffic["lr"], "b1": tr["b1"], "b2": tr["b2"],
           "eps": tr["eps"]}
    return R.train(shape_of(cfg), seed,
                   expected_batches(cfg, traffic, seed,
                                    traffic["checked_steps"]),
                   opt, device, precision)


def _number(x):
    return x if isinstance(x, int) or math.isfinite(x) else repr(x)


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device="cuda", start=None, cfg=None,
             traffic=None, fault=None) -> tuple:
    """(result, check lines). `cfg` and `traffic` default to the cell's
    files (tests pass tiny ones)."""
    start = time.perf_counter() if start is None else start
    cfg = cfg or spec.load_config(bench, cell["config"])
    traffic = traffic or spec.load_traffic(cell["name"])
    if traffic["kind"] != "train":
        raise ValueError(f"traffic kind {traffic['kind']!r}: the harness "
                         f"drives 'train'")
    device = torch.device(device)
    run = TrainRun(cfg, traffic, seed, device, trace=trace,
                   start=start).build()
    undo = plant(run, fault) if fault else (lambda: None)
    try:
        run.reset(seed)
        log(f"set-up: trainer built and loaded, {time.perf_counter() - start:.1f}"
            f" s; {run.checked} checked steps, then the window")
        win = run.run_window(seconds)
        prog = run.readings()
    finally:
        undo()
    log(f"window: {win['steps']} steps, {win['window_s']:.3f} s, setup "
        f"{win['setup_s']:.2f} s, checked losses {win['checked_losses']}, "
        f"counts {win['counts']}")
    red = None
    if trace and run.prof is not None:
        red = _reduce(run.prof)
    run.free()
    if device.type == "cuda":
        log(f"memory held before the reference: "
            f"{torch.cuda.memory_allocated(device)} bytes")
    found = guard.forbidden_loaded()
    if found:
        raise RuntimeError(f"forbidden modules loaded: {found}")
    t_ref = time.perf_counter()
    ref = reference_run(cfg, traffic, seed, device)
    log(f"reference: {time.perf_counter() - t_ref:.1f} s, losses "
        f"{ref['loss']}")
    values, where = compare.readings(
        prog, ref, expected_batches(cfg, traffic, seed, run.checked),
        win["window_losses"])
    correct, checks = compare.judge(values, traffic["limits"])
    log(f"worst leaves: {where}")
    record = {"shape": run.shape, "traffic": traffic, "window": win,
              "trace": red}
    metrics = {}
    for m in spec.metrics_of(bench, cell["name"], trace):
        if m["name"] == "train_tokens_per_s":
            v = win["tokens"] / win["window_s"]
        elif m["name"] == "peak_mem_gib":
            v = win["peak_bytes"] / 2 ** 30
        elif m["name"] == "setup_s":
            v = win["setup_s"]
        else:
            v = spec.reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": win["process_peak_bytes"]}
    result = {"correct": correct, "attempted": win["steps"],
              "failed": values["window_nonfinite"], "metrics": metrics,
              "device": dev}
    if red is not None:
        dev["busy_s"] = red["busy_us"] / 1e6
        dev["window_s"] = red["window_us"] / 1e6
        result["breakdown"] = {"device_ops": red["device_ops"],
                               "idle_gaps": [list(g) for g in
                                             red["idle_gaps"]]}
    result["checks"] = {n: {"value": _number(c["value"]),
                            "limit": c["limit"]} for n, c in checks.items()}
    lines = [f"check {n} {c['value']!r} limit {c['limit']!r}"
             for n, c in checks.items()]
    lines.append(f"correct {correct}")
    return result, lines


def _reduce(prof) -> dict:
    d = tempfile.mkdtemp(prefix="bench-trace-")
    path = Path(d) / "trace.json"
    try:
        prof.export_chrome_trace(str(path))
        return TR.reduce(TR.load(path), WINDOW_START, WINDOW_END,
                         ranges=(OPTIMIZER_RANGE,))
    finally:
        if path.exists():
            os.remove(path)
        os.rmdir(d)
