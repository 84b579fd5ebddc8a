"""The training cell: the port's governed `Trainer.run` over whole steps.

One `Trainer` is built at the configuration's sizes; its weights are
replaced by the seed's (`weights.py`), its learning rate made constant
(the step built without a schedule), and its input pipeline seeded from
`--seed`. Then one call of `Trainer.run` drives everything: its first
`checked` steps are set-up (they build and warm every kernel, the
governor's first decision among them) and are the steps that the
reference follows; the steps after them are the measured window. The
harness sees the run through `Feed`, which stands in for the trainer's
pipeline: between two steps it reads what the check needs, and once the
window's seconds have passed it ends the run by raising `WindowClosed`
at the next step's fetch, which comes right after the last step's loss
was read back (a synchronising `float`).

Wrappers around the program's calls (`governor.decide`, and with
tracing `optimizer.update` inside a profiler range) are the harness's
spans; the program is not edited.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from . import weights as W
from .model_shape import ModelShape, shape_of

OPTIMIZER_RANGE = "bench.optimizer"
WINDOW_START, WINDOW_END = "bench.window_start", "bench.window_end"


class WindowClosed(Exception):
    """Raised through `Trainer.run` when the window's time is up."""


def program_config(cfg: dict):
    """The port's registered config cut to the file's depth, with the
    file's RMSNorm epsilon (and, in the tests' tiny files only, their
    `program_overrides`), checked against every size the file states."""
    from repro_torch.configs import get_config
    pc = get_config(cfg["program_config"])
    s, tr = shape_of(cfg), cfg["training"]
    over = dict(cfg.get("program_overrides", {}))
    if "moe" in over:
        over["moe"] = dataclasses.replace(pc.moe, **over["moe"])
    pc = dataclasses.replace(pc, n_layers=cfg["num_hidden_layers"],
                             norm_eps=s.norm_eps, **over)
    want = dict(d_model=s.d_model, n_layers=s.n_layers, n_heads=s.n_heads,
                n_kv_heads=s.n_kv_heads, head_dim=s.head_dim,
                vocab_size=s.vocab, rope_theta=s.rope_theta,
                norm_eps=s.norm_eps, activation="swiglu", causal=True,
                rope_fraction=1.0, sliding_window=None, attn_softcap=None,
                final_softcap=None, post_block_norms=False,
                embed_scale=False, param_dtype=tr["param_dtype"],
                compute_dtype=tr["compute_dtype"], remat=tr["remat"],
                optimizer=tr["optimizer"])
    got = {k: getattr(pc, k) for k in want}
    if s.moe:
        m = pc.moe
        want.update(n_experts=s.n_experts, top_k=s.top_k, e_ff=s.d_ff,
                    capacity_factor=s.capacity_factor,
                    aux_loss_weight=s.aux_coef, dense_residual=False,
                    norm_topk=True)
        got.update(n_experts=m.n_experts, top_k=m.top_k, e_ff=m.d_ff,
                   capacity_factor=m.capacity_factor,
                   aux_loss_weight=m.aux_loss_weight,
                   dense_residual=m.dense_residual, norm_topk=s.norm_topk)
    else:
        want["d_ff"], got["d_ff"] = s.d_ff, pc.d_ff
        want["moe"], got["moe"] = None, pc.moe
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    if bad:
        raise ValueError(f"{cfg['name']}: the program's config differs from "
                         f"the file's (program, file): {bad}")
    return pc


def named_leaves(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(named_leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(named_leaves(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


@torch.no_grad()
def load_weights(params, s: ModelShape, seed: int) -> None:
    """The seed's weights drawn into the program's parameter tensors."""
    named = named_leaves(params)
    specs = W.leaves(s)
    if set(named) != {n for n, _, _ in specs}:
        raise ValueError(f"parameter names differ: program "
                         f"{sorted(set(named) - {n for n, _, _ in specs})} "
                         f"harness "
                         f"{sorted({n for n, _, _ in specs} - set(named))}")
    gen = None
    for i, (name, shape, scale) in enumerate(specs):
        p = named[name]
        if tuple(p.shape) != shape or p.dtype != torch.float32 or \
                not p.is_contiguous():
            raise ValueError(f"{name}: program {tuple(p.shape)} {p.dtype}, "
                             f"harness {shape} float32")
        gen = gen or W.generator(p.device)
        W.fill(p, seed, i, scale, gen)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Feed:
    """Stands in for the trainer's pipeline; see the module docstring."""

    def __init__(self, run, inner):
        self.run, self.inner, self.calls = run, inner, 0

    def __iter__(self):
        return self

    def __next__(self):
        k = self.calls
        self.calls += 1
        self.run.before_step(k)
        t0 = time.perf_counter()
        item = next(self.inner)
        self.run.after_fetch(k, item, time.perf_counter() - t0)
        return item

    def close(self):
        self.inner.close()


class TrainRun:
    """One cell's trainer, its checked steps and its window."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 trace: bool = False, start: float | None = None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.shape = shape_of(cfg)
        self.trace = trace
        self.start = time.perf_counter() if start is None else start
        self.checked = int(traffic["checked_steps"])
        self.seconds = None
        self.batches, self.waits, self.decide_ms = [], [], []
        self.grad_norms = self.change_norms = self.change_probes = None
        self.in_window = False
        self.prof = None
        self.t0 = self.t_end = None
        self.end_call = None
        self.counts = {}

    # -- set-up ------------------------------------------------------------
    def build(self):
        from repro_torch.train import Trainer, TrainerConfig, make_train_step
        t = self.traffic
        never = 1 << 30
        tcfg = TrainerConfig(
            n_steps=never, global_batch=t["global_batch"],
            seq_len=t["seq_len"], n_micro=t["n_micro"], lr=t["lr"],
            ckpt_every=never, ckpt_dir=None,
            n_data_shards=t["n_data_shards"], data_cycle=t["data_cycle"],
            speculative_input=True, log_every=never)
        self.tr = Trainer(program_config(self.cfg), tcfg, seed=0,
                          device=self.device)
        opt, want = self.tr.optimizer, self.cfg["training"]
        got = {"b1": opt.b1, "b2": opt.b2, "eps": opt.eps,
               "weight_decay": opt.wd}
        if any(got[k] != want[k] for k in got):
            raise ValueError(f"the program's AdamW {got} differs from the "
                             f"file's {want}")
        # a constant learning rate: the step built with no schedule
        self.tr._step_fn = make_train_step(self.tr.model, self.tr.optimizer,
                                           tcfg.n_micro)
        self._wrap_governor()
        if self.trace:
            self._wrap_optimizer()
        return self

    def _wrap_governor(self):
        from repro_torch.runtime.governor import WARM_DECISIONS
        gov, tel = self.tr.governor, self.tr.telemetry
        inner = gov.decide

        def decide():
            before = tel.counters.get(WARM_DECISIONS, 0)
            t0 = time.perf_counter()
            sol = inner()
            if self.in_window and \
                    tel.counters.get(WARM_DECISIONS, 0) != before:
                self.decide_ms.append(1e3 * (time.perf_counter() - t0))
            return sol

        gov.decide = decide

    def _wrap_optimizer(self):
        from torch.profiler import record_function
        opt = self.tr.optimizer
        inner = opt.update

        def update(*a, **kw):
            with record_function(OPTIMIZER_RANGE):
                return inner(*a, **kw)

        opt.update = update

    def reset(self, seed: int):
        """Weights, optimizer state and input pipeline of `seed`."""
        from repro_torch.data.pipeline import DataPipeline
        self.seed = seed
        st = self.tr.state
        for tree in (st.opt_state.m, st.opt_state.v):
            for x in named_leaves(tree).values():
                x.zero_()
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        self.tr.state = st._replace(
            opt_state=st.opt_state._replace(step=zero.clone()),
            step=zero.clone())
        load_weights(self.tr.state.params, self.shape, seed)
        old = self.tr.pipeline
        old = getattr(old, "inner", old)
        old.close()
        self.tr.pipeline = Feed(self, DataPipeline(
            dataclasses.replace(old.cfg, seed=seed),
            shard_runner=old.shard_runner, governor=old.governor))
        self.tr.history = []
        self.batches, self.waits, self.decide_ms = [], [], []
        self.grad_norms = self.change_norms = self.change_probes = None
        sync(self.device)
        return self

    # -- between steps -----------------------------------------------------
    def before_step(self, k: int):
        if k == 1:
            self.read_grad_norms()
        if k == self.checked:
            self.read_change_norms()
            if self.seconds is not None:
                self._open_window()
        elif k > self.checked and self.seconds is not None and \
                time.perf_counter() - self.t0 >= self.seconds:
            self._close_window(k)
            raise WindowClosed()

    def after_fetch(self, k: int, item, wait: float):
        _, batch = item
        if k < self.checked:
            self.batches.append({n: np.array(batch[n])
                                 for n in ("tokens", "labels")})
        elif self.in_window:
            self.waits.append(wait)

    @torch.no_grad()
    def read_grad_norms(self):
        """Each leaf's first gradient as the optimizer got it: AdamW's
        first moment after one step is (1 - b1) g."""
        b1 = self.tr.optimizer.b1
        m = named_leaves(self.tr.state.opt_state.m)
        self.grad_norms = {n: float(torch.linalg.vector_norm(x)) / (1 - b1)
                           for n, x in m.items()}

    def read_change_norms(self):
        self.change_norms, self.change_probes = W.change_readings(
            named_leaves(self.tr.state.params), self.shape, self.seed)

    # -- the window --------------------------------------------------------
    def _counts(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import grid_solve as gs
        from repro_torch.runtime.governor import WARM_DECISIONS
        return {"flash_forward": fa.launches_sm90 + fa.launches_simt,
                "flash_backward": fa.launches_backward,
                "grid_solve": gs.launches,
                "warm_decisions": self.tr.telemetry.counters.get(
                    WARM_DECISIONS, 0)}

    def _open_window(self):
        if self.trace:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            with record_function(WINDOW_START):
                pass
        sync(self.device)
        if self.device.type == "cuda":
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        else:
            self.setup_peak = 0
        self.counts0 = self._counts()
        self.in_window = True
        self.t0 = time.perf_counter()
        self.setup_s = self.t0 - self.start

    def _close_window(self, k: int):
        sync(self.device)
        self.t_end = time.perf_counter()
        self.in_window = False
        self.end_call = k
        c1 = self._counts()
        self.counts = {n: c1[n] - self.counts0[n] for n in c1}
        if self.device.type == "cuda":
            self.window_peak = torch.cuda.max_memory_allocated(self.device)
        else:
            self.window_peak = 0
        if self.prof is not None:
            from torch.profiler import record_function
            with record_function(WINDOW_END):
                pass
            self.prof.stop()

    def run_window(self, seconds: float) -> dict:
        """The checked steps, then whole steps until `seconds` have
        passed. Returns the window's record."""
        self.seconds = float(seconds)
        try:
            self.tr.run()
        except WindowClosed:
            pass
        else:
            raise RuntimeError("Trainer.run returned before the window "
                               "closed")
        finally:
            self.tr.pipeline.close()
        steps = self.end_call - self.checked
        t = self.traffic
        losses = [h["loss"] for h in self.tr.history]
        return {"steps": steps,
                "tokens": steps * t["global_batch"] * t["seq_len"],
                "window_s": self.t_end - self.t0,
                "setup_s": self.setup_s,
                "checked_losses": losses[:self.checked],
                "window_losses": losses[self.checked:],
                "peak_bytes": self.window_peak,
                "process_peak_bytes": max(self.setup_peak, self.window_peak),
                "waits_s": list(self.waits),
                "decide_ms": list(self.decide_ms),
                "counts": dict(self.counts)}

    def run_checked(self):
        """Only the checked steps (no window), for the calibration's runs."""
        self.seconds = None
        self.tr.run(n_steps=self.checked)
        if self.grad_norms is None:
            self.read_grad_norms()
        self.read_change_norms()

    def readings(self) -> dict:
        """What the program produced in the checked steps."""
        return {"loss": [h["loss"] for h in self.tr.history[:self.checked]],
                "grad_norms": self.grad_norms,
                "change_norms": self.change_norms,
                "change_probes": self.change_probes,
                "batches": self.batches}

    def free(self):
        """Drop the trainer and every tensor of it."""
        if getattr(self, "tr", None) is not None:
            try:
                self.tr.pipeline.close()
            except Exception:
                pass
        self.tr = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
