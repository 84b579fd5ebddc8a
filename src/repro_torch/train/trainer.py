"""The training loop: data pipeline + governor + checkpointing + failure
handling, with the Chronos layer as a first-class feature; counterpart of
`repro.train.trainer`.

Per step:
  1. the governor fits Pareto to shard telemetry and picks (strategy, r*)
     (on the card, one grid-solve launch per Chronos strategy);
  2. the data pipeline's shard tasks run under the SpeculativeTaskRunner
     (steps 1-2 run in the pipeline's producer thread, up to
     `prefetch_depth` steps ahead of the training step);
  3. the train step consumes the batch with the backup-shard mask;
  4. every `ckpt_every` steps the state is copied to the host and the
     async checkpointer commits it atomically;
  5. an injected failure (`run(fail_at=)`) raises after the checkpoint
     is written; `maybe_restore` then restores the latest step and seeks
     the pipeline to it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from ..ckpt import checkpoint as ckpt
from ..data.pipeline import DataPipeline, PipelineConfig
from ..device import resolve_device
from ..models import model as model_lib
from ..runtime.governor import GovernorConfig, StepGovernor
from ..runtime.speculation import SpeculativeTaskRunner
from ..runtime.telemetry import Telemetry
from .optimizer import make_optimizer
from .train_step import TrainState, cosine_schedule, make_train_step


@dataclass
class TrainerConfig:
    n_steps: int = 100
    global_batch: int = 8
    seq_len: int = 64
    n_micro: int = 2
    lr: float = 3e-3
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    step_deadline: float = 5.0      # governor deadline (seconds)
    n_data_shards: int = 4
    data_cycle: int = 0
    speculative_input: bool = True
    log_every: int = 10


def to_host(tree):
    """`tree` with every tensor copied to the host (a copy also of a
    tensor already there, which the next step would update in place)."""
    return ckpt.tree_rebuild(tree, iter([x.detach().to("cpu", copy=True)
                                         for x in ckpt.tree_leaves(tree)]))


class Trainer:
    """Parameters from `model.init(seed, device)`; the reference takes a
    `jax.random` key instead, so the two start from other weights."""

    def __init__(self, cfg, tcfg: TrainerConfig, seed: int = 0, device=None):
        self.arch_cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.model = model_lib.build(cfg)
        params = self.model.init(seed=seed, device=self.device)
        self.optimizer = make_optimizer(cfg, lr=tcfg.lr)
        opt_state = self.optimizer.init(params)
        self.state = TrainState(params=params, opt_state=opt_state,
                                step=torch.zeros((), dtype=torch.int32,
                                                 device=self.device))
        sched = cosine_schedule(base=1.0, warmup=10, total=tcfg.n_steps)
        self._step_fn = make_train_step(self.model, self.optimizer,
                                        tcfg.n_micro, sched)
        self.telemetry = Telemetry()
        self.governor = StepGovernor(
            GovernorConfig(deadline=tcfg.step_deadline,
                           n_tasks=tcfg.n_data_shards, theta=1e-3),
            self.telemetry, device=self.device)
        runner = SpeculativeTaskRunner() if tcfg.speculative_input else None
        self.pipeline = DataPipeline(
            PipelineConfig(vocab_size=cfg.vocab_size, seq_len=tcfg.seq_len,
                           global_batch=tcfg.global_batch,
                           n_shards=tcfg.n_data_shards,
                           cycle=tcfg.data_cycle,
                           family="dense"),
            shard_runner=runner,
            governor=self.governor if tcfg.speculative_input else None)
        self.checkpointer = ckpt.AsyncCheckpointer(tcfg.ckpt_dir) \
            if tcfg.ckpt_dir else None
        self.history: list[dict] = []

    def maybe_restore(self) -> int:
        if not self.tcfg.ckpt_dir:
            return 0
        latest = ckpt.latest_step(self.tcfg.ckpt_dir)
        if latest is None:
            return 0
        self.state = ckpt.restore(self.tcfg.ckpt_dir, latest, self.state,
                                  device=self.device)
        # seek the data pipeline: exact resume = replay from the same step
        self.pipeline.close()
        self.pipeline = DataPipeline(self.pipeline.cfg, start_step=latest,
                                     shard_runner=self.pipeline.shard_runner,
                                     governor=self.pipeline.governor)
        return int(latest)

    def run(self, n_steps: Optional[int] = None,
            fail_at: Optional[int] = None):
        n_steps = n_steps or self.tcfg.n_steps
        start = int(self.state.step)
        mask = torch.ones((self.tcfg.n_micro,), dtype=torch.float32,
                          device=self.device)
        for _ in range(start, n_steps):
            t0 = time.perf_counter()
            step, batch = next(self.pipeline)
            tbatch = {k: torch.from_numpy(batch[k]).to(self.device)
                      for k in ("tokens", "labels")}
            self.state, metrics = self._step_fn(self.state, tbatch, mask)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.history.append({"step": step, "loss": loss, "time": dt})
            if self.checkpointer and (step + 1) % self.tcfg.ckpt_every == 0:
                self.checkpointer.save(step + 1, to_host(self.state))
            if fail_at is not None and step + 1 == fail_at:
                if self.checkpointer:
                    self.checkpointer.wait()
                self.pipeline.close()
                raise RuntimeError(f"injected failure at step {fail_at}")
            if (step + 1) % self.tcfg.log_every == 0:
                print(f"step {step+1:5d} loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms, "
                      f"shards={float(metrics['active_shards']):.0f})")
        if self.checkpointer:
            self.checkpointer.wait()
        self.pipeline.close()
        return self.history
