"""Deterministic, seekable, per-host sharded token pipeline.

Every batch is a pure function of (seed, step, shard) — the property that
makes Speculative-Resume work-preserving for input tasks: a re-dispatched
shard task "resumes from byte offset b" by just regenerating from its
(step, shard) coordinates (Eq. 31's handoff with zero re-read cost), and
exact restart-after-failure replays the same stream from the checkpointed
step. A background prefetch thread keeps `depth` batches ready; per-host
sharding slices the global batch by host rank (single-process here).

Counterpart of `repro.data.pipeline`, copied: the same numpy
`SeedSequence` gives the same batches bit for bit. `close` also joins the
producer thread, so no shard task or governor solve outlives the
pipeline.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_rank: int = 0
    n_shards: int = 16           # input tasks per step (Chronos "tasks")
    prefetch_depth: int = 2
    family: str = "dense"        # dense | vlm | audio
    cycle: int = 0               # >0: repeat the stream every `cycle` steps
    n_patches: int = 0
    patch_dim: int = 0
    frame_dim: int = 0


def _shard_rng(cfg: PipelineConfig, step: int, shard: int):
    if cfg.cycle:
        step = step % cfg.cycle
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))


def make_shard(cfg: PipelineConfig, step: int, shard: int) -> dict:
    """One input shard — deterministic in (seed, step, shard)."""
    rng = _shard_rng(cfg, step, shard)
    rows = cfg.global_batch // cfg.n_shards
    if cfg.family == "audio":
        frames = rng.normal(size=(rows, cfg.seq_len, cfg.frame_dim)
                            ).astype(np.float32)
        labels = rng.integers(0, cfg.vocab_size, (rows, cfg.seq_len),
                              dtype=np.int32)
        return {"frames": frames, "labels": labels}
    toks = rng.integers(0, cfg.vocab_size, (rows, cfg.seq_len + 1),
                        dtype=np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(
            size=(rows, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
    return out


def assemble(cfg: PipelineConfig, shards: list[dict]) -> dict:
    batch = {k: np.concatenate([s[k] for s in shards], axis=0)
             for k in shards[0]}
    # per-host slice of the global batch
    rows = cfg.global_batch // cfg.n_hosts
    lo = cfg.host_rank * rows
    return {k: v[lo: lo + rows] for k, v in batch.items()}


class DataPipeline:
    """Iterator with exact resume: state is just the step counter."""

    def __init__(self, cfg: PipelineConfig, start_step: int = 0,
                 shard_runner=None, governor=None):
        self.cfg = cfg
        self.step = start_step
        self.shard_runner = shard_runner    # optional SpeculativeTaskRunner
        self.governor = governor
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch_depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # -- producer --
    def _build(self, step: int) -> dict:
        cfg = self.cfg
        if self.shard_runner is not None and self.governor is not None:
            sol = self.governor.decide()
            t_min = (self.governor.last_params or (0.05, 2.0))[0]

            def task(idx, board, resume_from):
                # deterministic regeneration; resume_from skips no work here
                # because generation is pure, but real readers seek to it.
                out = make_shard(cfg, step, idx)
                board.report(1.0, offset=float(cfg.seq_len))
                return out

            res = self.shard_runner.run(
                task, cfg.n_shards, strategy=sol.strategy, r=sol.r_opt,
                deadline=self.governor.cfg.deadline,
                tau_est=self.governor.cfg.tau_est_frac * t_min,
                tau_kill=(self.governor.cfg.tau_est_frac +
                          self.governor.cfg.tau_kill_gap_frac) * t_min)
            shards = [r.value for r in res]
            for r in res:
                self.governor.observe(max(r.wall, 1e-4))
        else:
            shards = [make_shard(cfg, step, s) for s in range(cfg.n_shards)]
        return assemble(cfg, shards)

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            batch = self._build(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    # -- consumer --
    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return step, batch

    def __iter__(self) -> Iterator:
        return self

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join()
