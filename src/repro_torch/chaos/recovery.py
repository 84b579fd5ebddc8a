"""Chunk-boundary checkpoint and resume for fleet runs; counterpart of
`repro.chaos.recovery`.

The resume state of a chunked fleet run is small and lives on the host:
the `StreamCombiner` columns (a few bytes a finished job), the per-chunk
solve outputs (r*, theory curves) and the index of the next chunk.
Everything else (draws, blocks) is recomputable from the uniform source
and the global chunk index, because every draw is keyed by its global
coordinates (`sim.draws.Philox.uniform_rows`): so `resume_fleet` gives
the uninterrupted run's bits.

Storage rides on `repro_torch.ckpt`: atomic step directories, a
torn-write-proof `latest_step`, `AsyncCheckpointer` so the write runs off
the chunk loop, `gc_old` for bounded retention. The payload describes
itself (a uint8 JSON header leaf naming the fields, then one numpy leaf a
field, the reference's layout) and is read back through
`ckpt.load_leaves`, so a fresh process can resume.

The header carries a run fingerprint (path, strategy, trace size,
chunking, the uniform source's seed, the fault plan's fingerprint, ...):
a resume refuses to continue a checkpoint written under another
configuration, which would splice two runs together.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Optional, Union

import numpy as np

from .. import ckpt
from ..sim.metrics import StreamCombiner

_VERSION = 1


@dataclass(frozen=True)
class CheckpointConfig:
    """Where and how often a fleet run checkpoints its chunk state.

    every:     checkpoint after every `every`-th chunk (the final chunk
               and any chunk a crash event follows always checkpoint).
    keep:      bounded retention: `ckpt.gc_old` keeps this many steps.
    use_async: write on `ckpt.AsyncCheckpointer`'s worker thread (a crash
               boundary still waits, so SimulatedCrash never outruns its
               own commit).
    """
    directory: Union[str, Path]
    every: int = 1
    keep: int = 3
    use_async: bool = True

    def sub(self, name: str) -> "CheckpointConfig":
        """The config for a per-strategy subdirectory (run_all_fleet gives
        each strategy its own checkpoint stream)."""
        return replace(self, directory=Path(self.directory) / name)


def as_checkpoint(obj) -> Optional[CheckpointConfig]:
    """Normalize the runners' `checkpoint=` argument: None, a path or a
    CheckpointConfig."""
    if obj is None or isinstance(obj, CheckpointConfig):
        return obj
    if isinstance(obj, (str, Path)):
        return CheckpointConfig(directory=obj)
    raise TypeError(f"checkpoint must be a path or CheckpointConfig, "
                    f"got {type(obj).__name__}")


class ChunkCheckpointer:
    """The chunk loops' use of `ckpt`: async or sync save plus gc,
    committed-step discovery, and a load that needs no structure."""

    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        self._async = (ckpt.AsyncCheckpointer(cfg.directory, keep=cfg.keep)
                       if cfg.use_async else None)

    def save(self, step: int, leaves: list) -> None:
        if self._async is not None:
            self._async.save(step, leaves)
        else:
            ckpt.save(self.cfg.directory, step, leaves)
            ckpt.gc_old(self.cfg.directory, keep=self.cfg.keep)

    def wait(self) -> None:
        if self._async is not None:
            self._async.wait()

    def latest(self) -> Optional[int]:
        return ckpt.latest_step(self.cfg.directory)

    def load(self, step: int) -> list:
        return ckpt.load_leaves(self.cfg.directory, step)


def pack_state(arrays: dict, *, next_chunk: int, fingerprint: dict) -> list:
    """[uint8 JSON header, *numpy leaves]: the header names the field
    order, so a load needs no like_tree."""
    header = {"version": _VERSION, "next_chunk": int(next_chunk),
              "fingerprint": fingerprint, "fields": list(arrays)}
    blob = np.frombuffer(
        json.dumps(header, sort_keys=True).encode("utf-8"), np.uint8)
    return [blob] + [np.asarray(arrays[k]) for k in arrays]


def unpack_state(leaves: list):
    """(header dict, {name: array}) from a pack_state leaf list."""
    header = json.loads(np.asarray(leaves[0]).tobytes().decode("utf-8"))
    if header.get("version") != _VERSION:
        raise ValueError(f"unsupported checkpoint version "
                         f"{header.get('version')!r}")
    fields = header["fields"]
    if len(leaves) != len(fields) + 1:
        raise ValueError(f"checkpoint names {len(fields)} fields but "
                         f"carries {len(leaves) - 1} leaves")
    return header, dict(zip(fields, leaves[1:]))


def pack_run_state(acc: StreamCombiner, solves, *, next_chunk: int,
                   fingerprint: dict) -> list:
    """The chunk loop's whole state: the combiner's columns and the
    per-chunk solve outputs, concatenated (the combiner's per-chunk
    weights restore the chunk boundaries). Host numpy only."""
    arrays = {f"acc_{k}": v for k, v in acc.state_dict().items()}
    r_parts, thp_parts, thc_parts = solves
    arrays["r_opt"] = np.concatenate(r_parts)
    arrays["th_p"] = np.concatenate(thp_parts)
    arrays["th_c"] = np.concatenate(thc_parts)
    return pack_state(arrays, next_chunk=next_chunk,
                      fingerprint=fingerprint)


def unpack_run_state(leaves: list):
    """(header, StreamCombiner, (r_parts, thp_parts, thc_parts))."""
    header, arrays = unpack_state(leaves)
    acc = StreamCombiner.from_state(
        {k[len("acc_"):]: v for k, v in arrays.items()
         if k.startswith("acc_")})
    w = np.asarray(arrays["acc_weights"], np.float64)
    splits = np.cumsum(w.astype(np.int64))[:-1]
    solves = tuple(list(np.split(np.asarray(arrays[k]), splits))
                   for k in ("r_opt", "th_p", "th_c"))
    return header, acc, solves


def check_fingerprint(stored: dict, current: dict) -> None:
    """Refuse to resume a checkpoint written under another run
    configuration (strategy, trace, chunking, source seed or fault plan):
    splicing two runs would be silent corruption."""
    if stored == current:
        return
    diffs = sorted(k for k in set(stored) | set(current)
                   if stored.get(k) != current.get(k))
    raise ValueError(
        "checkpoint fingerprint mismatch: refusing to resume under a "
        "different run configuration; differing fields: "
        + ", ".join(f"{k}: stored={stored.get(k)!r} != "
                    f"current={current.get(k)!r}" for k in diffs))


def run_fingerprint(**kw) -> dict:
    """A JSON-safe fingerprint dict of the runner's configuration (numpy
    scalars become Python numbers, arrays hex strings)."""
    out = {}
    for k, v in kw.items():
        if v is None or isinstance(v, (bool, int, float, str)):
            out[k] = v
        else:
            a = np.asarray(v)
            out[k] = (a.item() if a.ndim == 0 else a.tobytes().hex())
    return out


def source_id(source):
    """What a run fingerprint stores of its uniform source: the seed of a
    `sim.draws.Philox` (the port has no JAX key), else the source's type
    name."""
    seed = getattr(source, "seed", None)
    return int(seed) if seed is not None else type(source).__name__


def resume_fleet(source, jobs, strategy, p, *, checkpoint, chaos=None,
                 **kw):
    """Finish an interrupted `run_fleet_strategy` from its latest committed
    checkpoint, bit for bit the uninterrupted run. Pass the arguments of
    the original run (the fingerprint check enforces those that matter)
    and its `checkpoint`; a fresh process needs nothing else."""
    from ..fleet.runner import run_fleet_strategy
    return run_fleet_strategy(source, jobs, strategy, p, chaos=chaos,
                              checkpoint=checkpoint, resume=True, **kw)


def resume_cluster_fleet(source, jobs, strategy, p, *, checkpoint,
                         chaos=None, **kw):
    """The capacity twin of `resume_fleet`: resume at a window boundary."""
    from ..fleet.cluster import run_cluster_fleet_strategy
    return run_cluster_fleet_strategy(source, jobs, strategy, p, chaos=chaos,
                                      checkpoint=checkpoint, resume=True,
                                      **kw)
