"""Atomic, async checkpoints of tensor trees; counterpart of `repro.ckpt`,
in its on-disk layout."""
from . import checkpoint
from .checkpoint import (AsyncCheckpointer, gc_old, latest_step,
                         load_leaves, restore, save)

__all__ = ["AsyncCheckpointer", "checkpoint", "gc_old", "latest_step",
           "load_leaves", "restore", "save"]
