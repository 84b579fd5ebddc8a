"""Architecture configs ported so far; counterpart of `repro.configs`.

Only gemma2-2b, the reference's serving model, is registered; the other
architectures of `repro.configs` wait for later slices (ROADMAP.md), and
`get_config` on them raises a KeyError that says so.
"""
from .base import ArchConfig, get_config, list_configs, register

from . import gemma2_2b

ALL_ARCHS = ("gemma2-2b",)

__all__ = ["ALL_ARCHS", "ArchConfig", "get_config", "list_configs",
           "register"]
