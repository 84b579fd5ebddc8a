"""Architecture configs ported so far; counterpart of `repro.configs`.

The dense text architectures are registered: gemma2-2b (the serving and
training model on the card), mistral-nemo-12b (the training launcher's
default), chatglm3-6b (RoPE on half the head dim) and deepseek-coder-33b.
The other families of `repro.configs` wait for later slices (ROADMAP.md),
and `get_config` on them raises a KeyError that says so.
"""
from .base import ArchConfig, get_config, list_configs, register

from . import deepseek_coder_33b
from . import gemma2_2b
from . import mistral_nemo_12b
from . import chatglm3_6b

ALL_ARCHS = ("deepseek-coder-33b", "gemma2-2b", "mistral-nemo-12b",
             "chatglm3-6b")

__all__ = ["ALL_ARCHS", "ArchConfig", "get_config", "list_configs",
           "register"]
