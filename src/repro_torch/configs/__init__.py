"""Architecture configs ported so far; counterpart of `repro.configs`.

The four transformer families of the reference are registered: dense
(gemma2-2b, the serving and training model on the card; mistral-nemo-12b,
the training launcher's default; chatglm3-6b, RoPE on half the head dim;
deepseek-coder-33b), moe (olmoe-1b-7b; arctic-480b, whose 480 B
parameters run at `reduced()` only), vlm (paligemma-3b, prefix-LM mask
over its patches) and audio (hubert-xlarge, a bidirectional encoder of
head dim 80). The ssm and hybrid families (mamba2-2.7b, zamba2-7b) wait
for a later slice (ROADMAP.md), and `get_config` on them raises a
KeyError that says so.
"""
from .base import ArchConfig, get_config, list_configs, register

from . import deepseek_coder_33b
from . import gemma2_2b
from . import mistral_nemo_12b
from . import chatglm3_6b
from . import paligemma_3b
from . import olmoe_1b_7b
from . import arctic_480b
from . import hubert_xlarge

ALL_ARCHS = ("deepseek-coder-33b", "gemma2-2b", "mistral-nemo-12b",
             "chatglm3-6b", "paligemma-3b", "olmoe-1b-7b", "arctic-480b",
             "hubert-xlarge")

__all__ = ["ALL_ARCHS", "ArchConfig", "get_config", "list_configs",
           "register"]
