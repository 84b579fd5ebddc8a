"""Architecture configs ported so far; counterpart of `repro.configs`.

Every family of the reference is registered: dense
(gemma2-2b, the serving and training model on the card; mistral-nemo-12b,
the training launcher's default; chatglm3-6b, RoPE on half the head dim;
deepseek-coder-33b), moe (olmoe-1b-7b; arctic-480b, whose 480 B
parameters run at `reduced()` only), vlm (paligemma-3b, prefix-LM mask
over its patches), audio (hubert-xlarge, a bidirectional encoder of
head dim 80), ssm (mamba2-2.7b, Mamba2 layers only) and hybrid
(zamba2-7b, Mamba2 groups around one shared attention block of head dim
112): all ten of the reference's architectures. `chronos_sim` holds the
paper's own testbed and trace settings, and `SHAPES` /
`shape_applicable` the reference's (arch, shape) cells.
"""
from .base import ArchConfig, get_config, list_configs, register

from . import deepseek_coder_33b
from . import gemma2_2b
from . import mistral_nemo_12b
from . import chatglm3_6b
from . import paligemma_3b
from . import olmoe_1b_7b
from . import arctic_480b
from . import zamba2_7b
from . import mamba2_2_7b
from . import hubert_xlarge
from . import chronos_sim

ALL_ARCHS = ("deepseek-coder-33b", "gemma2-2b", "mistral-nemo-12b",
             "chatglm3-6b", "paligemma-3b", "olmoe-1b-7b", "arctic-480b",
             "zamba2-7b", "mamba2-2.7b", "hubert-xlarge")

# (shape name) -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def shape_applicable(arch: str, shape: str) -> tuple[bool, str]:
    """Whether an (arch, shape) cell runs, with the reason if skipped."""
    cfg = get_config(arch)
    kind = SHAPES[shape][2]
    if kind == "decode" and not cfg.has_decode:
        return False, "encoder-only arch has no autoregressive decode step"
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 500k dense KV cache exceeds "
                       "per-chip HBM; shape reserved for sub-quadratic archs")
    return True, ""


__all__ = ["ALL_ARCHS", "SHAPES", "ArchConfig", "chronos_sim", "get_config",
           "list_configs", "register", "shape_applicable"]
