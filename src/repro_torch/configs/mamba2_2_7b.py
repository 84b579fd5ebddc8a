"""mamba2-2.7b — pure SSM, SSD (state-space duality) [arXiv:2405.21060].

Attention-free; n_heads/head_dim below describe the SSD multi-head layout
(d_inner = 2*2560 = 5120, head_dim 64 -> 80 SSD heads), not attention.
vocab 50280 is padded to 50304 (`models.transformer.padded_vocab`, a
multiple of 32) for the embedding and the lm head.
"""
from .base import ArchConfig, SSMCfg, register

CONFIG = register(ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMCfg(d_state=128, expand=2, head_dim=64, conv_width=4, chunk=256),
    optimizer="adamw",
    remat="full",
    source="arXiv:2405.21060; hf:state-spaces/mamba2-2.7b",
))
