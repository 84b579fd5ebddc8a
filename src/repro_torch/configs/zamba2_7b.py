"""zamba2-7b — hybrid: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified].

Block schedule: 81 layers total. 13 super-groups of (5 mamba + 1
shared-attention application) = 78 layers, then 3 trailing mamba layers,
giving 81 (`models.model._hybrid_layout`). The attention block (32 MHA heads, head_dim 112, d_ff 14336
MLP) has a SINGLE weight set shared by all 13 applications, as in the paper.
"""
from .base import ArchConfig, SSMCfg, HybridCfg, register

CONFIG = register(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    activation="swiglu",
    ssm=SSMCfg(d_state=64, expand=2, head_dim=64, conv_width=4, chunk=256),
    hybrid=HybridCfg(shared_attn_every=6, shared_d_ff=14336),
    optimizer="adamw",
    remat="full",
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-7B",
))
