"""arctic-480b — MoE 128 experts top-2 with a parallel dense residual FFN
[hf:Snowflake/snowflake-arctic-base].

Policy notes (DESIGN.md §6): Adafactor + bf16 params — AdamW states for 480B
parameters exceed v5e HBM on a 256-chip pod.
"""
from .base import ArchConfig, MoECfg, register

CONFIG = register(ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    activation="swiglu",
    moe=MoECfg(n_experts=128, top_k=2, d_ff=4864, capacity_factor=1.25,
               dense_residual=True, dense_d_ff=4864),
    optimizer="adafactor",
    param_dtype="bfloat16",
    remat="full",
    source="hf:Snowflake/snowflake-arctic-base",
))
