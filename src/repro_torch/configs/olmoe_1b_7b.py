"""olmoe-1b-7b — MoE 64 experts top-8 [arXiv:2409.02060; hf]."""
from .base import ArchConfig, MoECfg, register

CONFIG = register(ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,                # per-expert hidden (kept in MoECfg too)
    vocab_size=50304,
    activation="swiglu",
    moe=MoECfg(n_experts=64, top_k=8, d_ff=1024, capacity_factor=1.25),
    optimizer="adamw",
    remat="full",
    source="arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924",
))
