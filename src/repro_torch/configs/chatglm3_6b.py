"""chatglm3-6b — dense, 2d (half-dim) RoPE, 2 kv heads [arXiv:2406.12793; hf]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    rope_fraction=0.5,       # RoPE applied to half of each head dim ("RoPE 2d")
    activation="swiglu",
    optimizer="adamw",
    remat="full",
    source="arXiv:2406.12793; hf:THUDM/chatglm3-6b",
))
