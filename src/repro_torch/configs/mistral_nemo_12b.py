"""mistral-nemo-12b — dense, 128k context [hf:mistralai/Mistral-Nemo-Base-2407]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131_072,
    rope_theta=1_000_000.0,
    activation="swiglu",
    optimizer="adamw",
    remat="full",
    source="hf:mistralai/Mistral-Nemo-Base-2407",
))
