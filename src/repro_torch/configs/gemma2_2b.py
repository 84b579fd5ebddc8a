"""gemma2-2b — dense, local+global alternating attention, logit softcaps
[arXiv:2408.00118; hf]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    activation="geglu",
    sliding_window=4096,
    alt_local_global=True,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_block_norms=True,
    embed_scale=True,
    optimizer="adamw",
    remat="full",
    source="arXiv:2408.00118; hf:google/gemma-2-2b",
))
