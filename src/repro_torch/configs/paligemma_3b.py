"""paligemma-3b — VLM: SigLIP (stub frontend) + gemma text decoder
[arXiv:2407.07726; hf]. The vision tower is stubbed per the brief:
input_specs() provides precomputed patch embeddings."""
from .base import ArchConfig, VisionStubCfg, register

CONFIG = register(ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257_216,
    activation="geglu",
    embed_scale=True,
    vision=VisionStubCfg(n_patches=256, embed_dim=1152),
    optimizer="adamw",
    remat="full",
    source="arXiv:2407.07726; hf:google/paligemma-3b-pt-224",
))
