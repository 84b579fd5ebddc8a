"""hubert-xlarge — encoder-only audio transformer [arXiv:2106.07447].

The conv waveform frontend is stubbed per the brief: input_specs() provides
precomputed frame features (B, S, 512) which a linear layer projects to
d_model. Training objective: masked-prediction CE over 504 cluster targets.
Encoder-only: no decode shapes (recorded as skips).
"""
from .base import ArchConfig, AudioStubCfg, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,          # cluster targets; padded to 512 for vocab TP
    causal=False,            # bidirectional encoder
    activation="gelu",
    audio=AudioStubCfg(frame_dim=512),
    optimizer="adamw",
    remat="full",
    source="arXiv:2106.07447; hf:facebook/hubert-xlarge-ll60k",
))
