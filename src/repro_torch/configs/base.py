"""Architecture configuration system; counterpart of `repro.configs.base`,
copied field for field so a config means the same in both packages.

Each ported architecture gets one file in this package defining an
`ArchConfig` with the exact published dimensions, registered under its id.
`ArchConfig.reduced()` yields a structurally identical but tiny config for CPU
smoke tests (same family, same block pattern, same divisibility paths).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden
    capacity_factor: float = 1.25
    dense_residual: bool = False  # Arctic: parallel dense FFN branch
    dense_d_ff: int = 0           # width of that branch
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMCfg:
    d_state: int
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 256              # SSD chunk length (training path)
    intra_dtype: str = "float32"  # SSD intra-chunk matmul dtype (perf lever)
    n_groups: int = 1


@dataclass(frozen=True)
class HybridCfg:
    shared_attn_every: int = 6    # apply the shared attention block every k layers
    shared_d_ff: int = 0          # MLP width inside the shared block


@dataclass(frozen=True)
class VisionStubCfg:
    n_patches: int = 256
    embed_dim: int = 1152         # SigLIP-So400m output width


@dataclass(frozen=True)
class AudioStubCfg:
    frame_dim: int = 512          # conv-frontend feature width (stubbed)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention details
    causal: bool = True
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0    # chatglm3: rotary on half the head dim
    sliding_window: Optional[int] = None
    alt_local_global: bool = False  # gemma2: alternate local/global layers
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    post_block_norms: bool = False  # gemma2 style pre+post norms
    embed_scale: bool = False       # gemma family: scale embeddings by sqrt(d)
    activation: str = "swiglu"      # swiglu | geglu | gelu
    attn_impl: str = "einsum"       # einsum | blocked (flash-style scan)
    norm_eps: float = 1e-6
    # family extensions
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    hybrid: Optional[HybridCfg] = None
    vision: Optional[VisionStubCfg] = None
    audio: Optional[AudioStubCfg] = None
    # training policy
    optimizer: str = "adamw"      # adamw | adafactor
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"           # full | dots | none
    # source provenance
    source: str = ""

    # ---- derived ----
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k shape."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        """Encoder-only archs have no autoregressive decode step."""
        return self.family != "audio"

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * 2  # embed + untied lm head
        attn = d * self.n_heads * self.head_dim * 2 \
            + d * self.n_kv_heads * self.head_dim * 2
        if self.activation in ("swiglu", "geglu"):
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        per_layer = attn + mlp
        if self.moe is not None:
            e_mlp = 3 * d * self.moe.d_ff
            per_layer = attn + self.moe.n_experts * e_mlp + d * self.moe.n_experts
            if self.moe.dense_residual:
                per_layer += 3 * d * self.moe.dense_d_ff
        if self.family == "ssm" and self.ssm is not None:
            di = self.ssm.expand * d
            per_layer = d * (2 * di + 2 * self.ssm.n_groups * self.ssm.d_state
                             + di // self.ssm.head_dim) + di * d
        if self.family == "hybrid" and self.ssm is not None:
            di = self.ssm.expand * d
            per_layer = d * (2 * di + 2 * self.ssm.n_groups * self.ssm.d_state
                             + di // self.ssm.head_dim) + di * d
        return emb + L * per_layer

    def active_param_count(self) -> int:
        """Activated params per token (MoE uses top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * 2
        attn = d * self.n_heads * self.head_dim * 2 \
            + d * self.n_kv_heads * self.head_dim * 2
        e_mlp = 3 * d * self.moe.d_ff
        per_layer = attn + self.moe.top_k * e_mlp + d * self.moe.n_experts
        if self.moe.dense_residual:
            per_layer += 3 * d * self.moe.dense_d_ff
        return emb + L * per_layer

    def reduced(self) -> "ArchConfig":
        """Tiny, structurally identical config for CPU smoke tests."""
        kw: dict = dict(
            n_layers=max(2, 4 if self.family in ("hybrid",) else 2),
            d_model=64,
            n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 4) if
                                      self.n_kv_heads < self.n_heads else 4),
            head_dim=16, d_ff=128, vocab_size=256,
        )
        if self.alt_local_global:
            kw["sliding_window"] = 8
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=8, top_k=min(self.moe.top_k, 2), d_ff=32,
                dense_d_ff=32 if self.moe.dense_residual else 0)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=8, head_dim=8, chunk=8)
        if self.hybrid is not None:
            kw["hybrid"] = dataclasses.replace(self.hybrid, shared_attn_every=2,
                                               shared_d_ff=128)
            kw["n_layers"] = 5
        if self.vision is not None:
            kw["vision"] = dataclasses.replace(self.vision, n_patches=4,
                                               embed_dim=32)
        if self.audio is not None:
            kw["audio"] = dataclasses.replace(self.audio, frame_dim=24)
        return dataclasses.replace(self, name=self.name + "-reduced", **kw)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    # import the package to populate the registry
    from . import ALL_ARCHS  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"arch {name!r} is not ported; have "
                       f"{sorted(_REGISTRY)} (ROADMAP.md lists the "
                       f"configurations still to port)")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from . import ALL_ARCHS  # noqa: F401
    return sorted(_REGISTRY)
