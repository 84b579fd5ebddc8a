"""A configuration file's sizes as the harness and the reference use
them. The file holds the published model's `config.json` keys, as run;
this reads them and nothing else."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelShape:
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int                 # the dense MLP's hidden, or each expert's
    vocab: int
    rope_theta: float
    norm_eps: float
    n_experts: int = 0        # 0: a dense MLP in every layer
    top_k: int = 0
    norm_topk: bool = True    # gates renormalised over the top k
    capacity_factor: float = 0.0
    aux_coef: float = 0.0

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    def capacity(self, seq: int) -> int:
        """Slots of each expert's buffer for a row of `seq` tokens."""
        c = int(seq * self.top_k / self.n_experts * self.capacity_factor)
        return max(c, self.top_k)


def shape_of(cfg: dict) -> ModelShape:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    kw = dict(d_model=d, n_layers=cfg["num_hidden_layers"], n_heads=h,
              n_kv_heads=cfg["num_key_value_heads"],
              head_dim=cfg.get("head_dim", d // h),
              d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
              rope_theta=float(cfg["rope_theta"]),
              norm_eps=float(cfg["rms_norm_eps"]))
    if cfg.get("num_experts"):
        kw.update(n_experts=cfg["num_experts"],
                  top_k=cfg["num_experts_per_tok"],
                  norm_topk=bool(cfg["norm_topk_prob"]),
                  capacity_factor=float(cfg["capacity_factor"]),
                  aux_coef=float(cfg["router_aux_loss_coef"]))
    return ModelShape(**kw)
