"""Model configuration: the port's own copy of the dense subset of
`repro.configs.base.ModelConfig` (the fields the dense serving path reads,
`resolved_head_dim`, `group_size` and the `reduced()` smoke twin)."""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int          # query heads
    num_kv_heads: int       # GQA KV heads
    d_ff: int               # dense FFN hidden dim
    vocab_size: int

    head_dim: int = 0       # 0 -> d_model // num_heads
    qkv_bias: bool = False
    mlp: Literal["swiglu", "gelu"] = "swiglu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    causal: bool = True
    decoder: bool = True
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def group_size(self) -> int:
        if self.num_kv_heads == 0:
            return 1
        return max(self.num_heads // self.num_kv_heads, 1)

    @property
    def has_decode_step(self) -> bool:
        return self.decoder

    def reduced(self) -> "ModelConfig":
        """A tiny config of the same family for CPU tests — the same
        derivation as the reference's `reduced()`, so both packages build
        identical smoke shapes."""
        num_kv = min(self.num_kv_heads, 2) if self.num_kv_heads else 0
        if self.num_kv_heads and self.num_kv_heads == self.num_heads:
            num_kv = 4          # full MHA stays MHA
        return ModelConfig(
            name=self.name + "-smoke",
            family=self.family,
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=num_kv,
            d_ff=256 if self.d_ff else 0,
            vocab_size=256,
            head_dim=32 if self.num_heads else 0,
            qkv_bias=self.qkv_bias,
            mlp=self.mlp,
            norm=self.norm,
            norm_eps=self.norm_eps,
            rope_theta=self.rope_theta,
            tie_embeddings=self.tie_embeddings,
            causal=self.causal,
            decoder=self.decoder,
            dtype="float32",
        )
