"""Model configuration: the port's own copy of the subset of
`repro.configs.base` that the serving path and the core read —
`ModelConfig` with its dense, MoE (`MoEConfig`), SSM (`SSMConfig`,
Mamba2), hybrid (`HybridConfig`, zamba2) and M-RoPE (qwen2-vl) fields,
`resolved_head_dim`, `group_size`, `num_attention_applications` and the
`reduced()` smoke twin."""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    # per-expert FFN hidden dim (an MoE model's d_ff is 0)
    d_ff: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # load-balancing aux loss weight (Switch-style)
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block configuration."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk_size: int = 256
    # A = -exp(A_log) lies in [-a_max, -a_min]: A_log = log U[a_min, a_max]
    a_min: float = 1.0
    a_max: float = 16.0

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """zamba2-style layout: a backbone of Mamba2 blocks with one *shared*
    attention+MLP block applied after every `period` backbone blocks."""
    period: int = 6


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
    # M-RoPE (qwen2-vl): positions are (temporal, height, width) triples;
    # the hd/2 rotary frequencies are split into 3 sections
    m_rope: bool = False
    m_rope_sections: Sequence[int] = (16, 24, 24)
    tie_embeddings: bool = False
    causal: bool = True     # encoder-only archs set False
    decoder: bool = True    # False: encoder-only (no KV cache, no decode)
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    hybrid: HybridConfig | None = None
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
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_decode_step(self) -> bool:
        return self.decoder

    def num_attention_applications(self) -> int:
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            assert self.hybrid is not None
            return self.num_layers // self.hybrid.period
        return self.num_layers

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
            num_layers=min(self.num_layers,
                           4 if self.family == "hybrid" else 2),
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
            m_rope=self.m_rope,
            m_rope_sections=((8, 12, 12) if self.m_rope
                             else self.m_rope_sections),
            tie_embeddings=self.tie_embeddings,
            causal=self.causal,
            decoder=self.decoder,
            moe=(MoEConfig(num_experts=min(self.moe.num_experts, 4),
                           top_k=min(self.moe.top_k, 2), d_ff=64,
                           capacity_factor=self.moe.capacity_factor)
                 if self.moe is not None else None),
            ssm=(SSMConfig(d_state=16, head_dim=32, expand=2,
                           conv_kernel=self.ssm.conv_kernel, chunk_size=32)
                 if self.ssm is not None else None),
            hybrid=HybridConfig(period=2) if self.hybrid is not None else None,
            dtype="float32",
        )
