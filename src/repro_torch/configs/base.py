"""Model configuration: the port's own copy of the subset of
`repro.configs.base` that the serving path and the core read —
`ModelConfig` with its dense, MoE (`MoEConfig`), SSM (`SSMConfig`,
Mamba2), hybrid (`HybridConfig`, zamba2) and M-RoPE (qwen2-vl) fields,
`resolved_head_dim`, `group_size`, `num_attention_applications`, the
reference's analytic `param_count` and the `reduced()` smoke twin — and
the input-shape cells of the launch path (`ShapeCell`, `SHAPES`,
`applicable_shapes`, `skipped_shapes`, `microbatch_plan`)."""
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
    def has_subquadratic_path(self) -> bool:
        """True if the arch can serve 500k-token contexts without a
        quadratic KV-cache attention (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode_step(self) -> bool:
        return self.decoder

    def param_count(self) -> int:
        """The reference's analytic parameter count (its conv and
        hybrid terms included as it counts them): what `microbatch_plan`
        and the launch path's rule choice read."""
        h, nl = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        count = self.vocab_size * h                       # embed
        if not self.tie_embeddings and self.decoder:
            count += self.vocab_size * h                  # lm head
        count += h                                        # final norm
        attn = h * (self.num_heads * hd) + 2 * h * (self.num_kv_heads * hd)
        attn += (self.num_heads * hd) * h
        if self.qkv_bias:
            attn += self.num_heads * hd + 2 * self.num_kv_heads * hd
        if self.moe is not None and self.moe.num_experts:
            m = self.moe
            mlp = m.num_experts * 3 * h * m.d_ff + h * m.num_experts
        elif self.mlp == "swiglu":
            mlp = 3 * h * self.d_ff
        else:
            mlp = 2 * h * self.d_ff + self.d_ff + h
        if self.family in ("ssm", "hybrid"):
            s = self.ssm
            di, nh = s.d_inner(h), s.n_heads(h)
            ssm = (h * (2 * di + 2 * s.d_state + nh)
                   + s.conv_kernel * (di + 2 * s.d_state) + 3 * nh
                   + di * h + di)
            count += nl * (ssm + h)
            if self.family == "hybrid":
                count += attn + 3 * h * self.d_ff + 2 * h
            return count
        return count + nl * (attn + mlp + 2 * h)

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


# ---------------------------------------------------------------------------
# Input-shape cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """The cells that run for this arch: `long_500k` only on a
    sub-quadratic (SSM / hybrid) arch, no decode cell for an encoder."""
    return [name for name, cell in SHAPES.items()
            if not (cell.is_decode and not cfg.has_decode_step)
            and not (name == "long_500k" and not cfg.has_subquadratic_path)]


def skipped_shapes(cfg: ModelConfig) -> list[tuple[str, str]]:
    out = []
    for name, cell in SHAPES.items():
        if cell.is_decode and not cfg.has_decode_step:
            out.append((name, "encoder-only: no decode step"))
        elif name == "long_500k" and not cfg.has_subquadratic_path:
            out.append((name, "full attention is quadratic at 500k; "
                              "sub-quadratic path required"))
    return out


def microbatch_plan(cfg: ModelConfig, cell: ShapeCell,
                    data_shards: int) -> tuple[int, int]:
    """(microbatches, rows a microbatch) of a train cell: more
    microbatches for bigger models and big vocabularies (the logits
    dominate activation memory), halved until the data shards divide a
    microbatch's rows."""
    if cell.kind != "train":
        return 1, cell.global_batch
    n = cfg.param_count()
    accum = 8 if n > 50e9 else 4 if n > 5e9 else 2 if n > 1e9 else 1
    if cfg.vocab_size >= 100_000:
        accum = max(accum, 4)
    while (cell.global_batch // accum) % data_shards and accum > 1:
        accum //= 2
    return accum, cell.global_batch // accum
