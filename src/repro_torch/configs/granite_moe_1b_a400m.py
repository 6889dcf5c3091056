"""granite-moe-1b-a400m — MoE 32 experts top-8, per-expert d_ff=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1_024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=0,                # MoE: see moe.d_ff (per-expert)
    vocab_size=49_155,
    head_dim=64,
    qkv_bias=False,
    mlp="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(num_experts=32, top_k=8, d_ff=512),
    tie_embeddings=True,
)
