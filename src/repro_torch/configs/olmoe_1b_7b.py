"""olmoe-1b-7b — MoE 64 experts top-8, per-expert d_ff=1024.
[arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2_048,
    num_heads=16,
    num_kv_heads=16,       # full MHA per assignment (kv=16)
    d_ff=0,
    vocab_size=50_304,
    head_dim=128,
    qkv_bias=False,
    mlp="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(num_experts=64, top_k=8, d_ff=1_024),
)
