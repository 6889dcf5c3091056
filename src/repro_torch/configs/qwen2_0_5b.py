"""qwen2-0.5b — dense, GQA kv=2, QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151_936,
    head_dim=64,           # 896 / 14
    qkv_bias=True,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=True,   # qwen2-0.5b ties lm_head to embeddings
)
