"""deepseek-67b — dense llama-arch, GQA kv=8, 95 layers. [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8_192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22_016,
    vocab_size=102_400,
    head_dim=128,
    qkv_bias=False,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
)
