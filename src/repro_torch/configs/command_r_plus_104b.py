"""command-r-plus-104b — dense, GQA kv=8, no biases.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12_288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33_792,
    vocab_size=256_000,
    head_dim=128,
    qkv_bias=False,
    mlp="swiglu",
    norm="layernorm",      # cohere uses LayerNorm (no bias in our impl)
    rope_theta=75_000_000.0,
    tie_embeddings=True,   # cohere ties embeddings
)
