"""zamba2-1.2b — hybrid Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]

38 Mamba2 backbone blocks; one *shared* (weight-tied) attention+MLP block
runs after every `period` backbone blocks (6 applications); blocks 36-37
form a remainder segment.
"""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2_048,
    num_heads=32,
    num_kv_heads=32,       # the shared attention block is full MHA
    d_ff=8_192,            # the shared block's MLP
    vocab_size=32_000,
    head_dim=64,
    qkv_bias=False,
    mlp="swiglu",
    norm="rmsnorm",
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_kernel=4,
                  chunk_size=256),
    hybrid=HybridConfig(period=6),
    tie_embeddings=True,
)
