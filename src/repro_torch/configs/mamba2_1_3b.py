"""mamba2-1.3b — attention-free SSM (SSD / state-space duality).
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2_048,
    num_heads=0,           # attention-free
    num_kv_heads=0,
    d_ff=0,                # no FFN: the Mamba2 block subsumes it (expand=2)
    vocab_size=50_280,
    norm="rmsnorm",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4,
                  chunk_size=256),
    tie_embeddings=True,
)
