"""hubert-xlarge — encoder-only audio transformer (w2v2 arch).
[arXiv:2106.07447; unverified]

Encoder-only: bidirectional attention, no KV cache, no decode step.  The
convolutional waveform frontend is a stub: inputs are precomputed frame
embeddings (batch, frames, d_model).  vocab_size=504 is the
masked-prediction codebook (k-means targets).  The port's model refuses it:
its encoder forward belongs with training (`models.model._check_family`).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1_280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5_120,
    vocab_size=504,
    head_dim=80,
    qkv_bias=True,
    mlp="gelu",
    norm="layernorm",
    causal=False,
    decoder=False,
)
