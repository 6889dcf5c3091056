"""qwen2-vl-7b — VLM backbone, M-RoPE, GQA kv=4. [arXiv:2409.12191; hf]

Only the transformer BACKBONE is modeled; the vision frontend is a stub:
a batch may carry precomputed patch embeddings (``patch_embeds``) ahead of
the text token ids, with their M-RoPE position triples (``positions``
[b, 3, s]).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3_584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18_944,
    vocab_size=152_064,
    head_dim=128,
    qkv_bias=True,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    m_rope=True,
    m_rope_sections=(16, 24, 24),   # temporal/height/width freq split of hd/2
)
