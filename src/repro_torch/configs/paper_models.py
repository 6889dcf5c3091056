"""The paper's own evaluation models (PAPI §7.1) plus OPT-30B (§3.1
roofline) — the port's copy of `repro.configs.paper_models`.

They drive the device models and system simulators of `core`, and are
data only here: the port's model refuses the gelu MLP of GPT-3 and OPT
(`models.model._check_family`), and no entry point serves LLaMA-65B.
"""
from repro_torch.configs.base import ModelConfig

# LLaMA-65B [arXiv:2302.13971]
LLAMA_65B = ModelConfig(
    name="llama-65b",
    family="dense",
    num_layers=80,
    d_model=8_192,
    num_heads=64,
    num_kv_heads=64,       # LLaMA-1: full MHA
    d_ff=22_016,
    vocab_size=32_000,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
)

# GPT-3 66B: the paper's "GPT-3 66B" matches the GPT-3 family scaling row
# (66B ~ h=9216, 64 layers, 72 heads) [arXiv:2005.14165 table 2.1 interp.]
GPT3_66B = ModelConfig(
    name="gpt3-66b",
    family="dense",
    num_layers=64,
    d_model=9_216,
    num_heads=72,
    num_kv_heads=72,
    d_ff=36_864,           # 4h
    vocab_size=50_257,
    head_dim=128,
    qkv_bias=True,
    mlp="gelu",
    norm="layernorm",
)

# GPT-3 175B [arXiv:2005.14165]
GPT3_175B = ModelConfig(
    name="gpt3-175b",
    family="dense",
    num_layers=96,
    d_model=12_288,
    num_heads=96,
    num_kv_heads=96,
    d_ff=49_152,           # 4h
    vocab_size=50_257,
    head_dim=128,
    qkv_bias=True,
    mlp="gelu",
    norm="layernorm",
)

# OPT-30B (used for the paper's Fig. 2 roofline study) [arXiv:2205.01068]
OPT_30B = ModelConfig(
    name="opt-30b",
    family="dense",
    num_layers=48,
    d_model=7_168,
    num_heads=56,
    num_kv_heads=56,
    d_ff=28_672,           # 4h
    vocab_size=50_272,
    head_dim=128,
    qkv_bias=True,
    mlp="gelu",
    norm="layernorm",
)
