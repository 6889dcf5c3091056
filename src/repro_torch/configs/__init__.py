"""Architecture registry of the port: the architectures it serves so far,
and the paper's evaluation models (`PAPER_MODELS`: configurations for the
device models and simulators of `core`, which the engine does not
serve)."""
from __future__ import annotations

from repro_torch.configs.base import (HybridConfig, ModelConfig, MoEConfig,
                                     SSMConfig)
from repro_torch.configs.mamba2_1_3b import CONFIG as MAMBA2_1_3B
from repro_torch.configs.paper_models import (GPT3_66B, GPT3_175B, LLAMA_65B,
                                              OPT_30B)
from repro_torch.configs.qwen2_0_5b import CONFIG as QWEN2_0_5B
from repro_torch.configs.zamba2_1_2b import CONFIG as ZAMBA2_1_2B

PAPER_MODELS: tuple[ModelConfig, ...] = (LLAMA_65B, GPT3_66B, GPT3_175B,
                                          OPT_30B)

_REGISTRY: dict[str, ModelConfig] = {
    c.name: c for c in (QWEN2_0_5B, MAMBA2_1_3B, ZAMBA2_1_2B) + PAPER_MODELS}


def get_config(name: str) -> ModelConfig:
    """Resolve an architecture id (or `<id>-smoke` for its reduced twin)."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")


__all__ = ["PAPER_MODELS", "HybridConfig", "ModelConfig", "MoEConfig",
           "SSMConfig", "get_config"]
