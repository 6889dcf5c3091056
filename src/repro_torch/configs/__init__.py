"""Architecture registry of the port: the ten assigned architectures in
the reference's order (`ASSIGNED`), and the paper's evaluation models
(`PAPER_MODELS`: configurations for the device models and simulators of
`core`, which the engine does not serve).  `get_config(name)` resolves any
of them, and ``<name>-smoke`` to its reduced twin; the shape cells of the
launch path (`SHAPES`, `ShapeCell`, `applicable_shapes`, `skipped_shapes`,
`microbatch_plan`) come with them, as the reference exports them."""
from __future__ import annotations

from repro_torch.configs.base import (SHAPES, HybridConfig, ModelConfig,
                                     MoEConfig, ShapeCell, SSMConfig,
                                     applicable_shapes, microbatch_plan,
                                     skipped_shapes)
from repro_torch.configs.command_r_plus_104b import \
    CONFIG as COMMAND_R_PLUS_104B
from repro_torch.configs.deepseek_67b import CONFIG as DEEPSEEK_67B
from repro_torch.configs.granite_8b import CONFIG as GRANITE_8B
from repro_torch.configs.granite_moe_1b_a400m import \
    CONFIG as GRANITE_MOE_1B_A400M
from repro_torch.configs.hubert_xlarge import CONFIG as HUBERT_XLARGE
from repro_torch.configs.mamba2_1_3b import CONFIG as MAMBA2_1_3B
from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE_1B_7B
from repro_torch.configs.paper_models import (GPT3_66B, GPT3_175B, LLAMA_65B,
                                              OPT_30B)
from repro_torch.configs.qwen2_0_5b import CONFIG as QWEN2_0_5B
from repro_torch.configs.qwen2_vl_7b import CONFIG as QWEN2_VL_7B
from repro_torch.configs.zamba2_1_2b import CONFIG as ZAMBA2_1_2B

ASSIGNED: tuple[ModelConfig, ...] = (
    QWEN2_0_5B,
    COMMAND_R_PLUS_104B,
    DEEPSEEK_67B,
    GRANITE_8B,
    ZAMBA2_1_2B,
    GRANITE_MOE_1B_A400M,
    OLMOE_1B_7B,
    QWEN2_VL_7B,
    HUBERT_XLARGE,
    MAMBA2_1_3B,
)

PAPER_MODELS: tuple[ModelConfig, ...] = (LLAMA_65B, GPT3_66B, GPT3_175B,
                                          OPT_30B)

_REGISTRY: dict[str, ModelConfig] = {c.name: c
                                     for c in ASSIGNED + PAPER_MODELS}


def arch_names() -> list[str]:
    return [c.name for c in ASSIGNED]


def get_config(name: str) -> ModelConfig:
    """Resolve an architecture id (or `<id>-smoke` for its reduced twin)."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")


__all__ = ["ASSIGNED", "PAPER_MODELS", "SHAPES", "HybridConfig",
           "ModelConfig", "MoEConfig", "SSMConfig", "ShapeCell",
           "applicable_shapes", "arch_names", "get_config",
           "microbatch_plan", "skipped_shapes"]
