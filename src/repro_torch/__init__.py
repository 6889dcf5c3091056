"""PyTorch / CUDA port of the PAPI serving system.

The JAX package `repro` is the reference; this package reproduces its
dense serving path on an NVIDIA H100 with hand-written CUDA kernels for the
two PIM analogues (`kernels.fc_gemv` for FC-PIM, `kernels.decode_attention`
for Attn-PIM).  It imports torch and numpy only — never jax, never `repro`.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
CUDA request on a host without a card raises instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The port's device rule: default ``cuda``; asking for a card that is
    not there raises (no silent CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on cuda by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
