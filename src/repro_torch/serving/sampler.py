"""Token sampling for the serving engine."""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits [..., V] -> token ids [...] (int32).  `torch.argmax` returns
    the first maximum, as `jnp.argmax` does, so ties break identically."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
