"""Arithmetic-intensity estimate (PAPI §5.1, Eq. 2): AI ~= RLP * TLP.

For the FC kernel with weight (h, h_out) and input (m, h), m = RLP*TLP,
AI = 2*m*h*h_out / ((m*h + m*h_out + h*h_out) * bytes), which tends to m
for large h — the O(1) online estimate the scheduler compares with alpha.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def effective_parallelism(cfg: ModelConfig, rlp: int, tlp: int) -> float:
    """Decoding parallelism as seen by the FC weights: every token of a
    dense model touches every weight, so m = RLP*TLP."""
    del cfg  # dense only in this port; MoE scales by top_k / experts
    return float(rlp * tlp)
