"""Arithmetic-intensity estimation (PAPI §5.1, Eq. 1 / Eq. 2) — the
port's copy of `repro.core.ai`.

The FC kernel with weight matrix (h, h_out) and input (m, h), m = RLP*TLP:

    AI = #Flops / #Bytes
       = (m * h * h_out * 2) / ((m*h + m*h_out + h*h_out) * bytes_per_el)

For the paper's square case (h_out = h) and fp16 this is Eq. 1:

    AI = (m * h^2 * 2) / ((2*m*h + h^2) * 2)

and in the large-h limit AI -> m = RLP * TLP (Eq. 2) — the O(1) online
estimate the scheduler uses.  `ai_error` quantifies the Eq.1-vs-Eq.2 gap
(Fig. 6; largest for small-h archs like qwen2-0.5b).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def fc_ai_exact(m: int, h: int, h_out: int | None = None,
                bytes_per_el: int = 2) -> float:
    """Eq. 1 (generalized to rectangular FC weights)."""
    if h_out is None:
        h_out = h
    flops = 2.0 * m * h * h_out
    byts = (m * h + m * h_out + h * h_out) * bytes_per_el
    return flops / byts


def fc_ai_estimate(rlp: int, tlp: int) -> float:
    """Eq. 2: AI ~= RLP * TLP."""
    return float(rlp * tlp)


def ai_error(m: int, h: int) -> float:
    """Relative error of Eq. 2 vs Eq. 1 for the paper's square FC."""
    exact = fc_ai_exact(m, h)
    return abs(fc_ai_estimate(m, 1) * 1.0 - exact) / exact


def effective_parallelism(cfg: ModelConfig, rlp: int, tlp: int) -> float:
    """Decoding parallelism as seen by the *FC weights* of this arch.

    Dense FC: every token touches every weight -> m = RLP*TLP.
    MoE expert FC (paper §6.5): each expert sees only its routed share, so
    per-expert parallelism is RLP*TLP*top_k/E — experts stay memory-bound
    far longer.  This is PAPI's MoE observation made quantitative.
    """
    m = float(rlp * tlp)
    if cfg.moe is not None and cfg.moe.num_experts:
        return m * cfg.moe.top_k / cfg.moe.num_experts
    return m


def attention_ai(tlp: int, bytes_per_el: int = 2) -> float:
    """Attention AI per KV byte: ~2*TLP flops per KV element read.

    Independent of RLP (no cross-request KV reuse) — the reason attention is
    always memory-bound and lives on Attn-PIM.
    """
    return 2.0 * tlp / bytes_per_el
