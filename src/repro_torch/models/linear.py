"""The FC execution-path hook — where PAPI's scheduling decision lands.

Every FC projection (QKV, out-proj, FFN) goes through `papi_linear`.  A
context-local variant selects its path:

  "pu"  (default) — ``torch.matmul``: the compute-bound path.
  "pim"           — the weight-streaming `fc_gemv` kernel: the memory-bound
                    path (FC-PIM analogue).

The serving engine sets the variant per decode iteration from
`core.scheduler.PapiScheduler`.  The mesh split of the reference
(`shard_map` FC banks) is not ported yet.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.kernels.fc_gemv import fc_gemv

_state = threading.local()


def current_fc_variant() -> str:
    return getattr(_state, "variant", "pu")


@contextlib.contextmanager
def fc_variant(variant: str):
    if variant not in ("pu", "pim"):
        raise ValueError(f"fc variant must be 'pu' or 'pim', not {variant!r}")
    prev = current_fc_variant()
    _state.variant = variant
    try:
        yield
    finally:
        _state.variant = prev


def papi_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] through the scheduled FC path."""
    if current_fc_variant() == "pim":
        lead = x.shape[:-1]
        out = fc_gemv(x.reshape(-1, x.shape[-1]).contiguous(), w)
        return out.reshape(*lead, w.shape[1])
    return torch.matmul(x, w)
