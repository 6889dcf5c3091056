"""The FC execution-path hook — where PAPI's scheduling decision lands.

Every FC projection (QKV, out-proj, FFN) goes through `papi_linear`, or
`papi_linear_group` for projections that share their input (q/k/v,
gate/up).  A context-local variant selects the path:

  "pu"  (default) — ``torch.matmul``, one per weight: the compute-bound
                    path.
  "pim"           — the weight-streaming `fc_gemv` kernel, one launch per
                    group: the memory-bound path (FC-PIM analogue).

The serving engine sets the variant per decode iteration from
`core.scheduler.PapiScheduler`.  The mesh split of the reference
(`shard_map` FC banks) is not ported yet.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.kernels.fc_gemv import fc_gemv_group

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


def papi_linear_group(x: torch.Tensor,
                      ws: list[torch.Tensor]) -> list[torch.Tensor]:
    """[x [..., K] @ w [K, N_i] for w in ws] through the scheduled FC path:
    under "pim" one `fc_gemv_group` launch for all of them."""
    if current_fc_variant() == "pim":
        lead = x.shape[:-1]
        outs = fc_gemv_group(x.reshape(-1, x.shape[-1]).contiguous(), ws)
        return [o.reshape(*lead, w.shape[1]) for o, w in zip(outs, ws)]
    return [torch.matmul(x, w) for w in ws]


def papi_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] through the scheduled FC path."""
    return papi_linear_group(x, [w])[0]
