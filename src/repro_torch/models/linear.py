"""The FC execution-path hook — where PAPI's scheduling decision lands.

Every FC projection (QKV, out-proj, FFN) goes through `papi_linear`, or
`papi_linear_group` for projections that share their input (q/k/v,
gate/up).  A context-local variant selects the path:

  "pu"  (default) — ``torch.matmul``, one per weight: the compute-bound
                    path.
  "pim"           — the weight-streaming `fc_gemv` kernel, one launch per
                    group: the memory-bound path (FC-PIM analogue).

The serving engine sets the variant per decode iteration from
`core.scheduler.PapiScheduler`.

Mesh execution (§5.3: FC-PIM banks)
-----------------------------------
Under `distributed.sharding.axis_rules(serve_rules(), mesh)` each rank
stores only its block of every FC weight (`models.weights.shard_params`)
and both paths run on that block — one FC-PIM bank per shard of the
tensor axis:

  * a column bank (``tp="col"``: q/k/v, gate/up, ``w_in``) holds its
    slice of the output dim and produces its slice of the output, with no
    collective;
  * a row bank (``tp="row"``: out-proj, down, ``w_out``) holds its slice
    of the contraction dim, takes its slice of the input and produces a
    partial product, which `ServingMesh.all_reduce` sums over the tensor
    group (the analogue of the PIM channels' reduction tree).

Call sites name the logical bank dim behind the split (``bank``: "ffn"
for MLP weights, "heads" / "kv_heads" for attention projections) and its
GLOBAL unit count (``units``: the head count, or the FFN width).  The
split engages exactly where the reference's does and where the stored
weight is split: the rules map the bank dim onto a mesh axis
(`fc_tensor_axis`) and ``units`` divides it (every N or K here is a
multiple of its units).  Otherwise the weight is whole on every rank and
the unsharded call runs.  A column bank needs no collective either way,
so only a row bank reads the decision.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import torch

from repro_torch.distributed.sharding import fc_tensor_axis, split_axis
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


def bank_split(bank: str, units: int | None):
    """(mesh, axis) of a split FC bank over `units` global units of the
    logical `bank` dim, or None where the weight is whole on every rank."""
    if fc_tensor_axis(bank)[1] is None:
        return None
    if units is None:
        raise ValueError(f"an FC bank over {bank!r} under a mesh needs its "
                         "global unit count (units=)")
    return split_axis(bank, units)


def papi_linear_group(x: torch.Tensor, ws: Sequence[torch.Tensor], *,
                      tp: str | None = None, bank: str = "ffn",
                      units: int | None = None) -> list[torch.Tensor]:
    """[x [..., K] @ w [K, N_i] for w in ws] through the scheduled FC path:
    under "pim" one `fc_gemv_group` launch for all of them.  ``tp`` /
    ``bank`` / ``units`` declare the weights' tensor split under a mesh
    (module docstring); a row group's partials are summed over the tensor
    group, one collective per weight."""
    if current_fc_variant() == "pim":
        lead = x.shape[:-1]
        outs = fc_gemv_group(x.reshape(-1, x.shape[-1]).contiguous(),
                             list(ws))
        outs = [o.reshape(*lead, w.shape[1]) for o, w in zip(outs, ws)]
    else:
        outs = [torch.matmul(x, w) for w in ws]
    if tp == "row":
        split = bank_split(bank, units)
        if split is not None:
            mesh, axis = split
            outs = [mesh.all_reduce(o, axis) for o in outs]
    return outs


def papi_linear(x: torch.Tensor, w: torch.Tensor, *, tp: str | None = None,
                bank: str = "ffn", units: int | None = None) -> torch.Tensor:
    """x [..., K] @ w [K, N] through the scheduled FC path."""
    return papi_linear_group(x, [w], tp=tp, bank=bank, units=units)[0]
