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

The 2D weight-stationary decode (the rules put the weights' "fsdp" dim
on "data" and keep the batch whole, `distributed.sharding.fsdp_block`)
stores each FC weight as the rank's 2D block and contracts it in place,
so the per-layer collectives are the size of the activations, not of the
weights:

  * a column group's "fsdp" dim is K: the rank takes its slice of x's K,
    runs the group on it ("pim": one `fc_gemv_group` launch on the block)
    and sums the partial products over "data" in one collective.  The
    partials stay in f32 until after that sum (`contract_block`), so the
    result is rounded once, as one device rounds it;
  * a row bank's "fsdp" dim is N: after its sum over the tensor group it
    gathers the N slices over "data" (``out_dim``: the global N, which
    the call site names, since the rank sees only its block).

Under the FSDP prefill (the batch over "data" too) the forward gathers
each layer's weights whole first (`models.model.serve_split`), and the
banks run as above on the tensor split alone.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import torch

from repro_torch.distributed.sharding import (fc_tensor_axis, fsdp_block,
                                              fsdp_layout, split_axis)
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
                      units: int | None = None,
                      out_dim: int | None = None) -> list[torch.Tensor]:
    """[x [..., K] @ w [K, N_i] for w in ws] through the scheduled FC path:
    under "pim" one `fc_gemv_group` launch for all of them.  ``tp`` /
    ``bank`` / ``units`` declare the weights' tensor split under a mesh
    (module docstring); a row group's partials are summed over the tensor
    group, one collective per weight.  Under the 2D weight-stationary
    layout a column group contracts its K block in place and a row bank
    gathers its N block (the global N: ``out_dim``)."""
    block = fsdp_block(x.shape[-1]) if tp == "col" else None
    if block is not None:
        outs = contract_block(x, ws, block, current_fc_variant() == "pim")
    elif current_fc_variant() == "pim":
        outs = _fc_gemv(x, ws)
    else:
        outs = [torch.matmul(x, w) for w in ws]
    if tp == "row":
        split = bank_split(bank, units)
        if split is not None:
            mesh, axis = split
            outs = [mesh.all_reduce(o, axis) for o in outs]
        rows = _row_block(out_dim)
        if rows is not None:
            outs = [rows[0].all_gather(o, rows[1], dim=-1) for o in outs]
    return outs


def _fc_gemv(x: torch.Tensor, ws: Sequence[torch.Tensor],
             out_dtype: torch.dtype | None = None) -> list[torch.Tensor]:
    lead = x.shape[:-1]
    outs = fc_gemv_group(x.reshape(-1, x.shape[-1]).contiguous(), list(ws),
                         out_dtype)
    return [o.reshape(*lead, w.shape[1]) for o, w in zip(outs, ws)]


def contract_block(x: torch.Tensor, ws: Sequence[torch.Tensor], block,
                   pim: bool = False) -> list[torch.Tensor]:
    """[x @ w for w in ws] where each w is this rank's rows [lo, hi) of
    K (`block`: `fsdp_block`'s (mesh, axis, lo, hi)): the partial
    products over x's slice of K, in f32, summed over the axis in one
    collective, then rounded to x's dtype once.  ``pim`` runs them
    through one `fc_gemv_group` launch, else `torch.matmul`."""
    mesh, axis, lo, hi = block
    x = x[..., lo:hi]
    if pim:
        outs = _fc_gemv(x, ws, torch.float32)
    else:
        outs = [_matmul_f32(x, w) for w in ws]
    return [o.to(x.dtype) for o in mesh.all_reduce_many(outs, axis)]


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 sums left unrounded: on the card a bf16 product
    with an f32 output (no copy of w), on the CPU in f32."""
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.is_cuda:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w,
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[1])
    return torch.matmul(x.float(), w.float())


def _row_block(out_dim: int | None):
    """`fsdp_block` of a row bank's N, which the call site must name
    where the 2D weight-stationary layout splits it."""
    layout = fsdp_layout()
    if layout is None or layout[2]:
        return None
    if out_dim is None:
        raise ValueError("a row bank under the 2D weight-stationary layout "
                         "needs its global output width (out_dim=)")
    return fsdp_block(out_dim)


def papi_linear(x: torch.Tensor, w: torch.Tensor, *, tp: str | None = None,
                bank: str = "ffn", units: int | None = None,
                out_dim: int | None = None) -> torch.Tensor:
    """x [..., K] @ w [K, N] through the scheduled FC path."""
    return papi_linear_group(x, [w], tp=tp, bank=bank, units=units,
                             out_dim=out_dim)[0]
