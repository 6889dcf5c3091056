"""Logical-axis sharding: the rule tables of `repro.distributed.sharding`
for a port that runs one process per rank.

Model code names the dims of its parameters and caches with *logical* axes
("heads", "kv_heads", "ffn", "embed_vocab", "act_kv_seq", ...).  A rule
table maps each logical name to a mesh axis name, a tuple of them, or None
(replicated); `logical_to_spec` resolves a tuple of logical names under the
installed table and `filter_spec_for_shape` drops every entry whose mesh
axes do not divide the dim, and a mesh axis a earlier dim already took
(first dim wins).  A spec is a plain tuple of those entries.

The reference hands its specs to GSPMD, and its `shard()` constraints steer
the partitioner between them.  PyTorch has no partitioner, so `shard()` has
no counterpart here: each rank stores only its block of every leaf
(`local_block`, `models.weights.shard_params`, `models.init_cache` /
`init_paged_cache` under a mesh) and the model gives each layout itself,
with explicit collectives where the reference's partitioner would place
them — the FC-PIM banks in `models.linear` (a row bank reduces its partial
sums), the Attn-PIM units in `kernels.decode_attention` /
`kernels.paged_decode_attention` (`*_sharded`: no cross-rank term), the
expert-parallel MoE in `models.moe` (each rank's experts, the combine
summed over "experts"' axis), the Mamba2 block on a rank's heads in
`models.ssm` (the gated norm's sum of squares and the ``w_out`` rows
summed over "ssm_heads"' axis), and in `models.model` the vocab-split
embedding and logits and the sequence-split KV slab (its partials merged
over every mesh axis of the "act_kv_seq" entry, row-major as
`block_range` orders the blocks).

A leaf whose spec puts its "fsdp" dim on a mesh axis of more than one rank
(`fsdp_layout`) is one of two things.  Where the batch lies on that same
axis (the FSDP prefill), it is a block to gather whole at its layer's
entry (`models.model.serve_split`); where the batch is whole (the 2D
weight-stationary decode), it is a block to contract in place
(`fsdp_block`, `models.linear`).

A mesh here is anything with a ``shape`` mapping of axis name -> size (and,
for `local_block`, ``coords``: this rank's index on each axis):
`launch.mesh.ServingMesh`, or a shape-only stand-in in tests.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Mapping, Sequence

import torch

Spec = tuple

_state = threading.local()


def current_rules() -> Mapping[str, object] | None:
    """The installed logical->mesh rule table, or None outside axis_rules."""
    return getattr(_state, "rules", None)


def current_mesh():
    """The installed mesh, or None outside axis_rules (one device)."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def axis_rules(rules: Mapping[str, object] | None, mesh=None):
    """Install logical->mesh axis rules (and the mesh they split over) for
    the code run inside; `None` rules install nothing."""
    prev = current_rules(), current_mesh()
    _state.rules = dict(rules) if rules is not None else None
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = prev


def fc_tensor_axis(bank: str = "ffn") -> tuple[object, str | None]:
    """(mesh, axis) of an FC weight's tensor split: the mesh axis the rules
    map the weight's *bank* logical dim onto (one FC-PIM bank per shard of
    that axis; "ffn" for MLP weights, "heads" / "kv_heads" for attention
    projections).  (None, None) outside a mesh context, (mesh, None) when
    the rules replicate that dim or the axis is trivial."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None:
        return None, None
    axis = rules.get(bank)
    if not isinstance(axis, str) or axis not in dict(mesh.shape) \
            or mesh.shape[axis] <= 1:
        return mesh, None
    return mesh, axis


def logical_to_spec(logical: Sequence[str | None]) -> Spec:
    """Resolve a tuple of logical axis names under the installed rules."""
    rules = current_rules()
    if rules is None:
        return (None,) * len(logical)
    return tuple(None if name is None else rules.get(name)
                 for name in logical)


def _atoms(entry) -> tuple:
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _axis_prod(mesh, entry) -> int:
    if entry is None:
        return 1
    n = 1
    for a in _atoms(entry):
        n *= mesh.shape[a]
    return n


def filter_spec_for_shape(spec: Sequence, shape: Sequence[int],
                          mesh) -> Spec:
    """Drop spec entries whose mesh-axis product does not divide the dim,
    and de-duplicate mesh axes (first dim wins): one rule table serves
    every architecture (qwen2-0.5b's 14 heads replicate over 4 ranks)."""
    used: set = set()
    out = []
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, entry in zip(shape, spec):
        if entry is None or mesh is None:
            out.append(entry)
            continue
        atoms = _atoms(entry)
        if any(a in used for a in atoms) or dim % _axis_prod(mesh, entry):
            out.append(None)
        else:
            out.append(entry)
            used.update(atoms)
    return tuple(out)


def resolve_spec(logical: Sequence[str | None], shape: Sequence[int],
                 rules: Mapping[str, object], mesh) -> Spec:
    """The spec a leaf of `shape` with `logical` axes takes under `rules`
    and `mesh`."""
    with axis_rules(rules, mesh):
        spec = logical_to_spec(tuple(logical))
    return filter_spec_for_shape(spec, shape, mesh)


def _is_axes(x) -> bool:
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(isinstance(e, (str, type(None), tuple)) for e in x))


def tree_shardings(axes_tree, shapes_tree, rules: Mapping[str, object],
                   mesh):
    """Resolve a tree (dicts, NamedTuples) of logical-axis tuples against
    the matching tree of shapes into a tree of spec tuples."""
    if _is_axes(axes_tree):
        return resolve_spec(axes_tree, tuple(shapes_tree), rules, mesh)
    if isinstance(axes_tree, dict):
        return {k: tree_shardings(v, shapes_tree[k], rules, mesh)
                for k, v in axes_tree.items()}
    return type(axes_tree)(*(tree_shardings(a, s, rules, mesh)
                             for a, s in zip(axes_tree, shapes_tree)))


def block_range(n: int, entry, mesh) -> tuple[int, int]:
    """[lo, hi) of this rank's block of a dim of size `n` under one spec
    entry (the whole dim for None)."""
    if entry is None:
        return 0, n
    size, idx = 1, 0
    for a in _atoms(entry):       # row-major over the entry's mesh axes
        size *= mesh.shape[a]
        idx = idx * mesh.shape[a] + mesh.coords[a]
    step = n // size
    return idx * step, (idx + 1) * step


def axis_dim(spec: Sequence, axis: str) -> int | None:
    """The dim of `spec` whose entry holds mesh axis `axis` (alone or in
    a tuple), or None where the leaf is whole over it.  A train split
    asks it of every leaf twice: its "data" dim (the ZeRO-3 block) and
    its "model" dim (heads, ffn or vocabulary); `filter_spec_for_shape`
    has already dropped a dim the axis does not divide, so such a leaf is
    whole over it."""
    for dim, entry in enumerate(spec):
        if entry is not None and axis in _atoms(entry):
            return dim
    return None


def local_block(t: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's block of the full tensor `t` under `spec` (a copy, so
    the full tensor can be freed)."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            lo, hi = block_range(t.shape[dim], entry, mesh)
            t = t.narrow(dim, lo, hi - lo)
    return t.contiguous().clone() if any(e is not None for e in spec) else t


def full_tensor(block: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """The inverse of `local_block`: every rank's block of `spec`
    gathered back into the full tensor (``mesh.all_gather``, innermost
    mesh axis of an entry first)."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            for a in reversed(_atoms(entry)):
                block = mesh.all_gather(block, a, dim)
    return block


def split_axis(logical: str, n: int) -> tuple[object, str] | None:
    """(mesh, axis) of the tensor split of a dim of `n` units named
    `logical` (an FC bank's "ffn" / "heads", the MoE's "experts", the
    Mamba2 block's "ssm_heads"), or None where it is whole on every rank:
    outside a mesh, where the rules replicate it, or where the axis does
    not divide `n` (the leaf then stays whole, as `filter_spec_for_shape`
    keeps it, and its forward needs no collective)."""
    mesh, axis = fc_tensor_axis(logical)
    if axis is None or n <= 0 or n % mesh.shape[axis]:
        return None
    return mesh, axis


def tensor_split(logical: str, n: int) -> tuple[int, int]:
    """(shards, this rank's index) of a dim of size `n` named `logical`
    under the installed rules and mesh: (1, 0) when it is whole."""
    mesh = current_mesh()
    if mesh is None:
        return 1, 0
    spec = resolve_spec((logical,), (n,), current_rules() or {}, mesh)
    if spec[0] is None or n == 0:       # an absent dim (mamba2's heads)
        return 1, 0
    lo, _ = block_range(n, spec[0], mesh)
    size = _axis_prod(mesh, spec[0])
    return size, lo // (n // size)


def data_layout(rules: dict, axis: str = "data") -> str | None:
    """What `rules` lay on mesh axis `axis` besides the batch: "gather"
    where the weights' "fsdp" dim lies on it beside the batch (the FSDP
    prefill: each layer's blocks gathered whole at its entry), "contract"
    where it lies on it with the batch whole (the 2D weight-stationary
    decode: each block contracted in place), "seq" where the batch is
    whole or the KV sequence lies on it (the long-context table), None
    where the batch alone is split over it."""
    batch = axis in _atoms(rules.get("batch"))
    if axis in _atoms(rules.get("fsdp")):
        return "gather" if batch else "contract"
    if not batch or axis in _atoms(rules.get("act_kv_seq")):
        return "seq"
    return None


def fsdp_layout() -> tuple[object, str, bool] | None:
    """(mesh, axis, gather) where the installed rules put the weights'
    "fsdp" dim on a mesh axis of more than one rank, else None; `gather`
    is `data_layout`'s "gather" (else "contract")."""
    mesh, axis = fc_tensor_axis("fsdp")
    if axis is None:
        return None
    return mesh, axis, data_layout(current_rules(), axis) == "gather"


def fsdp_block(n: int) -> tuple[object, str, int, int] | None:
    """(mesh, axis, lo, hi) of this rank's block of an "fsdp" dim of `n`
    where the 2D weight-stationary layout contracts it in place; None
    where that dim is whole (outside that layout, or where the axis does
    not divide `n`) or gathered whole before the forward uses it."""
    layout = fsdp_layout()
    if layout is None or layout[2] or split_axis("fsdp", n) is None:
        return None
    mesh, axis, _ = layout
    lo, hi = block_range(n, axis, mesh)
    return mesh, axis, lo, hi


def seq_axes() -> tuple[str, ...]:
    """The mesh axes of more than one rank that the installed rules split
    the KV sequence over ("act_kv_seq"), outermost first: the order in
    which `block_range` lays the slices out."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None:
        return ()
    return tuple(a for a in _atoms(rules.get("act_kv_seq"))
                 if a is not None and mesh.shape.get(a, 1) > 1)


def batch_block(n: int) -> tuple[int, int]:
    """[lo, hi) of this data group's rows of an `n`-slot batch under the
    installed rules and mesh (the "batch" rule): slot s lives on data group
    s // (n / dp), and a batch the axis does not divide stays whole on
    every group, as does every batch outside a mesh."""
    shards, idx = tensor_split("batch", n)
    step = n // shards
    return idx * step, (idx + 1) * step


def train_rules(multi_pod: bool = False, fsdp: bool = True) -> dict:
    data = ("pod", "data") if multi_pod else "data"
    return {
        # activations
        "batch": data,
        "seq": "model",          # sequence parallelism on the residual
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_ffn": None,
        "act_experts": "model",
        "act_kv_seq": None,      # train: KV not cached
        "vocab": "model",
        # params
        "heads": "model",
        "kv_heads": None,        # kv heads < 16 everywhere; replicate
        "ffn": "model",
        "experts": "model",
        "embed_vocab": "model",
        "ssm_heads": "model",
        "d_model": None,
        "fsdp": data if fsdp else None,   # second dim of big weights
        "scan": None,
    }


def serve_rules(multi_pod: bool = False, long_context: bool = False,
                attn_pim: bool = False) -> dict:
    """Inference rules.  Decode splits the KV slab's sequence dim over
    `model`; for long-context batch 1 the sequence spans (data, model).
    ``attn_pim=True`` moves the KV split to the KV *head* dim instead: one
    Attn-PIM unit per KV-head shard, next to its slice of the cache."""
    data = ("pod", "data") if multi_pod else "data"
    kv_seq: Any = ("data", "model") if long_context else "model"
    if multi_pod and long_context:
        kv_seq = ("pod", "data", "model")
    rules = {
        "batch": None if long_context else data,
        "seq": None,
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_ffn": "model",
        "act_experts": "model",
        "act_kv_seq": kv_seq,
        "vocab": "model",
        "heads": "model",
        "kv_heads": None,
        "ffn": "model",
        "experts": "model",
        "embed_vocab": "model",
        "ssm_heads": "model",
        "d_model": None,
        "fsdp": None,            # inference: weights fully resident
        "scan": None,
    }
    if attn_pim:
        rules["act_kv_seq"] = None
        rules["kv_heads"] = "model"
    return rules


__all__ = ["axis_dim", "axis_rules", "batch_block", "block_range",
           "current_mesh", "current_rules", "data_layout", "fc_tensor_axis",
           "filter_spec_for_shape",
           "fsdp_block", "fsdp_layout", "full_tensor", "local_block",
           "logical_to_spec", "resolve_spec", "seq_axes", "serve_rules",
           "split_axis", "tensor_split", "train_rules", "tree_shardings"]
