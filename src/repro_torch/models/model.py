"""The port's model — `repro.models.model`: dense (rmsnorm or layernorm,
tied or untied head), MoE, the VLM backbone with M-RoPE, SSM (mamba2) and
hybrid (zamba2) decoders, served over a dense KV slab or (the pure
attention families) a paged KV pool, and the audio encoder (hubert:
bidirectional, gelu MLP, frame inputs), which has no cache and no decode
step and, as in the reference, runs only in training (`forward_train`).

Parameters keep the reference's pytree: nested dicts whose per-layer
leaves are stacked on a leading ``num_layers`` axis (the weight bridge
`models.weights.params_from_jax` is then a straight copy).  The backbone is
a Python loop over layers where the reference runs `lax.scan`.

The caches are updated IN PLACE (the reference is functional and returns
new arrays): `_write_kv` / `_write_kv_masked` / `_write_kv_paged`, the
prefill's SSM blocks (into ``cache["ssm"]``, an `ssm.SSMState` of
per-layer stacked tensors), `prefill_to_slots` and `prefill_to_pages`
write into the cache tensors they are given, and every entry point returns
the same cache dict with its ``pos`` replaced.  `decode_step` replaces
``ssm`` too: it writes the new state into fresh tensors, so a caller that
kept the dict's old entries still holds the pre-step state (the serving
engine's finite-logits guard puts them back).  Given per-token buffers
(`ssm_step_buffers`), it keeps the state after each token of its window,
and `rewind_ssm` then selects each slot's state at an accepted prefix
(the speculative rewind).  The prefill stops each row's SSM state at its
``prompt_lens``, so a prompt's padding never reaches it.  A cache holding
``block_tables`` is paged: its K/V are page pools ``[L, num_pages,
page_size, nkv, hd]`` and the decode path resolves each logical position
through the slot's block table.

Training (`forward_train`, mode "train") reaches no kernel wrapper, as
the reference's training lowers only XLA code: the FC projections take
``torch.matmul`` (the default "pu" variant), attention the plain
`flash_attention`, the Mamba2 scan its differentiable plain version.
``remat=True`` recomputes each layer's activations in the backward pass
(`torch.utils.checkpoint`).  Per-layer views come from one `torch.unbind`
of each stacked leaf, so a layer's gradient lands in its slice of the
stacked leaf (weight decay sees the stacked layout, as in the reference).

Mesh serving (`distributed.sharding.axis_rules` installed): every leaf
of the params and caches is this rank's block under the rules
(`param_shardings`, `cache_shardings`, `paged_cache_shardings`; the
caches allocate only that block), and the forward gives each layout
itself: the FC banks (`models.linear`), attention over the rank's heads
(`head_split`, `_mesh_decode_attention`: one Attn-PIM unit per KV-head
shard, or the sequence-split slab's merged partials), the vocab-split
embedding and the gathered logits (`vocab_split`), the MoE layer's
experts (`moe.moe_mlp`) and the Mamba2 block's heads (`ssm.mamba2_block`),
whose SSM state each rank holds for its heads.  Where the data axis
splits the slot batch (the "batch" rule, `batch_block`), the caches hold
this data group's slots and every entry point takes their rows only.

Serving with the weights over "data" (the rules put the "fsdp" dim on
it, `distributed.sharding.fsdp_layout`): where the batch lies on "data"
too (the FSDP prefill), `serve_split` gathers each layer's blocks whole
at the layer's entry and the untied head's once a forward (`DataSplit`,
no gradient), and the tensor-split forward runs on them unchanged; where
the batch is whole (the 2D weight-stationary decode), every data group
computes every row and each FC weight and the untied head contract the
rank's 2D block in place (`models.linear`, `lm_logits`).  A KV sequence
split over (data, model) writes each position on the rank whose slice
holds it, and the decode attention merges every rank's partials in the
row-major rank order of `block_range`.

Training over the data axis (`train_rules` installed, dp > 1;
`DataSplit`): every leaf the rules label "fsdp" is this rank's block of
that dim and the batch its rows.  `forward_train` gathers each layer's
blocks at the layer's entry, inside the remat region, so the whole weight
dies with the layer and the backward gathers it again (ZeRO-3); the
embedding, the head and zamba2's shared block are gathered once a
forward.  A gather's backward sums the gradient over "data" and keeps
the rank's block; a leaf kept whole on every rank sums its gradient over
"data".  The loss is the global masked mean (each rank's numerator and
denominator summed over "data" before the division) and an MoE layer's
aux loss the mean over the global batch's groups.

Training over the tensor axis too (tp > 1: the dense, VLM and audio
families; `DataSplit.model`, `SeqSplit`): each rank holds its "model"
block of the heads, the FFN and the vocabulary beside its "data" block,
and the residual stream is split over its sequence dim on "model"
(sequence parallelism, the reference's "seq" rule).  Norms run on the
rank's rows; before each attention and split MLP sub-block the normed
rows are gathered over the sequence (`ServingMesh.seq_gather`), and the
out-projection's and the down / ``w_out`` bank's partial products are
reduce-scattered back to the rank's rows (`seq_scatter`); a bank that
is whole over "model" (qwen2-0.5b's 14 heads at tp = 4) computes every
row and keeps its own.  The embedding reduce-scatters its vocabulary
slice's partial rows; the head takes every row and the rank's
vocabulary, and the cross-entropy combines the max, the sum of
exponentials and the gold logit over "model" (`_vocab_nll_sums`).  A leaf
whole over "model" then has only a partial gradient on each rank (its
rows, or its heads), which one `replicated_grad` over "model" sums.
Where tp does not divide the sequence, the residual stays whole on every
rank (the reference's `filter_spec_for_shape`): a split bank's input is
then the identity whose backward sums over "model", its output summed
over "model" whose backward passes through, and a whole leaf's gradient
is complete but the K/V projections' that split q heads read
(`SeqSplit.partial`).  Under remat each layer's recompute runs its
collectives again (early stop off, so the count is fixed).

Entry points:
  init_params(cfg, generator)            -> params
  param_logical_axes / param_shardings(cfg, rules, mesh)
  cache_logical_axes / cache_shardings, paged_cache_logical_axes /
  paged_cache_shardings                  -> trees of spec tuples
  forward_train(cfg, params, batch, remat=True) -> (loss, metrics)
  data_split(cfg) -> DataSplit | None
  collectives_per_train_step(cfg, accum, remat, seq_len)
  init_cache(cfg, batch, capacity, device)
  init_paged_cache(cfg, max_slots, num_pages, page_size, max_blocks, device)
  prefill(cfg, params, batch, cache)     -> (last_logits, cache)
  prefill_to_slots(cfg, params, batch, cache, src) -> (first_tokens, cache)
  prefill_to_pages(cfg, params, batch, cache, src) -> (first_tokens, cache)
  chunk_logits / prefill_chunk(cfg, params, cache, tokens, chunk_lens)
  decode_step(cfg, params, cache, tokens, ssm_steps=None, positions=None)
                                         -> (logits, cache)
  ssm_step_buffers(cache, t) / rewind_ssm(cache, steps, n) -> cache
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (axis_dim, batch_block,
                                              block_range, current_mesh,
                                              current_rules, fsdp_block,
                                              fsdp_layout, seq_axes,
                                              split_axis, tensor_split,
                                              tree_shardings)
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.linear import contract_block

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")
# the families whose whole cache is KV, and so can be paged
KV_FAMILIES = ("dense", "moe", "vlm")


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: tuple[int, ...]
    init: str = "normal"      # normal | zeros | ones | a_log | dt_bias
    std: float = 0.02
    dtype: str | None = None  # None: the model's dtype
    # logical axis names of the dims (the reference's, for the rule tables)
    logical: tuple = ()


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES or cfg.mlp not in ("swiglu", "gelu"):
        raise NotImplementedError(
            f"{cfg.name}: the port runs {'/'.join(FAMILIES)} models with a "
            "swiglu or gelu MLP")


def _check_decoder(cfg: ModelConfig) -> None:
    """Refuse a cache or a decode step for an encoder-only model."""
    _check_family(cfg)
    if not cfg.has_decode_step:
        raise ValueError(f"{cfg.name} is encoder-only: it has no cache and "
                         "no decode step (train it with forward_train)")


def _attention_collectives(cfg: ModelConfig, cache: dict,
                           attn_pim: bool) -> int:
    """Collectives of one attention sub-block on a rank: the
    out-projection's row-bank sum, the q-head gather and the partials'
    gathers (one per mesh axis of the split) over a sequence-split slab
    (`cache` holds ``kv_seq``), or the q-head gather that lets Attn-PIM
    run unsharded where the KV heads are whole."""
    heads, _ = tensor_split("heads", cfg.num_heads)
    kv_heads, _ = tensor_split("kv_heads", cfg.num_kv_heads)
    n = int(heads > 1)
    if "kv_seq" in cache:
        n += len(seq_axes()) + int(heads > 1)
    elif heads > 1 and kv_heads == 1 and attn_pim:
        n += 1
    return n


def collectives_per_forward(cfg: ModelConfig, cache: dict,
                            attn_pim: bool) -> int:
    """Collectives one forward of `cfg` runs on a rank under the installed
    mesh (0 outside one): the vocab-split embedding's sum and the logits'
    gather, and per family
      * dense / VLM: per layer the attention's and the MLP's down-bank sum;
      * MoE: per layer the attention's and the experts' combine;
      * SSM: per Mamba2 layer the gated norm's and ``w_out``'s sums;
      * hybrid: those per Mamba2 layer, and a dense layer's per
        application of the shared block.
    The batch split over "data" adds none: a data group's forward takes
    only its own slots' rows, and the serving engine gathers what it
    fetches once an iteration (`PapiEngine._fetch`, counted in its
    `transfer_budget`).  The weights over "data" add, for a dense model,
    under the 2D weight-stationary layout per layer the q/k/v and the MLP
    column groups' sums and the out-projection's and down bank's gathers
    over "data" (4), and the untied head's sum; under the FSDP prefill
    per layer its blocks' gather (one a dtype) and the untied head's once
    (`serve_split`)."""
    if current_mesh() is None:
        return 0
    top = 2 if vocab_split(cfg) is not None else 0
    contract = int(fsdp_block(cfg.d_model) is not None)
    split = serve_split(cfg)
    if split is not None:
        groups = _split_groups(cfg, split)
        top += cfg.num_layers * len(groups["layer"]) + len(groups["top"])
    if cfg.decoder and not cfg.tie_embeddings:
        top += contract
    if cfg.family in ("ssm", "hybrid"):
        heads, _ = tensor_split("ssm_heads", cfg.ssm.n_heads(cfg.d_model))
        n = cfg.num_layers * 2 * int(heads > 1)
        if cfg.family == "hybrid":
            ffn, _ = tensor_split("ffn", cfg.d_ff)
            n += cfg.num_attention_applications() * (
                _attention_collectives(cfg, cache, attn_pim) + int(ffn > 1))
        return top + n
    if cfg.family == "moe":
        experts, _ = tensor_split("experts", cfg.moe.num_experts)
        mlp = int(experts > 1)
    else:
        mlp = int(tensor_split("ffn", cfg.d_ff)[0] > 1) + 4 * contract
    return top + cfg.num_layers * (
        _attention_collectives(cfg, cache, attn_pim) + mlp)


def collectives_per_train_step(cfg: ModelConfig, accum: int = 1,
                               remat: bool = True,
                               seq_len: int | None = None) -> int:
    """Collectives one train step runs on a rank under the installed
    train split (0 without one), one a dtype where a call takes several
    leaves.  Over "data" (dp > 1), per microbatch: a layer's blocks are
    gathered at its entry, again when remat recomputes it, and
    reduce-scattered in the backward; the other blocks are gathered once
    and reduce-scattered; the leaves kept whole sum their gradients; the
    loss's numerator, denominator and MoE aux loss are summed together.
    Over "model" (tp > 1; `_tensor_collectives`, which needs the cell's
    `seq_len`): the sequence gathers and reduce-scatters.  Per step: the
    gradient norm's one sum an axis."""
    split = data_split(cfg)
    if split is None:
        return 0
    micro = 0
    if split.mesh.shape.get(split.axis, 1) > 1:
        groups = _split_groups(cfg, split)
        micro += ((3 if remat else 2) * cfg.num_layers * len(groups["layer"])
                  + 2 * len(groups["top"]) + len(groups["whole"]) + 1)
    if split.model is not None:
        if seq_len is None:
            raise ValueError("a tensor split's collectives depend on the "
                             "sequence length (seq_len=)")
        micro += _tensor_collectives(cfg, split, seq_len, remat)
    norm = {a for _, sp in flatten_tree(split.specs)
            for a in split.leaf_axes(sp) if split.mesh.shape[a] > 1}
    return accum * micro + len(norm)


def _tensor_collectives(cfg: ModelConfig, split: "DataSplit", seq_len: int,
                        remat: bool) -> int:
    """The "model" collectives of one microbatch (module docstring).
    With the residual split over the sequence, each layer gathers the
    attention's input and reduce-scatters its out-projection where the
    heads are split, and gathers and reduce-scatters a split MLP: each
    once forward, again in the recompute and once backward.  The
    embedding's reduce-scatter and its backward gather, the head's gather
    and its backward reduce-scatter, the cross-entropy's max and sums (or,
    with the vocabulary whole, the loss sums).  With the residual whole, a
    split bank's input sums its gradient once and its output is summed
    forward and in the recompute; the embedding's partial rows are summed
    once; the head's input sums its gradient and the cross-entropy's max
    and sums run once.  Either way the partial leaves' gradient sum
    (`SeqSplit.partial`), one a dtype."""
    res = SeqSplit.of(cfg, split, seq_len)
    heads, ffn = int(res.heads.q_split), int(res.ffn)
    vocab = vocab_split(cfg) is not None
    embed = int(vocab and cfg.family != "audio")
    partial = res.partial(split)
    dtype = {k: v.dtype or cfg.dtype
             for k, v in flatten_tree(model_spec(cfg))}
    sums = len({dtype[k] for k in dtype if partial(k)})
    if res.seq:
        r = 3 if remat else 2
        top = 2 * embed + (4 if vocab else 1) + sums
        return cfg.num_layers * r * (1 + heads + 2 * ffn) + top
    f = 2 if remat else 1
    return (cfg.num_layers * (1 + f) * (heads + ffn) + embed
            + (3 if vocab else 0) + sums)


def _split_groups(cfg: ModelConfig, split: "DataSplit") -> dict:
    """The dtypes of a data split's leaves, by kind: "layer" (blocks
    gathered at each layer's entry), "top" (blocks gathered once a
    forward) and "whole" (kept whole on every rank)."""
    dtype = {k: v.dtype or cfg.dtype
             for k, v in flatten_tree(model_spec(cfg))}
    groups: dict = {"layer": set(), "top": set(), "whole": set()}
    for key, spec in flatten_tree(split.specs):
        kind = ("whole" if split.block_dim(spec) is None else
                "layer" if key.startswith("layers/") else "top")
        groups[kind].add(dtype[key])
    return groups


def host_copies_per_forward(cfg: ModelConfig) -> int:
    """Device->host copies one forward of the model makes: one per MoE
    layer (`moe.moe_mlp` reads its per-expert counts), none otherwise."""
    return cfg.num_layers if cfg.family == "moe" else 0


def _attn_spec(cfg: ModelConfig, residual_std: float) -> dict:
    d, nh, nkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    std = d ** -0.5
    p = {
        "w_q": PSpec((d, nh, hd), std=std, logical=("fsdp", "heads", None)),
        "w_k": PSpec((d, nkv, hd), std=std,
                     logical=("fsdp", "kv_heads", None)),
        "w_v": PSpec((d, nkv, hd), std=std,
                     logical=("fsdp", "kv_heads", None)),
        "w_o": PSpec((nh, hd, d), std=residual_std,
                     logical=("heads", None, "fsdp")),
    }
    if cfg.qkv_bias:
        p["b_q"] = PSpec((nh, hd), "zeros", logical=("heads", None))
        p["b_k"] = PSpec((nkv, hd), "zeros", logical=("kv_heads", None))
        p["b_v"] = PSpec((nkv, hd), "zeros", logical=("kv_heads", None))
    return p


def _mlp_spec(cfg: ModelConfig, residual_std: float) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    std = d ** -0.5
    if cfg.mlp == "swiglu":
        return {
            "w_gate": PSpec((d, f), std=std, logical=("fsdp", "ffn")),
            "w_up": PSpec((d, f), std=std, logical=("fsdp", "ffn")),
            "w_down": PSpec((f, d), std=residual_std,
                            logical=("ffn", "fsdp")),
        }
    return {
        "w_in": PSpec((d, f), std=std, logical=("fsdp", "ffn")),
        "b_in": PSpec((f,), "zeros", logical=("ffn",)),
        "w_out": PSpec((f, d), std=residual_std, logical=("ffn", "fsdp")),
        "b_out": PSpec((d,), "zeros", logical=(None,)),
    }


def _moe_spec(cfg: ModelConfig, residual_std: float) -> dict:
    d, f, e = cfg.d_model, cfg.moe.d_ff, cfg.moe.num_experts
    std = d ** -0.5
    return {
        "w_router": PSpec((d, e), std=std, logical=(None, None)),
        "w_gate": PSpec((e, d, f), std=std,
                        logical=("experts", "fsdp", None)),
        "w_up": PSpec((e, d, f), std=std, logical=("experts", "fsdp", None)),
        "w_down": PSpec((e, f, d), std=residual_std,
                        logical=("experts", None, "fsdp")),
    }


def _ssm_spec(cfg: ModelConfig, residual_std: float) -> dict:
    s, d = cfg.ssm, cfg.d_model
    di, nh, n, k = s.d_inner(d), s.n_heads(d), s.d_state, s.conv_kernel
    std = d ** -0.5
    heads = ("ssm_heads",)
    return {
        "w_z": PSpec((d, di), std=std, logical=("fsdp", "ssm_heads")),
        "w_x": PSpec((d, di), std=std, logical=("fsdp", "ssm_heads")),
        "w_B": PSpec((d, n), std=std, logical=("fsdp", None)),
        "w_C": PSpec((d, n), std=std, logical=("fsdp", None)),
        "w_dt": PSpec((d, nh), std=std, logical=("fsdp", "ssm_heads")),
        "conv_x": PSpec((k, di), std=1 / math.sqrt(k),
                        logical=(None, "ssm_heads")),
        "conv_B": PSpec((k, n), std=1 / math.sqrt(k), logical=(None, None)),
        "conv_C": PSpec((k, n), std=1 / math.sqrt(k), logical=(None, None)),
        # f32 in any model dtype: recurrence-critical, as in the reference
        "A_log": PSpec((nh,), "a_log", dtype="float32", logical=heads),
        "D": PSpec((nh,), "ones", logical=heads),
        "dt_bias": PSpec((nh,), "dt_bias", dtype="float32", logical=heads),
        "norm_w": PSpec((di,), "ones", logical=heads),
        "w_out": PSpec((di, d), std=residual_std,
                       logical=("ssm_heads", "fsdp")),
    }


def _norm_spec(d: int) -> PSpec:
    return PSpec((d,), "ones", logical=(None,))


def _layer_spec(cfg: ModelConfig, residual_std: float) -> dict:
    """Spec of ONE layer (unstacked)."""
    d = cfg.d_model
    if cfg.family in ("ssm", "hybrid"):
        return {"norm": _norm_spec(d), "ssm": _ssm_spec(cfg, residual_std)}
    block = {
        "norm1": _norm_spec(d),
        "attn": _attn_spec(cfg, residual_std),
        "norm2": _norm_spec(d),
    }
    if cfg.family == "moe":
        block["moe"] = _moe_spec(cfg, residual_std)
    else:
        block["mlp"] = _mlp_spec(cfg, residual_std)
    return block


def model_spec(cfg: ModelConfig) -> dict:
    _check_family(cfg)
    d, v, nl = cfg.d_model, cfg.vocab_size, cfg.num_layers
    residual_std = (d ** -0.5) / math.sqrt(max(2 * nl, 1))

    def stack(tree):
        return {k: (dataclasses.replace(ps, shape=(nl,) + ps.shape,
                                        logical=("scan",) + ps.logical)
                    if isinstance(ps, PSpec) else stack(ps))
                for k, ps in tree.items()}

    spec = {
        "embed": {"w": PSpec((v, d), std=0.02,
                             logical=("embed_vocab", None))},
        "final_norm": {"w": _norm_spec(d)},
        "layers": stack(_layer_spec(cfg, residual_std)),
    }
    if cfg.family == "hybrid":
        # one weight-tied attention+MLP block shared across applications
        spec["shared"] = {
            "norm1": _norm_spec(d),
            "attn": _attn_spec(cfg, residual_std),
            "norm2": _norm_spec(d),
            "mlp": _mlp_spec(cfg, residual_std),
        }
    if cfg.family == "audio":
        spec["mask_embed"] = {"w": PSpec((d,), std=0.02, logical=(None,))}
    if cfg.decoder and not cfg.tie_embeddings:
        spec["lm_head"] = {"w": PSpec((d, v), std=d ** -0.5,
                                      logical=("fsdp", "embed_vocab"))}
    return spec


def _spec_tree(cfg: ModelConfig, field: str) -> dict:
    def walk(tree):
        return {k: (getattr(v, field) if isinstance(v, PSpec) else walk(v))
                for k, v in tree.items()}
    return walk(model_spec(cfg))


def param_logical_axes(cfg: ModelConfig) -> dict:
    """The params tree of logical-axis tuples (the reference's)."""
    return _spec_tree(cfg, "logical")


def param_shapes(cfg: ModelConfig) -> dict:
    """The params tree of full (unsharded) shapes."""
    return _spec_tree(cfg, "shape")


def param_shardings(cfg: ModelConfig, rules, mesh) -> dict:
    """The params tree of spec tuples under a rule table and mesh: dims
    the mesh axes do not divide stay whole (`filter_spec_for_shape`)."""
    return tree_shardings(param_logical_axes(cfg), param_shapes(cfg), rules,
                          mesh)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random parameters on the generator's device: truncated normals
    (+-3 sigma) scaled by each leaf's std, ones for norms, zeros for
    biases, and the SSM laws for A_log (log U[a_min, a_max]) and dt_bias
    (softplus^-1 of dt ~ logU[1e-3, 1e-1]), both f32 — the reference's init
    laws, not its random numbers."""
    def walk(tree):
        return {k: (init_leaf(cfg, v, generator) if isinstance(v, PSpec)
                    else walk(v))
                for k, v in tree.items()}

    return walk(model_spec(cfg))


def init_leaf(cfg: ModelConfig, ps: PSpec,
              generator: torch.Generator) -> torch.Tensor:
    """One leaf of `init_params` by its spec's law, on the generator's
    device (a caller that seeds each leaf itself can make a big model's
    leaves one at a time and keep only a rank's block of each)."""
    device = generator.device
    dtype = DTYPES[ps.dtype or cfg.dtype]
    if ps.init == "zeros":
        return torch.zeros(ps.shape, dtype=dtype, device=device)
    if ps.init == "ones":
        return torch.ones(ps.shape, dtype=dtype, device=device)
    if ps.init == "a_log":
        u = torch.rand(ps.shape, generator=generator, device=device)
        return torch.log(cfg.ssm.a_min + u * (cfg.ssm.a_max
                                               - cfg.ssm.a_min)).to(dtype)
    if ps.init == "dt_bias":
        u = torch.rand(ps.shape, generator=generator, device=device)
        lo, hi = math.log(1e-3), math.log(0.1)
        dt = torch.exp(u * (hi - lo) + lo)
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    x = torch.empty(ps.shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return (x * ps.std).to(dtype)


def _mesh_specs(axes, shapes, split: bool = True):
    """Spec tuples of a cache tree under the installed rules and mesh, or
    None outside a mesh context; ``split=False`` keeps the KV sequence and
    the batch dims whole."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None:
        return None
    if not split:
        rules = dict(rules, act_kv_seq=None, batch=None)
    return tree_shardings(axes, shapes, rules, mesh)


def _zeros_block(shape, spec, dtype, device) -> torch.Tensor:
    """Zeros of this rank's block of `shape` under `spec` (whole: None)."""
    if spec is not None:
        mesh = current_mesh()
        shape = tuple(hi - lo for lo, hi in (block_range(n, e, mesh)
                                             for n, e in zip(shape, spec)))
    return torch.zeros(shape, dtype=dtype, device=device)


def cache_shapes(cfg: ModelConfig, batch: int, capacity: int) -> dict:
    """The dense cache's full shapes (mirrors init_cache)."""
    shapes: dict = {"pos": (batch,)}
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        di, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
        k, nl = s.conv_kernel - 1, cfg.num_layers
        shapes["ssm"] = S.SSMState(
            conv_x=(nl, batch, k, di), conv_B=(nl, batch, k, s.d_state),
            conv_C=(nl, batch, k, s.d_state),
            ssm=(nl, batch, nh, s.head_dim, s.d_state))
    if cfg.family in KV_FAMILIES + ("hybrid", "audio"):
        kv = (cfg.num_attention_applications(), batch, capacity,
              cfg.num_kv_heads, cfg.resolved_head_dim)
        shapes["k"] = shapes["v"] = kv
    return shapes


def cache_logical_axes(cfg: ModelConfig) -> dict:
    """Logical axes of the dense cache (mirrors init_cache)."""
    axes: dict = {"pos": (None,)}
    if cfg.family in KV_FAMILIES + ("hybrid", "audio"):
        axes["k"] = axes["v"] = ("scan", "batch", "act_kv_seq", "kv_heads",
                                 None)
    if cfg.family in ("ssm", "hybrid"):
        axes["ssm"] = S.SSMState(
            conv_x=("scan", "batch", None, "ssm_heads"),
            conv_B=("scan", "batch", None, None),
            conv_C=("scan", "batch", None, None),
            ssm=("scan", "batch", "ssm_heads", None, None))
    return axes


def cache_shardings(cfg: ModelConfig, batch: int, capacity: int, rules,
                    mesh) -> dict:
    """Spec tuples of the dense cache under a rule table and mesh.  Under
    `serve_rules()` the KV sequence dim lands on the tensor axis (each
    rank owns a contiguous slice of positions); under
    ``serve_rules(attn_pim=True)`` the KV head dim does."""
    return tree_shardings(cache_logical_axes(cfg),
                          cache_shapes(cfg, batch, capacity), rules, mesh)


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device: torch.device | str, *, split: bool = True) -> dict:
    """Decode cache: per-slot positions; dense, moe, vlm: [L, b, S, nkv,
    hd] K/V;
    ssm: ``ssm``, an `SSMState` of [L, b, ...] tensors (the SSM state f32);
    hybrid: both, with K/V [napps, b, S, nkv, hd] for the shared block's
    applications.

    Under a mesh (`distributed.sharding.axis_rules` installed) only this
    rank's block of each leaf is allocated (`cache_shardings`); when the
    sequence dim is split, ``cache["kv_seq"]`` holds (this rank's first
    position, the whole capacity).  Where the data axis splits the batch,
    ``pos`` holds this data group's slots too (`batch_block`), the rows
    its forwards compute.  ``split=False`` keeps the sequence and the
    batch whole (a prefill's temporary cache over the rows it is given)."""
    _check_decoder(cfg)
    dtype = DTYPES[cfg.dtype]
    shapes = cache_shapes(cfg, batch, capacity)
    specs = _mesh_specs(cache_logical_axes(cfg), shapes, split)

    def spec(key):
        return None if specs is None else specs[key]

    lo, hi = batch_block(batch) if split else (0, batch)
    cache = {"pos": torch.zeros((hi - lo,), dtype=torch.int32,
                                device=device)}
    if "ssm" in shapes:
        cache["ssm"] = S.SSMState(*(
            _zeros_block(shp, None if specs is None else sp,
                         torch.float32 if name == "ssm" else dtype, device)
            for name, shp, sp in zip(S.SSMState._fields, shapes["ssm"],
                                     specs["ssm"] if specs else shapes["ssm"])))
    if "k" in shapes:
        for key in ("k", "v"):
            cache[key] = _zeros_block(shapes[key], spec(key), dtype, device)
        seq = spec("k")[2] if specs is not None else None
        lo, hi = (0, capacity) if seq is None else block_range(
            capacity, seq, current_mesh())
        if hi - lo < capacity:
            cache["kv_seq"] = (lo, capacity)
    return cache


def _paged_shapes(cfg: ModelConfig, max_slots: int, num_pages: int,
                  page_size: int, max_blocks: int) -> dict:
    kv = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
          cfg.resolved_head_dim)
    return {"pos": (max_slots,), "k": kv, "v": kv,
            "block_tables": (max_slots, max_blocks)}


def paged_cache_logical_axes(cfg: ModelConfig) -> dict:
    """Logical axes of the paged cache (mirrors init_paged_cache): the
    page-pool dim stays whole, the KV-head dim carries the Attn-PIM unit
    split (`serve_rules(attn_pim=True)` maps kv_heads -> model)."""
    return {"pos": (None,),
            "k": ("scan", None, None, "kv_heads", None),
            "v": ("scan", None, None, "kv_heads", None),
            "block_tables": (None, None)}


def paged_cache_shardings(cfg: ModelConfig, max_slots: int, num_pages: int,
                          page_size: int, max_blocks: int | None, rules,
                          mesh) -> dict:
    """Spec tuples of the paged cache under a rule table and mesh."""
    if max_blocks is None:
        max_blocks = num_pages - 1
    return tree_shardings(
        paged_cache_logical_axes(cfg),
        _paged_shapes(cfg, max_slots, num_pages, page_size, max_blocks),
        rules, mesh)


def init_paged_cache(cfg: ModelConfig, max_slots: int, num_pages: int,
                     page_size: int, max_blocks: int | None,
                     device: torch.device | str) -> dict:
    """Paged decode cache: K/V in a pool of fixed-size pages (one page = one
    Attn-PIM bank row) and a per-slot block table mapping logical blocks to
    physical pages.  Page 0 is the garbage page: the tables start at 0, so
    writes of slots not yet admitted land there harmlessly.  Under a mesh
    each rank allocates its KV heads' pools, whole over the pages (the
    rules put no batch on them); ``pos`` and the block tables hold this
    data group's slots (`batch_block`), whose pages alone it writes and
    reads."""
    _check_decoder(cfg)
    if cfg.family not in KV_FAMILIES:
        raise ValueError(
            f"paged KV cache needs a pure attention KV cache; {cfg.family} "
            "carries SSM state that has no sequence dim to page")
    if max_blocks is None:
        max_blocks = num_pages - 1
    dtype = DTYPES[cfg.dtype]
    shapes = _paged_shapes(cfg, max_slots, num_pages, page_size, max_blocks)
    specs = _mesh_specs(paged_cache_logical_axes(cfg), shapes)
    kv = {key: _zeros_block(shapes[key],
                            None if specs is None else specs[key], dtype,
                            device) for key in ("k", "v")}
    lo, hi = batch_block(max_slots)
    return {"pos": torch.zeros((hi - lo,), dtype=torch.int32, device=device),
            **kv,
            "block_tables": torch.zeros((hi - lo, max_blocks),
                                        dtype=torch.int32, device=device)}


@dataclasses.dataclass
class DataSplit:
    """Training over the data axis ``axis`` of ``mesh`` (module
    docstring): ``specs`` are the params' spec tuples under the installed
    rules, a leaf whose spec holds ``axis`` being a block of that dim.
    ``model``: the tensor axis where it has more than one rank (a train
    split over both; ``axis`` may then have one rank, and its collectives
    are none), a leaf whose spec holds it being its block of the heads,
    the FFN or the vocabulary.  ``grad=False`` (the FSDP prefill,
    `serve_split`): the gathers run under `torch.no_grad` and the whole
    leaves are taken as they are."""
    mesh: object
    axis: str
    specs: dict
    grad: bool = True
    model: str | None = None

    def block_dim(self, spec) -> int | None:
        """The dim `spec` splits over the data axis, or None (whole)."""
        return axis_dim(spec, self.axis)

    def model_dim(self, spec) -> int | None:
        """The dim `spec` splits over the tensor axis, or None (whole)."""
        return None if self.model is None else axis_dim(spec, self.model)

    def leaf_axes(self, spec) -> tuple:
        """The mesh axes a leaf of `spec` is a rank's block over (the
        gradient norm sums its squares over each)."""
        return tuple(a for a, d in ((self.axis, self.block_dim(spec)),
                                    (self.model, self.model_dim(spec)))
                     if d is not None)

    def prepare(self, params: dict, partial=None) -> dict:
        """The forward's view of a rank's params: every whole leaf through
        one `replicated_grad`, the blocks outside ``layers`` through one
        gather (once a forward), the layers' blocks as they are (`gather`
        takes them at each layer's entry).  `partial` (a tensor split,
        `SeqSplit.partial`): the keys of the leaves whole over ``model``
        whose gradient each rank has only a part of, first through one
        `replicated_grad` over it."""
        leaf = dict(flatten_tree(params))
        if partial is not None and self.grad:
            keys = [k for k in leaf if partial(k)]
            leaf.update(zip(keys, self.mesh.replicated_grad(
                [leaf[k] for k in keys], self.model)))
        dims = {k: self.block_dim(sp)
                for k, sp in flatten_tree(self.specs)}
        whole = [k for k in leaf if dims[k] is None]
        top = [k for k in leaf
               if dims[k] is not None and not k.startswith("layers/")]
        out = (dict(zip(whole, self.mesh.replicated_grad(
            [leaf[k] for k in whole], self.axis))) if self.grad else {})
        out.update(self._gathered(leaf, top, dims))
        return unflatten_tree({**leaf, **out})

    def gather(self, lp: dict) -> dict:
        """One layer's view (`layer_list`) with its blocks gathered whole
        in one collective (their stacked specs less the layer dim)."""
        leaf = dict(flatten_tree(lp))
        dims = {k: self.block_dim(sp[1:])
                for k, sp in flatten_tree(self.specs["layers"])}
        keys = [k for k in leaf if dims[k] is not None]
        return unflatten_tree({**leaf, **self._gathered(leaf, keys, dims)})

    def _gathered(self, leaf: dict, keys: list, dims: dict) -> dict:
        with contextlib.nullcontext() if self.grad else torch.no_grad():
            return dict(zip(keys, self.mesh.all_gather_grad(
                [leaf[k] for k in keys], self.axis,
                [dims[k] for k in keys])))

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the data axis (gradient passed through)."""
        return self.mesh.all_reduce_grad(x, self.axis)


def flatten_tree(tree: dict, prefix: str = "") -> list:
    """(path, leaf) pairs of a nested dict, keys joined by '/'."""
    out = []
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out += flatten_tree(v, key) if isinstance(v, dict) else [(key, v)]
    return out


def unflatten_tree(flat: dict) -> dict:
    """The nested dict of `flatten_tree`'s {path: leaf}."""
    out: dict = {}
    for key, v in flat.items():
        node = out
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


# the families a tensor split trains (attention + MLP layers)
TP_TRAIN_FAMILIES = ("dense", "vlm", "audio")


def data_split(cfg: ModelConfig) -> DataSplit | None:
    """The installed rules' split of training: the mesh axis the "batch"
    rule maps to, and the tensor axis the "seq" rule maps to where it has
    more than one rank (``model``); None where neither has (one device).
    A tensor split of the MoE, SSM and hybrid families raises: it comes
    with a later slice of the port."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None:
        return None
    axis, model = rules.get("batch"), rules.get("seq")
    if not isinstance(model, str) or mesh.shape.get(model, 1) <= 1:
        model = None
    if model is not None and cfg.family not in TP_TRAIN_FAMILIES:
        raise ValueError(
            f"{cfg.name}: mesh {dict(mesh.shape)}: training the "
            f"{cfg.family} family with tp > 1 (the experts over \"model\" "
            "and the token dispatch across a tensor group; the Mamba2 "
            "heads over \"ssm_heads\", zamba2's shared block) comes with "
            "a later slice of the port, the next one; train it at tp = 1")
    if not isinstance(axis, str) or (mesh.shape.get(axis, 1) <= 1
                                     and model is None):
        return None
    return DataSplit(mesh, axis, param_shardings(cfg, rules, mesh),
                     model=model)


def serve_split(cfg: ModelConfig) -> DataSplit | None:
    """The FSDP prefill's data split of a serving forward: where the
    installed rules put the weights' "fsdp" dim and the batch on one mesh
    axis of more than one rank, a `DataSplit` without gradient (each
    layer's blocks gathered whole at its entry, the untied head's once a
    forward); None otherwise (one device, the weights whole over "data",
    or the 2D weight-stationary layout, which contracts its blocks in
    place)."""
    layout = fsdp_layout()
    if layout is None or not layout[2]:
        return None
    mesh, axis, _ = layout
    return DataSplit(mesh, axis, param_shardings(cfg, current_rules(), mesh),
                     grad=False)


def _serve_params(cfg: ModelConfig, params: dict):
    """(the forward's view of `params`, its `serve_split`)."""
    split = serve_split(cfg)
    return (params if split is None else split.prepare(params)), split


def layer_list(params: dict, num_layers: int) -> list[dict]:
    """Each layer's slice of the stacked per-layer parameters: views from
    one `torch.unbind` per leaf, whose backward stacks the layers'
    gradients into the stacked leaf's in one op."""
    def split(tree):
        out = [{} for _ in range(num_layers)]
        for k, v in tree.items():
            parts = split(v) if isinstance(v, dict) else torch.unbind(v)
            for layer, part in zip(out, parts):
                layer[k] = part
        return out
    return split(params["layers"])


def layer_state(state: S.SSMState | None, i: int) -> S.SSMState | None:
    """Layer i's slice of a stacked SSM state (views: written in place)."""
    if state is None:
        return None
    return S.SSMState(*(x[i] for x in state))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _write_kv(k_cache, v_cache, k_new, v_new, pos):
    """Write [b, t, nkv, hd] at per-request positions pos [b], in place.
    Like the reference's `dynamic_update_slice`, a start that would run
    past the capacity is clamped DOWN to capacity - t."""
    b, t = k_new.shape[0], k_new.shape[1]
    cap = k_cache.shape[1]
    start = torch.clamp(pos.long(), 0, cap - t)
    idx = start[:, None] + torch.arange(t, device=pos.device)[None, :]
    bidx = torch.arange(b, device=pos.device)[:, None].expand(b, t)
    k_cache[bidx, idx] = k_new
    v_cache[bidx, idx] = v_new
    return k_cache, v_cache


def _write_kv_masked(k_cache, v_cache, k_new, v_new, pos, valid_lens):
    """Like `_write_kv`, but only the first valid_lens[b] of the t new
    tokens are written per request, and rows past the capacity are dropped
    (the reference's scatter in "drop" mode), never clamped.

    Without a data-dependent shape (no host sync): every row is written,
    a dropped one with the value already in the cache, at its position
    modulo the capacity.  With t <= capacity those positions are distinct
    from each other and from the kept rows', so no write collides."""
    b, t = k_new.shape[0], k_new.shape[1]
    cap = k_cache.shape[1]
    j = torch.arange(t, device=pos.device)[None, :]
    idx = pos.long()[:, None] + j                                  # [b, t]
    keep = ((j < valid_lens.long()[:, None]) & (idx < cap))[..., None, None]
    idx = idx % cap
    bidx = torch.arange(b, device=pos.device)[:, None].expand(b, t)
    k_cache[bidx, idx] = torch.where(keep, k_new, k_cache[bidx, idx])
    v_cache[bidx, idx] = torch.where(keep, v_new, v_cache[bidx, idx])
    return k_cache, v_cache


def _write_kv_seq(k_cache, v_cache, k_new, v_new, idx, keep, kv_seq):
    """The sequence-split slab's write: of the t new tokens at global
    positions idx [b, t], those that `keep` marks AND this rank owns
    (``kv_seq[0] <= idx < kv_seq[0] + S_local``) land in its slice; every
    other row rewrites the value already there, at its local position
    modulo S_local (distinct from the owned rows' for t <= S_local, as in
    `_write_kv_masked`; a wider window takes `_write_kv_slice`)."""
    b, t = k_new.shape[0], k_new.shape[1]
    span = k_cache.shape[1]
    local = idx - kv_seq[0]
    own = (keep & (local >= 0) & (local < span))[..., None, None]
    local = local % span
    bidx = torch.arange(b, device=idx.device)[:, None].expand(b, t)
    k_cache[bidx, local] = torch.where(own, k_new, k_cache[bidx, local])
    v_cache[bidx, local] = torch.where(own, v_new, v_cache[bidx, local])
    return k_cache, v_cache


def _write_kv_slice(k_cache, v_cache, k_new, v_new, start, keep, kv_seq):
    """The sequence-split slab's write of a window wider than the rank's
    slice (a prefill over the slab): row b's t new tokens sit at global
    positions start[b] + j, so each local position takes the window row
    that lands on it where `keep` marks that row, and keeps its value
    otherwise."""
    b, t = k_new.shape[0], k_new.shape[1]
    span = k_cache.shape[1]
    p = kv_seq[0] + torch.arange(span, device=start.device)[None, :]
    j = p - start[:, None]                                       # [b, span]
    jc = torch.clamp(j, 0, t - 1)
    own = ((j >= 0) & (j < t) & torch.gather(keep, 1, jc))[..., None, None]
    bidx = torch.arange(b, device=start.device)[:, None]
    k_cache.copy_(torch.where(own, k_new[bidx, jc], k_cache))
    v_cache.copy_(torch.where(own, v_new[bidx, jc], v_cache))
    return k_cache, v_cache


def _write_kv_window(k_cache, v_cache, k_new, v_new, pos, write_lens,
                     kv_seq):
    """The decode path's KV write: masked to `write_lens` (chunked
    prefill) or the plain clamped write, into a whole slab or this rank's
    slice of a sequence-split one (`kv_seq`: (first position, capacity));
    each position lands on the rank whose slice holds it, whatever mesh
    axes the slab is split over."""
    if kv_seq is None:
        if write_lens is not None:
            return _write_kv_masked(k_cache, v_cache, k_new, v_new, pos,
                                    write_lens)
        return _write_kv(k_cache, v_cache, k_new, v_new, pos)
    t, cap = k_new.shape[1], kv_seq[1]
    j = torch.arange(t, device=pos.device)[None, :]
    if write_lens is not None:
        idx = pos.long()[:, None] + j
        keep = (j < write_lens.long()[:, None]) & (idx < cap)
    else:
        idx = torch.clamp(pos.long(), 0, cap - t)[:, None] + j
        keep = torch.ones_like(idx, dtype=torch.bool)
    if t > k_cache.shape[1]:
        return _write_kv_slice(k_cache, v_cache, k_new, v_new, idx[:, 0],
                               keep, kv_seq)
    return _write_kv_seq(k_cache, v_cache, k_new, v_new, idx, keep, kv_seq)


def _paged_rows(pos, t, tables, page_size):
    """(physical page, row) of t new tokens per slot: logical position
    pos + j lands in block (pos + j) // page_size, clamped to the table
    width, at row (pos + j) % page_size of the page the table names."""
    tok = pos.long()[:, None] + torch.arange(t, device=pos.device)[None, :]
    blk = torch.clamp(tok // page_size, 0, tables.shape[1] - 1)
    phys = torch.gather(tables.long(), 1, blk)                    # [b, t]
    return phys, tok % page_size


def _write_kv_paged(k_cache, v_cache, k_new, v_new, pos, tables,
                    valid_lens=None):
    """Scatter [b, t, nkv, hd] into the page pools [P, page, nkv, hd], in
    place.  With `valid_lens`, tokens past each slot's valid prefix go to
    the garbage page 0.  Idle slots' rows collide on page 0 too: which of
    the duplicate writes wins is undefined, and harmless, because no live
    request reads page 0."""
    t = k_new.shape[1]
    phys, row = _paged_rows(pos, t, tables, k_cache.shape[1])
    if valid_lens is not None:
        valid = (torch.arange(t, device=pos.device)[None, :]
                 < valid_lens.long()[:, None])
        phys = torch.where(valid, phys, torch.zeros_like(phys))
    k_cache[phys, row] = k_new
    v_cache[phys, row] = v_new
    return k_cache, v_cache


def _apply_positional(cfg: ModelConfig, q, k, positions):
    """RoPE, or M-RoPE over [b, 3, s] position triples; none for the audio
    encoder (its convolutional positional frontend is stubbed, as in the
    reference)."""
    if cfg.family == "audio":
        return q, k
    if cfg.m_rope:
        sections = tuple(cfg.m_rope_sections)
        return (L.apply_m_rope(q, positions, cfg.rope_theta, sections),
                L.apply_m_rope(k, positions, cfg.rope_theta, sections))
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta))


def _decode_attention(q, k_cache, v_cache, pos, tables=None, shard=None):
    """THE decision point for decode-path attention: a [b, t, nh, hd]
    window at absolute positions pos .. pos + t - 1 (KV position j is
    visible to window row r iff j <= pos + r).  Under `attn_impl("pim")`
    every case runs an Attn-PIM kernel — the dense one over a slab, the
    paged one over pages (`tables` given); otherwise the plain path, which
    first gathers a paged cache into a contiguous view.  `shard` (mesh,
    KV heads, axis) marks the rank's own KV-head shard: one Attn-PIM unit
    of the `*_sharded` kernels."""
    t = q.shape[1]
    if L.current_attn_impl() == "pim":
        if tables is not None:
            return L.decode_attention_pim_paged(q, k_cache, v_cache, tables,
                                                lens=pos + t, shard=shard)
        return L.decode_attention_pim(q, k_cache, v_cache, lens=pos + t,
                                      shard=shard)
    if tables is not None:
        k_cache = L.gather_kv_pages(k_cache, tables)
        v_cache = L.gather_kv_pages(v_cache, tables)
    return L.decode_attention_xla(q, k_cache, v_cache, cache_len=pos + t,
                                  q_offset=pos)


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """How a layer's attention heads lie on this rank under a mesh: the
    tensor axis (the one "heads" maps to), the q heads it holds (``q0``
    .. ``q0 + nq``) of ``nh``, whether its KV heads are its own shard
    (``kv_local``) or all of them, the GQA group ``g`` of the whole model,
    and the mesh axes a sequence-split slab lies over (``seq``: ("data",
    "model") under the long-context and 2D tables; None: the tensor axis
    alone)."""
    mesh: object
    axis: str
    nh: int
    q0: int
    nq: int
    kv_local: bool
    g: int
    seq: tuple | None = None

    @property
    def q_split(self) -> bool:
        return self.nq < self.nh


def head_split(cfg: ModelConfig, q: torch.Tensor,
               k: torch.Tensor) -> HeadSplit | None:
    """This rank's `HeadSplit` from the rules (None outside a mesh), with
    the local q / new-K head counts checked against it."""
    mesh = current_mesh()
    if mesh is None:
        return None
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    hs, hi = tensor_split("heads", nh)
    ks, _ = tensor_split("kv_heads", nkv)
    if q.shape[2] != nh // hs or k.shape[2] != nkv // ks:
        raise ValueError(f"{cfg.name}: local q/K heads {q.shape[2]}/"
                         f"{k.shape[2]} do not match the rules' split "
                         f"{nh}/{hs}, {nkv}/{ks}")
    if ks > 1 and ks != hs:
        raise ValueError("KV heads split but q heads split otherwise")
    axis = (current_rules() or {}).get("heads")
    return HeadSplit(mesh, axis if isinstance(axis, str) else "model", nh,
                     hi * (nh // hs), nh // hs, ks > 1, nh // nkv,
                     seq_axes())


def kv_for_heads(k: torch.Tensor, sp: HeadSplit) -> torch.Tensor:
    """K/V [..., nkv, hd] with every KV head -> the KV heads the rank's q
    heads read (q head h reads kv head h // g), laid out so that the
    plain GQA fold pairs them: a head slice where the local q heads cover
    whole groups or sit inside one, else one KV head per q head."""
    lo = sp.q0 // sp.g
    if sp.nq % sp.g == 0:
        return k[..., lo:lo + sp.nq // sp.g, :]
    if sp.g % sp.nq == 0:
        return k[..., lo:lo + 1, :]
    idx = torch.arange(sp.q0, sp.q0 + sp.nq, device=k.device) // sp.g
    return k.index_select(k.dim() - 2, idx)


def _seq_split_attention(q, k_cache, v_cache, pos, kv_seq, sp: HeadSplit):
    """Decode attention over a sequence-split slab: each rank's plain
    attention covers its slice of positions for every q head (the window
    rows keep their global positions), the partial max, sum and
    unnormalised output are all-gathered over every mesh axis of the
    split (``sp.seq``, innermost first, so the parts stand in the
    row-major order of the slices), and every rank merges them in that
    order — the split-S kernel's merge: every rank holds the same bytes.
    q holds all heads."""
    b, t, nh, hd = q.shape
    span, nkv = k_cache.shape[1], k_cache.shape[2]
    g = nh // nkv
    qg = q.reshape(b, t, nkv, g, hd)
    s = torch.einsum("bthgk,bshk->bthgs", qg, k_cache).float()
    s = s * (1.0 / math.sqrt(hd))
    kv_pos = kv_seq[0] + torch.arange(span, device=q.device)
    q_pos = pos[:, None] + torch.arange(t, device=q.device)[None, :]
    valid = ((kv_pos[None, None, :] <= q_pos[..., None])
             & (kv_pos[None, None, :] < (pos + t)[:, None, None]))
    s = s.masked_fill(~valid[:, :, None, None, :], float("-inf"))
    m = s.amax(dim=-1)                                       # [b,t,nkv,g]
    m_safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe[..., None])
    part = torch.cat([
        m[..., None], p.sum(dim=-1)[..., None],
        torch.einsum("bthgs,bshk->bthgk", p.to(v_cache.dtype),
                     v_cache).float()], dim=-1)               # [..., 2+hd]
    parts = part[None]
    for axis in reversed(sp.seq or (sp.axis,)):
        parts = sp.mesh.all_gather(parts, axis, dim=0)
    ms = parts[..., 0]
    big = ms.amax(dim=0)
    scale = torch.where(torch.isinf(ms), torch.zeros_like(ms),
                        torch.exp(ms - big))
    den = torch.zeros_like(big)
    out = torch.zeros(big.shape + (hd,), dtype=torch.float32,
                      device=q.device)
    for r in range(parts.shape[0]):                          # rank order
        den = den + scale[r] * parts[r, ..., 1]
        out = out + scale[r][..., None] * parts[r, ..., 2:]
    out = out / torch.clamp(den[..., None], min=1e-30)
    return out.reshape(b, t, nh, hd).to(q.dtype)


def _mesh_decode_attention(cfg, q, k_cache, v_cache, pos, tables, kv_seq,
                           sp: HeadSplit):
    """Decode attention on one rank of a mesh.  q holds the rank's q heads;
    the result holds the same heads.
      * KV heads split with the q heads: each rank attends over its own
        heads (`decode_attention_sharded` under "pim"), no cross-rank term;
      * sequence-split slab: the q heads are gathered and the partials of
        every rank's slice merged (`_seq_split_attention`; plain only),
        over "model" or over (data, model);
      * KV heads whole, q heads split: under "pim" the q heads are
        gathered and the unsharded kernel runs on every rank; the plain
        path lets each local q head read its own KV head (`kv_for_heads`);
      * neither split: the unsharded call."""
    pim = L.current_attn_impl() == "pim"
    if kv_seq is not None:
        if pim:
            raise ValueError(
                "Attn-PIM needs the KV cache stored by KV head "
                "(serve_rules(attn_pim=True)), not by sequence")
        if tables is not None:
            raise ValueError("a paged cache has no sequence dim to split")
        full = (sp.mesh.all_gather(q, sp.axis, dim=2)
                if sp.q_split else q)
        out = _seq_split_attention(full, k_cache, v_cache, pos, kv_seq, sp)
        return out[:, :, sp.q0:sp.q0 + sp.nq] if sp.q_split else out
    if sp.kv_local or not sp.q_split:
        shard = (sp.mesh, cfg.num_kv_heads, sp.axis) if sp.kv_local else None
        return _decode_attention(q, k_cache, v_cache, pos, tables, shard)
    if pim:
        full = sp.mesh.all_gather(q, sp.axis, dim=2)
        out = _decode_attention(full, k_cache, v_cache, pos, tables)
        return out[:, :, sp.q0:sp.q0 + sp.nq]
    if tables is not None:
        k_cache = L.gather_kv_pages(k_cache, tables)
        v_cache = L.gather_kv_pages(v_cache, tables)
    return L.decode_attention_xla(q, kv_for_heads(k_cache, sp),
                                  kv_for_heads(v_cache, sp),
                                  cache_len=pos + q.shape[1], q_offset=pos)


def attention_block(cfg: ModelConfig, p: dict, h: torch.Tensor,
                    positions: torch.Tensor, kv, pos, mode: str,
                    tables: torch.Tensor | None = None,
                    write_lens: torch.Tensor | None = None,
                    kv_seq: tuple[int, int] | None = None):
    """Pre-norm attention sub-block.  Returns h (the KV is written in
    place when `kv` is given).  `tables` [b, max_blocks] marks the paged
    layout: `kv` are then page pools [num_pages, page, nkv, hd].
    `kv_seq` marks this rank's slice of a sequence-split slab.  Under a
    mesh q/k/v hold the rank's heads (`head_split`) and the out-projection
    sums the heads' partial products over the tensor group."""
    a_in = L.norm(h, p["norm1"], cfg.norm, cfg.norm_eps)
    q, k, v = L.qkv_project(a_in, p["attn"], heads=cfg.num_heads,
                            kv_heads=cfg.num_kv_heads)
    q, k = _apply_positional(cfg, q, k, positions)
    sp = head_split(cfg, q, k)
    if mode == "decode":
        if tables is not None:
            _write_kv_paged(kv[0], kv[1], k, v, pos, tables,
                            valid_lens=write_lens)
        else:
            # chunked prefill masks ragged tails and non-chunking slots;
            # the hot decode path keeps the plain slice write
            _write_kv_window(kv[0], kv[1], k, v, pos, write_lens, kv_seq)
        if sp is None:
            attn = _decode_attention(q, kv[0], kv[1], pos, tables)
        else:
            attn = _mesh_decode_attention(cfg, q, kv[0], kv[1], pos, tables,
                                          kv_seq, sp)
    else:
        if sp is not None and sp.q_split and not sp.kv_local:
            attn = L.flash_attention(q, kv_for_heads(k, sp),
                                     kv_for_heads(v, sp), causal=cfg.causal)
        else:
            attn = L.flash_attention(q, k, v, causal=cfg.causal)
        if kv is not None:          # prefill: persist the new KV
            _write_kv_window(kv[0], kv[1], k, v, torch.zeros_like(pos), None,
                             kv_seq)
    return h + L.out_project(attn, p["attn"], heads=cfg.num_heads,
                             d=h.shape[-1])


def mlp_block(cfg: ModelConfig, p: dict, h: torch.Tensor,
              split: DataSplit | None = None):
    """Pre-norm MLP or MoE sub-block.  Returns (h, aux): the MoE layer's
    load-balancing loss (which only training reads; over the global
    batch's groups under a data `split`), None for an MLP."""
    m_in = L.norm(h, p["norm2"], cfg.norm, cfg.norm_eps)
    if cfg.family == "moe":
        data = None if split is None else (split.mesh, split.axis)
        y, aux = M.moe_mlp(m_in, p["moe"], cfg.moe, data=data)
        return h + y, aux
    mlp = L.swiglu_mlp if cfg.mlp == "swiglu" else L.gelu_mlp
    return h + mlp(m_in, p["mlp"], units=cfg.d_ff), None


def ssm_block(cfg: ModelConfig, p: dict, h: torch.Tensor,
              state: S.SSMState | None, mode: str,
              out: S.SSMState | None = None,
              lens: torch.Tensor | None = None) -> torch.Tensor:
    """Pre-norm Mamba2 sub-block: the prefill writes the state (when
    given) in place, stopping each row at lens[b]; the decode step reads
    it and writes `out`."""
    u = L.norm(h, p["norm"], cfg.norm, cfg.norm_eps)
    y, _ = S.mamba2_block(u, p["ssm"], cfg.ssm, cfg.d_model, state=state,
                          decode=(mode == "decode"), out=out, lens=lens,
                          train=(mode == "train"))
    return h + y


def _remat(fn, remat: bool):
    """fn, or fn under activation checkpointing: its activations are not
    kept, and the backward pass runs it again."""
    if not remat:
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _transformer_backbone(cfg, layers, h, positions, cache, mode,
                          write_lens=None, remat=False, split=None):
    """Loop over the layers; each layer writes its own KV slab (or its own
    page pool, when the cache carries block tables).  Returns (h, the sum
    of the MoE layers' aux losses, 0.0 without MoE)."""
    pos = cache["pos"] if cache is not None else None
    tables = cache.get("block_tables") if cache is not None else None
    kv_seq = cache.get("kv_seq") if cache is not None else None

    def layer(h, lp, kv):
        if split is not None:
            lp = split.gather(lp)
        h = attention_block(cfg, lp, h, positions, kv, pos, mode,
                            tables=tables, write_lens=write_lens,
                            kv_seq=kv_seq)
        return mlp_block(cfg, lp, h, split)

    run = _remat(layer, remat)
    aux = 0.0
    for i, lp in enumerate(layers):
        kv = (cache["k"][i], cache["v"][i]) if cache is not None else None
        h, aux_l = run(h, lp, kv)
        if aux_l is not None:
            aux = aux + aux_l
    return h, aux


def _ssm_layers(cfg, layers, h, cache, mode, lo, hi, ssm_out=None,
                lens=None, remat=False, split=None):
    state = cache["ssm"] if cache is not None else None

    def layer(p, h, st, out):
        if split is not None:
            p = split.gather(p)
        return ssm_block(cfg, p, h, st, mode, out, lens)

    run = _remat(layer, remat)
    for i in range(lo, hi):
        h = run(layers[i], h, layer_state(state, i), layer_state(ssm_out, i))
    return h


def _hybrid_backbone(cfg, layers, shared, h, positions, cache, mode,
                     ssm_out=None, lens=None, remat=False, split=None):
    """zamba2: segments of `period` Mamba2 blocks, the shared (weight-tied)
    attention+MLP block after each — `num_layers // period` applications,
    application `app` on KV slab `app` — then the remainder segment.
    `remat` covers the Mamba2 blocks, not the shared block, as in the
    reference.  Under a mesh the shared block is banked as a dense layer
    (`head_split`, the FC banks), each application on its own slab (split
    by KV head under ``attn_pim``, else by sequence)."""
    period = cfg.hybrid.period
    pos = cache["pos"] if cache is not None else None
    kv_seq = cache.get("kv_seq") if cache is not None else None
    lo = 0
    for app in range(cfg.num_attention_applications()):
        h = _ssm_layers(cfg, layers, h, cache, mode, lo, lo + period,
                        ssm_out, lens, remat, split)
        kv = (cache["k"][app], cache["v"][app]) if cache is not None else None
        h = attention_block(cfg, shared, h, positions, kv, pos, mode,
                            kv_seq=kv_seq)
        h, _ = mlp_block(cfg, shared, h)
        lo += period
    return _ssm_layers(cfg, layers, h, cache, mode, lo, cfg.num_layers,
                       ssm_out, lens, remat, split)


def backbone(cfg, params, h, positions, cache, mode, write_lens=None,
             ssm_out=None, lens=None, remat=False, split=None):
    """The family dispatch; `ssm_out` takes a decode step's new SSM state,
    and `lens` [b] stops a prefill's SSM state at each row's prompt end.
    The stateful families take no chunked-prefill writes, as in the
    reference (the `lens` mechanism could carry them later).  `remat`
    (training only) checkpoints each layer; a data `split` (training, or
    the FSDP prefill's `serve_split`) gathers each layer's blocks at its
    entry.  Returns (h, aux): the
    MoE layers' summed aux loss, 0.0 for the other families."""
    if cfg.family in ("ssm", "hybrid") and write_lens is not None:
        raise ValueError(f"{cfg.family}: chunked prefill needs maskable KV "
                         "writes")
    layers = layer_list(params, cfg.num_layers)
    if cfg.family == "ssm":
        return _ssm_layers(cfg, layers, h, cache, mode, 0, cfg.num_layers,
                           ssm_out, lens, remat, split), 0.0
    if cfg.family == "hybrid":
        return _hybrid_backbone(cfg, layers, params["shared"], h, positions,
                                cache, mode, ssm_out, lens, remat,
                                split), 0.0
    return _transformer_backbone(cfg, layers, h, positions, cache, mode,
                                 write_lens=write_lens, remat=remat,
                                 split=split)


# ---------------------------------------------------------------------------
# Heads / embedding
# ---------------------------------------------------------------------------

def vocab_split(cfg) -> tuple | None:
    """(mesh, axis, first id) of this rank's slice of the vocabulary when
    the rules split the embedding (and the untied head) over
    "embed_vocab"; None when the vocabulary is whole."""
    mesh = current_mesh()
    size, idx = tensor_split("embed_vocab", cfg.vocab_size)
    if size == 1:
        return None
    return mesh, current_rules()["embed_vocab"], idx * (cfg.vocab_size
                                                       // size)


def embed_tokens(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    """The token embedding; under a vocab-split mesh each rank looks up
    the ids of its slice (zeros elsewhere) and the rows are summed over
    the tensor group — exact, one term is non-zero."""
    # F.embedding's backward on the card sums by sorted index, without
    # the atomics of an indexing backward
    w = params["embed"]["w"]
    split = vocab_split(cfg)
    if split is None:
        return F.embedding(tokens.long(), w)
    mesh, axis, lo = split
    idx = tokens.long() - lo
    own = (idx >= 0) & (idx < w.shape[0])
    rows = F.embedding(torch.clamp(idx, 0, w.shape[0] - 1), w)
    rows = torch.where(own[..., None], rows, torch.zeros_like(rows))
    return mesh.all_reduce(rows, axis)


def _window_positions(cfg, pos: torch.Tensor, t: int) -> torch.Tensor:
    """Positions pos + j of a t-token window per slot ([b, t]); an M-RoPE
    model gets the same index in all three streams ([b, 3, t])."""
    positions = pos[:, None] + torch.arange(t, device=pos.device)[None, :]
    if cfg.m_rope:
        positions = positions[:, None, :].expand(-1, 3, -1)
    return positions


def embed_inputs(cfg, params, batch: dict):
    """Token embedding; a VLM batch may put precomputed patch embeddings
    ahead of the text, with their position triples; the audio encoder takes
    ``frames`` [b, s, d], the rows where ``mask`` is set replaced by
    ``mask_embed``, cast to the model's dtype (the reference's jnp
    promotion keeps f32 frames in f32 through a bf16 model; torch does not
    mix dtypes in a matmul).  Returns (h [b, s, d], positions).  Without ``positions``, token j sits at position j; an
    M-RoPE model gets j in all three streams, as its decode steps do (the
    reference's tokens-only prefill rotates the height and width sections
    by a filled-in garbage position instead: ROADMAP queue 3)."""
    if cfg.family == "audio":
        frames = batch["frames"]
        w = params["mask_embed"]["w"]
        if "mask" in batch:
            m = batch["mask"][..., None].to(frames.dtype)
            frames = frames * (1 - m) + w.to(frames.dtype) * m
        pos = torch.arange(frames.shape[1], device=frames.device)[None, :]
        return frames.to(w.dtype), pos
    if cfg.family == "vlm" and "patch_embeds" in batch:
        text = embed_tokens(cfg, params, batch["tokens"])
        h = torch.cat([batch["patch_embeds"].to(text.dtype), text], dim=1)
        return h, batch["positions"]
    tokens = batch["tokens"]
    h = embed_tokens(cfg, params, tokens)
    if "positions" in batch:
        return h, batch["positions"]
    start = torch.zeros(tokens.shape[0], dtype=torch.int32,
                        device=tokens.device)
    return h, _window_positions(cfg, start, tokens.shape[1])


def lm_logits(cfg, params, h: torch.Tensor) -> torch.Tensor:
    """norm(h) @ lm_head, or @ embed^T for a tied head.  Under a
    vocab-split mesh each rank computes its slice of the vocabulary and
    the slices are all-gathered (the "vocab" dim), so every rank samples
    from the same bytes.  Under the 2D weight-stationary layout an untied
    head contracts the rank's block of d in place and sums the partial
    logits over "data" in f32 (`models.linear.contract_block`)."""
    h = L.norm(h, params["final_norm"]["w"], cfg.norm, cfg.norm_eps)
    if "lm_head" in params:
        block = fsdp_block(h.shape[-1])
        if block is None:
            logits = torch.matmul(h, params["lm_head"]["w"])
        else:
            logits = contract_block(h, [params["lm_head"]["w"]], block)[0]
    else:
        logits = torch.matmul(h, params["embed"]["w"].t())
    split = vocab_split(cfg)
    if split is not None:
        logits = split[0].all_gather(logits, split[1], dim=-1)
    return logits


def nll_sums(logits: torch.Tensor, targets: torch.Tensor,
             mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the masked token NLL, sum of the mask), in f32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    return ((lse - gold) * mask).sum(), mask.sum()


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Masked mean token NLL, in f32."""
    num, den = nll_sums(logits, targets, mask)
    return num / torch.clamp(den, min=1.0)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """The residual stream of a train split over the tensor axis ``axis``
    (module docstring): ``seq`` where tp divides the sequence of ``n``
    positions, so each rank holds its block of them, else whole on every
    rank; the rank's q heads (``heads``: the KV heads whole, as
    `train_rules` keep them) and whether the FFN is split (``ffn``).  A
    layer reads these, not the installed rules: its recompute runs in the
    backward, where the rules may not be installed."""
    mesh: object
    axis: str
    n: int
    seq: bool
    heads: HeadSplit
    ffn: bool

    @classmethod
    def of(cls, cfg, split: DataSplit, n: int) -> "SeqSplit":
        """The split of an n-position residual under the installed rules
        and `split`'s tensor axis."""
        nh, nkv = cfg.num_heads, cfg.num_kv_heads
        hs, hi = tensor_split("heads", nh)
        if tensor_split("kv_heads", nkv)[0] > 1:
            raise ValueError("a train split keeps the KV heads whole "
                             "(train_rules' \"kv_heads\": None)")
        heads = HeadSplit(split.mesh, split.model, nh, hi * (nh // hs),
                          nh // hs, False, nh // nkv)
        return cls(split.mesh, split.model, n,
                   split_axis("seq", n) is not None, heads,
                   split_axis("ffn", cfg.d_ff) is not None)

    def enter(self, x: torch.Tensor, split: bool = True) -> torch.Tensor:
        """The input of a sub-block from the rank's residual rows: every
        row (a gather whose backward reduce-scatters); with the residual
        whole, x, whose gradient a `split` bank's partial backward sums
        over the axis."""
        if self.seq:
            return self.mesh.seq_gather(x, self.axis)
        return self.mesh.replicated_grad([x], self.axis)[0] if split else x

    def leave(self, y: torch.Tensor, split: bool = True) -> torch.Tensor:
        """The rank's residual rows of a sub-block's output over every
        row: a `split` bank's partial products summed over the axis (a
        reduce-scatter with the residual split, else a sum whose backward
        passes through); a whole one's rows as they are."""
        if not split:
            return self.rows(y)
        if self.seq:
            return self.mesh.seq_scatter(y, self.axis)
        return self.mesh.all_reduce_grad(y, self.axis)

    def partial(self, split: DataSplit):
        """Of a leaf key, whether the leaf is whole over the axis and each
        rank's gradient of it a part (summed over the axis in
        `DataSplit.prepare`): every such leaf where the residual is split
        over the sequence (its rows, or its heads, are the rank's), and
        with the residual whole the K/V projections that split q heads
        read (each rank's heads read them)."""
        whole = {k for k, sp in flatten_tree(split.specs)
                 if split.model_dim(sp) is None}
        kv = ("w_k", "w_v", "b_k", "b_v")

        def partial(key: str) -> bool:
            return key in whole and (self.seq or (
                self.heads.q_split and key.startswith("layers/attn/")
                and key.rsplit("/", 1)[1] in kv))
        return partial

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's block of dim 1 of x over every row."""
        if not self.seq:
            return x
        k = self.n // self.mesh.shape[self.axis]
        return x.narrow(1, self.mesh.coords[self.axis] * k, k)


def _train_seq_len(cfg, batch: dict) -> int:
    """The residual's sequence length of a train batch."""
    if cfg.family == "audio":
        return batch["frames"].shape[1]
    n = batch["tokens"].shape[1]
    if cfg.family == "vlm" and "patch_embeds" in batch:
        n += batch["patch_embeds"].shape[1]
    return n


def _train_embed(cfg, params, batch: dict, res: SeqSplit):
    """`embed_inputs` onto the rank's residual rows: a vocab-split
    embedding's partial rows (zeros where another rank owns the id, a
    VLM's patch rows on the axis's first rank only) summed over the axis;
    else every row computed whole, the rank's kept."""
    split = vocab_split(cfg)
    if cfg.family == "audio" or split is None:
        h, positions = embed_inputs(cfg, params, batch)
        return res.leave(h, split=False), positions
    mesh, axis, lo = split
    w = params["embed"]["w"]
    idx = batch["tokens"].long() - lo
    own = (idx >= 0) & (idx < w.shape[0])
    rows = F.embedding(torch.clamp(idx, 0, w.shape[0] - 1), w)
    rows = torch.where(own[..., None], rows, torch.zeros_like(rows))
    if cfg.family == "vlm" and "patch_embeds" in batch:
        patch = batch["patch_embeds"].to(rows.dtype)
        if mesh.coords[axis]:
            patch = torch.zeros_like(patch)
        rows = torch.cat([patch, rows], dim=1)
    if "positions" in batch:
        positions = batch["positions"]
    else:
        start = torch.zeros(rows.shape[0], dtype=torch.int32,
                            device=rows.device)
        positions = _window_positions(cfg, start, rows.shape[1])
    return res.leave(rows), positions


def _train_attention(cfg, p: dict, h, positions, res: SeqSplit):
    """The pre-norm attention sub-block on the rank's residual rows: every
    row's q of the rank's heads, K/V of every KV head ("kv_heads" is
    whole under `train_rules`; each q head reads its group's,
    `kv_for_heads`), the out-projection's partial products back to the
    rank's rows."""
    sp = res.heads
    a_in = L.norm(h, p["norm1"], cfg.norm, cfg.norm_eps)
    # a column group: "pu" (`torch.matmul`), no collective
    q, k, v = L.qkv_project(res.enter(a_in, sp.q_split), p["attn"],
                            heads=cfg.num_heads, kv_heads=cfg.num_kv_heads)
    q, k = _apply_positional(cfg, q, k, positions)
    if sp.q_split:
        k, v = kv_for_heads(k, sp), kv_for_heads(v, sp)
    attn = L.flash_attention(q, k, v, causal=cfg.causal)
    b, s, nq, hd = attn.shape
    w = p["attn"]["w_o"]
    y = torch.matmul(attn.reshape(b, s, nq * hd), w.reshape(nq * hd, -1))
    return h + res.leave(y, sp.q_split)


def _train_mlp(cfg, p: dict, h, res: SeqSplit):
    """The pre-norm MLP sub-block on the rank's residual rows: a split FFN
    on every row and its down / ``w_out`` bank's partial products back to
    the rank's rows; a whole one on the rank's rows alone."""
    split = res.ffn
    m_in = L.norm(h, p["norm2"], cfg.norm, cfg.norm_eps)
    x = res.enter(m_in) if split else m_in
    q = p["mlp"]
    if cfg.mlp == "swiglu":
        gate, up = torch.matmul(x, q["w_gate"]), torch.matmul(x, q["w_up"])
        act = F.silu(gate.float()).to(x.dtype) * up
        y = torch.matmul(act, q["w_down"])
        return h + (res.leave(y) if split else y)
    a = torch.matmul(x, q["w_in"]) + q["b_in"]
    a = F.gelu(a.float(), approximate="tanh").to(x.dtype)
    y = torch.matmul(a, q["w_out"])
    return h + ((res.leave(y) if split else y) + q["b_out"])


def _vocab_nll_sums(logits, targets, mask, mesh, axis: str, lo: int):
    """`nll_sums` of logits over the rank's slice of the vocabulary (ids
    lo ..): the max over every slice (gathered, no gradient), the sums of
    exponentials and the gold logit, which one rank's slice holds, summed
    over `axis` in one collective whose backward passes through (every
    rank computes the same loss from them)."""
    lf = logits.float()
    with torch.no_grad():
        big = mesh.all_gather(lf.amax(dim=-1)[None], axis, 0).amax(dim=0)
    se = torch.exp(lf - big[..., None]).sum(dim=-1)
    idx = targets.long() - lo
    own = (idx >= 0) & (idx < lf.shape[-1])
    gold = torch.gather(lf, -1, torch.clamp(idx, 0, lf.shape[-1] - 1)
                        [..., None])[..., 0]
    gold = torch.where(own, gold, torch.zeros_like(gold))
    se, gold = mesh.all_reduce_grad(torch.stack([se, gold]), axis)
    lse = big + torch.log(se)
    return ((lse - gold) * mask).sum(), mask.sum()


def _train_nll_sums(cfg, params, h, targets, mask, res: SeqSplit):
    """`nll_sums` of the model's head over the rank's residual rows, as
    one [2] tensor: a vocab-split head on every row and the rank's
    vocabulary (`_vocab_nll_sums`, the same sums on every rank); a whole
    one on the rank's rows, its sums added over the axis where the rows
    are split."""
    hn = L.norm(h, params["final_norm"]["w"], cfg.norm, cfg.norm_eps)
    w = (params["lm_head"]["w"] if "lm_head" in params
         else params["embed"]["w"].t())
    split = vocab_split(cfg)
    if split is not None:
        logits = torch.matmul(res.enter(hn), w)
        return torch.stack(_vocab_nll_sums(logits, targets, mask, *split))
    sums = torch.stack(nll_sums(torch.matmul(hn, w), res.rows(targets),
                                res.rows(mask)))
    return res.mesh.all_reduce_grad(sums, res.axis) if res.seq else sums


def _train_tensor_split(cfg, params, batch: dict, remat: bool,
                        split: DataSplit):
    """`forward_train`'s backbone and loss sums under a tensor split
    (module docstring): [num, den] on every rank, before the sum over
    "data"."""
    n = _train_seq_len(cfg, batch)
    res = SeqSplit.of(cfg, split, n)
    params = split.prepare(params, res.partial(split))
    h, positions = _train_embed(cfg, params, batch, res)

    def layer(h, lp):
        lp = split.gather(lp)
        h = _train_attention(cfg, lp, h, positions, res)
        return _train_mlp(cfg, lp, h, res)

    run = _remat(layer, remat)
    with set_checkpoint_early_stop(False):
        for lp in layer_list(params, cfg.num_layers):
            h = run(h, lp)
    return _train_nll_sums(cfg, params, h, *_train_targets(cfg, batch, n),
                           res)


def _train_targets(cfg, batch: dict, n: int):
    """(targets, mask) over the n positions of the residual: the mask of
    ones unless the batch has ``target_mask``; a VLM's text targets padded
    out over its vision prefix."""
    targets = batch["targets"]
    mask = batch.get("target_mask")
    mask = (torch.ones(targets.shape, device=targets.device)
            if mask is None else mask.float())
    if cfg.family == "vlm":
        pad = n - targets.shape[1]
        targets = F.pad(targets, (pad, 0))
        mask = F.pad(mask, (pad, 0))
    return targets, mask


def forward_train(cfg, params, batch: dict, *, remat: bool = True):
    """One training forward: (loss, {"ce", "aux"}).  loss = ce + the MoE
    aux weight x the layers' summed aux loss / num_layers; a VLM's targets
    cover the text tail only, so the vision prefix is padded out of the
    loss; an audio batch's ``target_mask`` picks the masked frames.  Under
    a train split (`data_split`) `params` are the rank's blocks and `batch`
    its rows (module docstring)."""
    split = data_split(cfg)
    if split is not None and split.model is not None:
        # no MoE layer: no aux loss
        num, den = split.sum(_train_tensor_split(cfg, params, batch, remat,
                                                 split))
        ce = num / torch.clamp(den, min=1.0)
        return ce, {"ce": ce.detach(), "aux": torch.zeros_like(ce)}
    if split is not None:
        params = split.prepare(params)
    h, positions = embed_inputs(cfg, params, batch)
    h, aux = backbone(cfg, params, h, positions, None, "train", remat=remat,
                      split=split)
    logits = lm_logits(cfg, params, h)
    targets, mask = _train_targets(cfg, batch, logits.shape[1])
    aux = torch.as_tensor(aux, dtype=torch.float32, device=logits.device)
    if split is None:
        ce = cross_entropy(logits, targets, mask)
    else:
        # the global mean: every rank's NLL and mask sums (and MoE aux
        # shares) summed before the division, in one collective (a mean
        # of the ranks' means would weight each rank's rows by its count)
        num, den = nll_sums(logits, targets, mask)
        num, den, aux = split.sum(torch.stack([num, den, aux]))
        ce = num / torch.clamp(den, min=1.0)
    aux_w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
    loss = ce + aux_w * aux / max(cfg.num_layers, 1)
    return loss, {"ce": ce.detach(), "aux": aux.detach()}


def prefill(cfg, params, batch: dict, cache: dict):
    """Process the prompt, fill the cache, return last-position logits.
    Without ``prompt_lens``, every row is a whole prompt; with it, the SSM
    state stops at each row's prompt end."""
    _check_decoder(cfg)
    params, split = _serve_params(cfg, params)
    h, positions = embed_inputs(cfg, params, batch)
    prompt_lens = batch.get("prompt_lens")
    h, _ = backbone(cfg, params, h, positions, cache, "prefill",
                    lens=prompt_lens, split=split)
    if prompt_lens is None:
        prompt_lens = torch.full((h.shape[0],), h.shape[1],
                                 dtype=torch.int32, device=h.device)
    cache["pos"] = prompt_lens.to(torch.int32)
    idx = torch.clamp(prompt_lens.long() - 1, 0, h.shape[1] - 1)
    h_last = h[torch.arange(h.shape[0], device=h.device), idx][:, None]
    return lm_logits(cfg, params, h_last)[:, 0], cache


def prefill_to_slots(cfg, params, batch: dict, cache: dict,
                     src: torch.Tensor):
    """Batched admission: prefill a fixed-shape batch of new requests and
    merge each into its slot of the engine cache, in place.  src[s] is the
    batch row admitted into slot s, or -1 to leave slot s untouched.  The
    temporary cache is sized to the prefill window, and only its first
    p_len KV positions are merged, so padded prompt rows never reach a
    live slot's KV; an admitted slot's SSM state is replaced whole by its
    prompt's own (`prefill` stops it at the prompt's end; the reference's
    takes in the padding).
    Returns (first_tokens [slots] int32, cache); -1 for untouched slots."""
    n, p_len = batch["tokens"].shape
    kv_seq = cache.get("kv_seq")
    if "k" in cache:
        p_len = min(p_len, kv_seq[1] if kv_seq else cache["k"].shape[2])
    tmp = init_cache(cfg, n, p_len, cache["pos"].device, split=False)
    logits, tmp = prefill(cfg, params, batch, tmp)

    take = torch.clamp(src.long(), min=0)             # [slots] row gather
    keep = src < 0                                     # [slots] untouched

    def merge(old, new):
        # old: [L, slots, ...], new: [L, n, ...]: gather by slot, select
        mask = keep.reshape((1, -1) + (1,) * (old.dim() - 2))
        old.copy_(torch.where(mask, old, new.index_select(1, take)))

    # a sequence-split slab merges the prompt positions of its own slice
    lo = kv_seq[0] if kv_seq else 0
    hi = min(p_len, lo + cache["k"].shape[2]) if "k" in cache else lo
    for key in ("k", "v"):
        if key in cache and hi > lo:
            merge(cache[key][:, :, :hi - lo], tmp[key][:, :, lo:hi])
    if "ssm" in cache:
        for old, new in zip(cache["ssm"], tmp["ssm"]):
            merge(old, new)
    cache["pos"] = torch.where(keep, cache["pos"],
                               tmp["pos"].index_select(0, take))
    first = torch.argmax(logits, dim=-1).to(torch.int32)        # [n]
    first_slots = torch.where(keep, torch.full_like(src, -1),
                              first.index_select(0, take))
    return first_slots.to(torch.int32), cache


def prefill_to_pages(cfg, params, batch: dict, cache: dict,
                     src: torch.Tensor):
    """Batched admission into the PAGED cache: prefill a fixed-shape batch
    and scatter each admitted request's prompt KV onto its block-table
    pages, in place — the contract of `prefill_to_slots`.  The engine maps
    the prompt's pages before the call.  Rows the mask rejects (slots left
    untouched, positions past a prompt's length) go to the garbage page 0.
    Returns (first_tokens [slots] int32, cache); -1 for untouched slots."""
    n, p_len = batch["tokens"].shape
    tables = cache["block_tables"]
    slots, max_blocks = tables.shape
    page_size = cache["k"].shape[2]
    dev = cache["k"].device
    tmp = init_cache(cfg, n, p_len, dev, split=False)
    logits, tmp = prefill(cfg, params, batch, tmp)

    take = torch.clamp(src.long(), min=0)             # [slots] row gather
    keep = src < 0                                     # [slots] untouched
    tok = torch.arange(p_len, device=dev)[None, :].expand(slots, p_len)
    lens = batch["prompt_lens"].long().index_select(0, take)       # [slots]
    valid = (~keep)[:, None] & (tok < lens[:, None])               # [slots, P]
    blk = torch.clamp(tok // page_size, 0, max_blocks - 1)
    phys = torch.gather(tables.long(), 1, blk)
    phys = torch.where(valid, phys, torch.zeros_like(phys))
    row = tok % page_size
    for key in ("k", "v"):
        cache[key][:, phys, row] = tmp[key].index_select(1, take)
    cache["pos"] = torch.where(keep, cache["pos"],
                               tmp["pos"].index_select(0, take))
    first = torch.argmax(logits, dim=-1).to(torch.int32)        # [n]
    first_slots = torch.where(keep, torch.full_like(src, -1),
                              first.index_select(0, take))
    return first_slots.to(torch.int32), cache


def chunk_logits(cfg, params, cache: dict, tokens: torch.Tensor,
                 chunk_lens: torch.Tensor):
    """One chunked-prefill wave through the decode path: a [slots, P]
    window at each slot's running position, KV writes masked to the first
    chunk_lens[s] tokens, pos advanced by chunk_lens.  Returns the logits
    after each slot's last valid chunk token ([slots, V]; garbage for rows
    with chunk_lens == 0) and the cache."""
    _check_decoder(cfg)
    params, split = _serve_params(cfg, params)
    b, t = tokens.shape
    pos = cache["pos"]
    h, positions = embed_inputs(cfg, params, {
        "tokens": tokens, "positions": _window_positions(cfg, pos, t)})
    h, _ = backbone(cfg, params, h, positions, cache, "decode",
                    write_lens=chunk_lens, split=split)
    idx = torch.clamp(chunk_lens.long() - 1, 0, t - 1)
    h_last = h[torch.arange(b, device=h.device), idx][:, None]
    logits = lm_logits(cfg, params, h_last)
    cache["pos"] = pos + chunk_lens.to(torch.int32)
    return logits[:, 0], cache


def mixed_step(cfg, params, cache: dict, tokens: torch.Tensor,
               chunk_lens: torch.Tensor, pin_mask: torch.Tensor,
               pin_pos: torch.Tensor):
    """One continuous-batching wave: prefill chunks and single-token
    decodes in the same [slots, P] window.  A decode is a chunk of length 1
    holding the slot's last token.  A slot mid-prefill rides every other
    step as a masked garbage row whose device position drifts, so the rows
    in `pin_mask` are re-anchored to the host's chunk offset `pin_pos`
    first; decode rows keep their device position.  Returns `chunk_logits`'
    (logits [slots, V], cache)."""
    cache["pos"] = torch.where(pin_mask, pin_pos.to(torch.int32),
                               cache["pos"]).to(torch.int32)
    return chunk_logits(cfg, params, cache, tokens, chunk_lens)


def prefill_chunk(cfg, params, cache, tokens, chunk_lens):
    """`chunk_logits` followed by the greedy argmax."""
    logits, cache = chunk_logits(cfg, params, cache, tokens, chunk_lens)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def decode_step(cfg, params, cache: dict, tokens: torch.Tensor,
                ssm_steps: S.SSMState | None = None,
                positions: torch.Tensor | None = None):
    """tokens [b, t] -> (logits [b, t, V], cache).  `ssm_steps`
    (`ssm_step_buffers(cache, t)`) takes the SSM state after each of the t
    tokens; ``cache["ssm"]`` is then its last token's.  `positions`
    (default: pos + j, each stream of an M-RoPE triple alike) rotate the
    window's q and k."""
    _check_decoder(cfg)
    params, split = _serve_params(cfg, params)
    b, t = tokens.shape
    pos = cache["pos"]
    if positions is None:
        positions = _window_positions(cfg, pos, t)
    h, positions = embed_inputs(cfg, params, {"tokens": tokens,
                                              "positions": positions})
    # the new SSM state goes to fresh tensors, as `pos` is replaced: the
    # state this step read stays as it was
    new = ssm_steps
    if new is None and "ssm" in cache:
        new = S.SSMState(*map(torch.empty_like, cache["ssm"]))
    h, _ = backbone(cfg, params, h, positions, cache, "decode", ssm_out=new,
                    split=split)
    logits = lm_logits(cfg, params, h)
    cache["pos"] = pos + t
    if ssm_steps is not None:
        cache["ssm"] = S.SSMState(*(x[:, -1] for x in ssm_steps))
    elif new is not None:
        cache["ssm"] = new
    return logits, cache


def ssm_step_buffers(cache: dict, t: int) -> S.SSMState | None:
    """Per-token SSM state buffers for a t-token decode window: each
    tensor of ``cache["ssm"]`` with a [t] axis after the layer axis ([L,
    t, b, ...]); None for a cache without SSM state."""
    if "ssm" not in cache:
        return None
    return S.SSMState(*(x.new_empty((x.shape[0], t) + x.shape[1:])
                        for x in cache["ssm"]))


def rewind_ssm(cache: dict, steps: S.SSMState | None, n: torch.Tensor):
    """Select each slot's SSM state after n[s] >= 1 tokens of the window
    `steps` recorded (`decode_step`'s ``ssm_steps``) into fresh tensors,
    on the device; the caller rewinds ``pos`` itself.  No-op for None."""
    if steps is not None:
        idx = n.long() - 1
        slots = torch.arange(idx.shape[0], device=idx.device)
        cache["ssm"] = S.SSMState(*(x[:, idx, slots] for x in steps))
    return cache
