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

Entry points:
  init_params(cfg, generator)            -> params
  forward_train(cfg, params, batch, remat=True) -> (loss, metrics)
  init_cache(cfg, batch, capacity, device)
  init_paged_cache(cfg, max_slots, num_pages, page_size, max_blocks, device)
  prefill(cfg, params, batch, cache)     -> (last_logits, cache)
  prefill_to_slots(cfg, params, batch, cache, src) -> (first_tokens, cache)
  prefill_to_pages(cfg, params, batch, cache, src) -> (first_tokens, cache)
  chunk_logits / prefill_chunk(cfg, params, cache, tokens, chunk_lens)
  decode_step(cfg, params, cache, tokens, ssm_steps=None) -> (logits, cache)
  ssm_step_buffers(cache, t) / rewind_ssm(cache, steps, n) -> cache
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

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


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES or (cfg.mlp != "swiglu"
                                      and cfg.family != "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the port runs {'/'.join(FAMILIES)} models with a "
            "swiglu MLP (a gelu MLP in the audio encoder only)")


def _check_decoder(cfg: ModelConfig) -> None:
    """Refuse a cache or a decode step for an encoder-only model."""
    _check_family(cfg)
    if not cfg.has_decode_step:
        raise ValueError(f"{cfg.name} is encoder-only: it has no cache and "
                         "no decode step (train it with forward_train)")


def host_copies_per_forward(cfg: ModelConfig) -> int:
    """Device->host copies one forward of the model makes: one per MoE
    layer (`moe.moe_mlp` reads its per-expert counts), none otherwise."""
    return cfg.num_layers if cfg.family == "moe" else 0


def _attn_spec(cfg: ModelConfig, residual_std: float) -> dict:
    d, nh, nkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    std = d ** -0.5
    p = {
        "w_q": PSpec((d, nh, hd), std=std),
        "w_k": PSpec((d, nkv, hd), std=std),
        "w_v": PSpec((d, nkv, hd), std=std),
        "w_o": PSpec((nh, hd, d), std=residual_std),
    }
    if cfg.qkv_bias:
        p["b_q"] = PSpec((nh, hd), "zeros")
        p["b_k"] = PSpec((nkv, hd), "zeros")
        p["b_v"] = PSpec((nkv, hd), "zeros")
    return p


def _mlp_spec(cfg: ModelConfig, residual_std: float) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    std = d ** -0.5
    if cfg.mlp == "swiglu":
        return {
            "w_gate": PSpec((d, f), std=std),
            "w_up": PSpec((d, f), std=std),
            "w_down": PSpec((f, d), std=residual_std),
        }
    return {
        "w_in": PSpec((d, f), std=std),
        "b_in": PSpec((f,), "zeros"),
        "w_out": PSpec((f, d), std=residual_std),
        "b_out": PSpec((d,), "zeros"),
    }


def _moe_spec(cfg: ModelConfig, residual_std: float) -> dict:
    d, f, e = cfg.d_model, cfg.moe.d_ff, cfg.moe.num_experts
    std = d ** -0.5
    return {
        "w_router": PSpec((d, e), std=std),
        "w_gate": PSpec((e, d, f), std=std),
        "w_up": PSpec((e, d, f), std=std),
        "w_down": PSpec((e, f, d), std=residual_std),
    }


def _ssm_spec(cfg: ModelConfig, residual_std: float) -> dict:
    s, d = cfg.ssm, cfg.d_model
    di, nh, n, k = s.d_inner(d), s.n_heads(d), s.d_state, s.conv_kernel
    std = d ** -0.5
    return {
        "w_z": PSpec((d, di), std=std),
        "w_x": PSpec((d, di), std=std),
        "w_B": PSpec((d, n), std=std),
        "w_C": PSpec((d, n), std=std),
        "w_dt": PSpec((d, nh), std=std),
        "conv_x": PSpec((k, di), std=1 / math.sqrt(k)),
        "conv_B": PSpec((k, n), std=1 / math.sqrt(k)),
        "conv_C": PSpec((k, n), std=1 / math.sqrt(k)),
        # f32 in any model dtype: recurrence-critical, as in the reference
        "A_log": PSpec((nh,), "a_log", dtype="float32"),
        "D": PSpec((nh,), "ones"),
        "dt_bias": PSpec((nh,), "dt_bias", dtype="float32"),
        "norm_w": PSpec((di,), "ones"),
        "w_out": PSpec((di, d), std=residual_std),
    }


def _layer_spec(cfg: ModelConfig, residual_std: float) -> dict:
    """Spec of ONE layer (unstacked)."""
    d = cfg.d_model
    if cfg.family in ("ssm", "hybrid"):
        return {"norm": PSpec((d,), "ones"),
                "ssm": _ssm_spec(cfg, residual_std)}
    block = {
        "norm1": PSpec((d,), "ones"),
        "attn": _attn_spec(cfg, residual_std),
        "norm2": PSpec((d,), "ones"),
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
        return {k: (dataclasses.replace(ps, shape=(nl,) + ps.shape)
                    if isinstance(ps, PSpec) else stack(ps))
                for k, ps in tree.items()}

    spec = {
        "embed": {"w": PSpec((v, d), std=0.02)},
        "final_norm": {"w": PSpec((d,), "ones")},
        "layers": stack(_layer_spec(cfg, residual_std)),
    }
    if cfg.family == "hybrid":
        # one weight-tied attention+MLP block shared across applications
        spec["shared"] = {
            "norm1": PSpec((d,), "ones"),
            "attn": _attn_spec(cfg, residual_std),
            "norm2": PSpec((d,), "ones"),
            "mlp": _mlp_spec(cfg, residual_std),
        }
    if cfg.family == "audio":
        spec["mask_embed"] = {"w": PSpec((d,), std=0.02)}
    if cfg.decoder and not cfg.tie_embeddings:
        spec["lm_head"] = {"w": PSpec((d, v), std=d ** -0.5)}
    return spec


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random parameters on the generator's device: truncated normals
    (+-3 sigma) scaled by each leaf's std, ones for norms, zeros for
    biases, and the SSM laws for A_log (log U[a_min, a_max]) and dt_bias
    (softplus^-1 of dt ~ logU[1e-3, 1e-1]), both f32 — the reference's init
    laws, not its random numbers."""
    device = generator.device

    def make(ps: PSpec) -> torch.Tensor:
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
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -3.0, 3.0,
                                    generator=generator)
        return (x * ps.std).to(dtype)

    def walk(tree):
        return {k: (make(v) if isinstance(v, PSpec) else walk(v))
                for k, v in tree.items()}

    return walk(model_spec(cfg))


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device: torch.device | str) -> dict:
    """Decode cache: per-slot positions; dense, moe, vlm: [L, b, S, nkv,
    hd] K/V;
    ssm: ``ssm``, an `SSMState` of [L, b, ...] tensors (the SSM state f32);
    hybrid: both, with K/V [napps, b, S, nkv, hd] for the shared block's
    applications."""
    _check_decoder(cfg)
    dtype = DTYPES[cfg.dtype]
    cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.family in ("ssm", "hybrid"):
        one = S.init_state(batch, cfg.d_model, cfg.ssm, dtype, device)
        cache["ssm"] = S.SSMState(*(
            torch.zeros((cfg.num_layers,) + x.shape, dtype=x.dtype,
                        device=device) for x in one))
    if cfg.family in KV_FAMILIES + ("hybrid",):
        shape = (cfg.num_attention_applications(), batch, capacity,
                 cfg.num_kv_heads, cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def init_paged_cache(cfg: ModelConfig, max_slots: int, num_pages: int,
                     page_size: int, max_blocks: int | None,
                     device: torch.device | str) -> dict:
    """Paged decode cache: K/V in a pool of fixed-size pages (one page = one
    Attn-PIM bank row) and a per-slot block table mapping logical blocks to
    physical pages.  Page 0 is the garbage page: the tables start at 0, so
    writes of slots not yet admitted land there harmlessly."""
    _check_decoder(cfg)
    if cfg.family not in KV_FAMILIES:
        raise ValueError(
            f"paged KV cache needs a pure attention KV cache; {cfg.family} "
            "carries SSM state that has no sequence dim to page")
    if max_blocks is None:
        max_blocks = num_pages - 1
    dtype = DTYPES[cfg.dtype]
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"pos": torch.zeros((max_slots,), dtype=torch.int32, device=device),
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "block_tables": torch.zeros((max_slots, max_blocks),
                                        dtype=torch.int32, device=device)}


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


def _decode_attention(q, k_cache, v_cache, pos, tables=None):
    """THE decision point for decode-path attention: a [b, t, nh, hd]
    window at absolute positions pos .. pos + t - 1 (KV position j is
    visible to window row r iff j <= pos + r).  Under `attn_impl("pim")`
    every case runs an Attn-PIM kernel — the dense one over a slab, the
    paged one over pages (`tables` given); otherwise the plain path, which
    first gathers a paged cache into a contiguous view."""
    t = q.shape[1]
    if L.current_attn_impl() == "pim":
        if tables is not None:
            return L.decode_attention_pim_paged(q, k_cache, v_cache, tables,
                                                lens=pos + t)
        return L.decode_attention_pim(q, k_cache, v_cache, lens=pos + t)
    if tables is not None:
        k_cache = L.gather_kv_pages(k_cache, tables)
        v_cache = L.gather_kv_pages(v_cache, tables)
    return L.decode_attention_xla(q, k_cache, v_cache, cache_len=pos + t,
                                  q_offset=pos)


def attention_block(cfg: ModelConfig, p: dict, h: torch.Tensor,
                    positions: torch.Tensor, kv, pos, mode: str,
                    tables: torch.Tensor | None = None,
                    write_lens: torch.Tensor | None = None):
    """Pre-norm attention sub-block.  Returns h (the KV is written in
    place when `kv` is given).  `tables` [b, max_blocks] marks the paged
    layout: `kv` are then page pools [num_pages, page, nkv, hd]."""
    a_in = L.norm(h, p["norm1"], cfg.norm, cfg.norm_eps)
    q, k, v = L.qkv_project(a_in, p["attn"])
    q, k = _apply_positional(cfg, q, k, positions)
    if mode == "decode" and tables is not None:
        _write_kv_paged(kv[0], kv[1], k, v, pos, tables,
                        valid_lens=write_lens)
        attn = _decode_attention(q, kv[0], kv[1], pos, tables)
    elif mode == "decode":
        if write_lens is not None:
            # chunked prefill: ragged tails / non-chunking slots must not
            # write; the hot decode path keeps the plain slice write
            _write_kv_masked(kv[0], kv[1], k, v, pos, write_lens)
        else:
            _write_kv(kv[0], kv[1], k, v, pos)
        attn = _decode_attention(q, kv[0], kv[1], pos)
    else:
        attn = L.flash_attention(q, k, v, causal=cfg.causal)
        if kv is not None:          # prefill: persist the new KV
            _write_kv(kv[0], kv[1], k, v, torch.zeros_like(pos))
    return h + L.out_project(attn, p["attn"])


def mlp_block(cfg: ModelConfig, p: dict, h: torch.Tensor):
    """Pre-norm MLP or MoE sub-block.  Returns (h, aux): the MoE layer's
    load-balancing loss (which only training reads), None for an MLP."""
    m_in = L.norm(h, p["norm2"], cfg.norm, cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = M.moe_mlp(m_in, p["moe"], cfg.moe)
        return h + y, aux
    mlp = L.swiglu_mlp if cfg.mlp == "swiglu" else L.gelu_mlp
    return h + mlp(m_in, p["mlp"]), None


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
                          write_lens=None, remat=False):
    """Loop over the layers; each layer writes its own KV slab (or its own
    page pool, when the cache carries block tables).  Returns (h, the sum
    of the MoE layers' aux losses, 0.0 without MoE)."""
    pos = cache["pos"] if cache is not None else None
    tables = cache.get("block_tables") if cache is not None else None

    def layer(h, lp, kv):
        h = attention_block(cfg, lp, h, positions, kv, pos, mode,
                            tables=tables, write_lens=write_lens)
        return mlp_block(cfg, lp, h)

    run = _remat(layer, remat)
    aux = 0.0
    for i, lp in enumerate(layers):
        kv = (cache["k"][i], cache["v"][i]) if cache is not None else None
        h, aux_l = run(h, lp, kv)
        if aux_l is not None:
            aux = aux + aux_l
    return h, aux


def _ssm_layers(cfg, layers, h, cache, mode, lo, hi, ssm_out=None,
                lens=None, remat=False):
    state = cache["ssm"] if cache is not None else None
    block = _remat(functools.partial(ssm_block, cfg), remat)
    for i in range(lo, hi):
        h = block(layers[i], h, layer_state(state, i), mode,
                  layer_state(ssm_out, i), lens)
    return h


def _hybrid_backbone(cfg, layers, shared, h, positions, cache, mode,
                     ssm_out=None, lens=None, remat=False):
    """zamba2: segments of `period` Mamba2 blocks, the shared (weight-tied)
    attention+MLP block after each — `num_layers // period` applications,
    application `app` on KV slab `app` — then the remainder segment.
    `remat` covers the Mamba2 blocks, not the shared block, as in the
    reference."""
    period = cfg.hybrid.period
    pos = cache["pos"] if cache is not None else None
    lo = 0
    for app in range(cfg.num_attention_applications()):
        h = _ssm_layers(cfg, layers, h, cache, mode, lo, lo + period,
                        ssm_out, lens, remat)
        kv = (cache["k"][app], cache["v"][app]) if cache is not None else None
        h = attention_block(cfg, shared, h, positions, kv, pos, mode)
        h, _ = mlp_block(cfg, shared, h)
        lo += period
    return _ssm_layers(cfg, layers, h, cache, mode, lo, cfg.num_layers,
                       ssm_out, lens, remat)


def backbone(cfg, params, h, positions, cache, mode, write_lens=None,
             ssm_out=None, lens=None, remat=False):
    """The family dispatch; `ssm_out` takes a decode step's new SSM state,
    and `lens` [b] stops a prefill's SSM state at each row's prompt end.
    The stateful families take no chunked-prefill writes, as in the
    reference (the `lens` mechanism could carry them later).  `remat`
    (training only) checkpoints each layer.  Returns (h, aux): the MoE
    layers' summed aux loss, 0.0 for the other families."""
    if cfg.family in ("ssm", "hybrid") and write_lens is not None:
        raise ValueError(f"{cfg.family}: chunked prefill needs maskable KV "
                         "writes")
    layers = layer_list(params, cfg.num_layers)
    if cfg.family == "ssm":
        return _ssm_layers(cfg, layers, h, cache, mode, 0, cfg.num_layers,
                           ssm_out, lens, remat), 0.0
    if cfg.family == "hybrid":
        return _hybrid_backbone(cfg, layers, params["shared"], h, positions,
                                cache, mode, ssm_out, lens, remat), 0.0
    return _transformer_backbone(cfg, layers, h, positions, cache, mode,
                                 write_lens=write_lens, remat=remat)


# ---------------------------------------------------------------------------
# Heads / embedding
# ---------------------------------------------------------------------------

def embed_tokens(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding's backward on the card sums by sorted index, without
    # the atomics of an indexing backward
    return F.embedding(tokens.long(), params["embed"]["w"])


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
    """norm(h) @ lm_head, or @ embed^T for a tied head."""
    h = L.norm(h, params["final_norm"]["w"], cfg.norm, cfg.norm_eps)
    if "lm_head" in params:
        return torch.matmul(h, params["lm_head"]["w"])
    return torch.matmul(h, params["embed"]["w"].t())


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Masked mean token NLL, in f32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def forward_train(cfg, params, batch: dict, *, remat: bool = True):
    """One training forward: (loss, {"ce", "aux"}).  loss = ce + the MoE
    aux weight x the layers' summed aux loss / num_layers; a VLM's targets
    cover the text tail only, so the vision prefix is padded out of the
    loss; an audio batch's ``target_mask`` picks the masked frames."""
    h, positions = embed_inputs(cfg, params, batch)
    h, aux = backbone(cfg, params, h, positions, None, "train", remat=remat)
    logits = lm_logits(cfg, params, h)
    targets = batch["targets"]
    mask = batch.get("target_mask")
    mask = (torch.ones(targets.shape, device=targets.device)
            if mask is None else mask.float())
    if cfg.family == "vlm":
        pad = logits.shape[1] - targets.shape[1]
        targets = F.pad(targets, (pad, 0))
        mask = F.pad(mask, (pad, 0))
    ce = cross_entropy(logits, targets, mask)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    aux_w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
    loss = ce + aux_w * aux / max(cfg.num_layers, 1)
    return loss, {"ce": ce.detach(), "aux": aux.detach()}


def prefill(cfg, params, batch: dict, cache: dict):
    """Process the prompt, fill the cache, return last-position logits.
    Without ``prompt_lens``, every row is a whole prompt; with it, the SSM
    state stops at each row's prompt end."""
    _check_decoder(cfg)
    h, positions = embed_inputs(cfg, params, batch)
    prompt_lens = batch.get("prompt_lens")
    h, _ = backbone(cfg, params, h, positions, cache, "prefill",
                    lens=prompt_lens)
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
    if "k" in cache:
        p_len = min(p_len, cache["k"].shape[2])
    tmp = init_cache(cfg, n, p_len, cache["pos"].device)
    logits, tmp = prefill(cfg, params, batch, tmp)

    take = torch.clamp(src.long(), min=0)             # [slots] row gather
    keep = src < 0                                     # [slots] untouched

    def merge(old, new):
        # old: [L, slots, ...], new: [L, n, ...]: gather by slot, select
        mask = keep.reshape((1, -1) + (1,) * (old.dim() - 2))
        old.copy_(torch.where(mask, old, new.index_select(1, take)))

    for key in ("k", "v"):
        if key in cache:
            merge(cache[key][:, :, :p_len], tmp[key])
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
    tmp = init_cache(cfg, n, p_len, dev)
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
    b, t = tokens.shape
    pos = cache["pos"]
    h, positions = embed_inputs(cfg, params, {
        "tokens": tokens, "positions": _window_positions(cfg, pos, t)})
    h, _ = backbone(cfg, params, h, positions, cache, "decode",
                    write_lens=chunk_lens)
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
                ssm_steps: S.SSMState | None = None):
    """tokens [b, t] -> (logits [b, t, V], cache).  `ssm_steps`
    (`ssm_step_buffers(cache, t)`) takes the SSM state after each of the t
    tokens; ``cache["ssm"]`` is then its last token's."""
    _check_decoder(cfg)
    b, t = tokens.shape
    pos = cache["pos"]
    h, positions = embed_inputs(cfg, params, {
        "tokens": tokens, "positions": _window_positions(cfg, pos, t)})
    # the new SSM state goes to fresh tensors, as `pos` is replaced: the
    # state this step read stays as it was
    new = ssm_steps
    if new is None and "ssm" in cache:
        new = S.SSMState(*map(torch.empty_like, cache["ssm"]))
    h, _ = backbone(cfg, params, h, positions, cache, "decode", ssm_out=new)
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
