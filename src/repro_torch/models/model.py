"""The dense decoder of the port — `repro.models.model`, dense family, over
a dense KV slab or a paged KV pool.

Parameters keep the reference's pytree: nested dicts whose per-layer
leaves are stacked on a leading ``num_layers`` axis (the weight bridge
`models.weights.params_from_jax` is then a straight copy).  The backbone is
a Python loop over layers where the reference runs `lax.scan`.

The KV cache is updated IN PLACE (the reference is functional and returns
new arrays): `_write_kv` / `_write_kv_masked` / `_write_kv_paged`,
`prefill_to_slots` and `prefill_to_pages` write into the cache tensors
they are given, and every entry point returns the same cache dict with its
``pos`` replaced.  A cache holding ``block_tables`` is paged: its K/V are
page pools ``[L, num_pages, page_size, nkv, hd]`` and the decode path
resolves each logical position through the slot's block table.

Entry points:
  init_params(cfg, generator)            -> params
  init_cache(cfg, batch, capacity, device)
  init_paged_cache(cfg, max_slots, num_pages, page_size, max_blocks, device)
  prefill(cfg, params, batch, cache)     -> (last_logits, cache)
  prefill_to_slots(cfg, params, batch, cache, src) -> (first_tokens, cache)
  prefill_to_pages(cfg, params, batch, cache, src) -> (first_tokens, cache)
  chunk_logits / prefill_chunk(cfg, params, cache, tokens, chunk_lens)
  decode_step(cfg, params, cache, tokens) -> (logits, cache)
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: tuple[int, ...]
    init: str = "normal"      # normal | zeros | ones
    std: float = 0.02


def _check_dense(cfg: ModelConfig) -> None:
    if (cfg.family != "dense" or cfg.mlp != "swiglu" or cfg.norm != "rmsnorm"
            or not cfg.tie_embeddings):
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense swiglu/rmsnorm models with "
            "tied embeddings only")


def model_spec(cfg: ModelConfig) -> dict:
    _check_dense(cfg)
    d, v, f = cfg.d_model, cfg.vocab_size, cfg.d_ff
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    nl = cfg.num_layers
    residual_std = (d ** -0.5) / math.sqrt(max(2 * nl, 1))
    std = d ** -0.5
    attn = {
        "w_q": PSpec((nl, d, nh, hd), std=std),
        "w_k": PSpec((nl, d, nkv, hd), std=std),
        "w_v": PSpec((nl, d, nkv, hd), std=std),
        "w_o": PSpec((nl, nh, hd, d), std=residual_std),
    }
    if cfg.qkv_bias:
        attn["b_q"] = PSpec((nl, nh, hd), "zeros")
        attn["b_k"] = PSpec((nl, nkv, hd), "zeros")
        attn["b_v"] = PSpec((nl, nkv, hd), "zeros")
    spec = {
        "embed": {"w": PSpec((v, d), std=0.02)},
        "final_norm": {"w": PSpec((d,), "ones")},
        "layers": {
            "norm1": PSpec((nl, d), "ones"),
            "attn": attn,
            "norm2": PSpec((nl, d), "ones"),
            "mlp": {
                "w_gate": PSpec((nl, d, f), std=std),
                "w_up": PSpec((nl, d, f), std=std),
                "w_down": PSpec((nl, f, d), std=residual_std),
            },
        },
    }
    return spec


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random parameters on the generator's device: truncated normals
    (+-3 sigma) scaled by each leaf's std, ones for norms, zeros for
    biases — the reference's init law, not its random numbers."""
    dtype = DTYPES[cfg.dtype]
    device = generator.device

    def make(ps: PSpec) -> torch.Tensor:
        if ps.init == "zeros":
            return torch.zeros(ps.shape, dtype=dtype, device=device)
        if ps.init == "ones":
            return torch.ones(ps.shape, dtype=dtype, device=device)
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
    """Decode cache: per-slot positions and dense [L, b, S, nkv, hd] K/V."""
    _check_dense(cfg)
    dtype = DTYPES[cfg.dtype]
    shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_cache(cfg: ModelConfig, max_slots: int, num_pages: int,
                     page_size: int, max_blocks: int | None,
                     device: torch.device | str) -> dict:
    """Paged decode cache: K/V in a pool of fixed-size pages (one page = one
    Attn-PIM bank row) and a per-slot block table mapping logical blocks to
    physical pages.  Page 0 is the garbage page: the tables start at 0, so
    writes of slots not yet admitted land there harmlessly."""
    _check_dense(cfg)
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


def layer_params(params: dict, i: int) -> dict:
    """Layer i's slice of the stacked per-layer parameters (views)."""
    def take(tree):
        return {k: (take(v) if isinstance(v, dict) else v[i])
                for k, v in tree.items()}
    return take(params["layers"])


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
    a_in = L.rmsnorm(h, p["norm1"], cfg.norm_eps)
    q, k, v = L.qkv_project(a_in, p["attn"])
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
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


def mlp_block(cfg: ModelConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    m_in = L.rmsnorm(h, p["norm2"], cfg.norm_eps)
    return h + L.swiglu_mlp(m_in, p["mlp"])


def _transformer_backbone(cfg, params, h, positions, cache, mode,
                          write_lens=None):
    """Loop over the stacked layers; each layer writes its own KV slab (or
    its own page pool, when the cache carries block tables)."""
    pos = cache["pos"] if cache is not None else None
    tables = cache.get("block_tables") if cache is not None else None
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        kv = (cache["k"][i], cache["v"][i]) if cache is not None else None
        h = attention_block(cfg, lp, h, positions, kv, pos, mode,
                            tables=tables, write_lens=write_lens)
        h = mlp_block(cfg, lp, h)
    return h


# ---------------------------------------------------------------------------
# Heads / embedding
# ---------------------------------------------------------------------------

def embed_tokens(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["w"][tokens.long()]


def embed_inputs(cfg, params, batch: dict):
    """Token embedding.  Returns (h [b, s, d], positions)."""
    tokens = batch["tokens"]
    h = embed_tokens(cfg, params, tokens)
    if "positions" in batch:
        return h, batch["positions"]
    return h, torch.arange(tokens.shape[1], device=tokens.device)[None, :]


def lm_logits(cfg, params, h: torch.Tensor) -> torch.Tensor:
    """Tied head: logits = rmsnorm(h) @ embed^T."""
    h = L.rmsnorm(h, params["final_norm"]["w"], cfg.norm_eps)
    return torch.matmul(h, params["embed"]["w"].t())


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def prefill(cfg, params, batch: dict, cache: dict):
    """Process the prompt, fill the cache, return last-position logits."""
    h, positions = embed_inputs(cfg, params, batch)
    h = _transformer_backbone(cfg, params, h, positions, cache, "prefill")
    prompt_lens = batch["prompt_lens"]
    cache["pos"] = prompt_lens.to(torch.int32)
    idx = torch.clamp(prompt_lens.long() - 1, 0, h.shape[1] - 1)
    h_last = h[torch.arange(h.shape[0], device=h.device), idx][:, None]
    return lm_logits(cfg, params, h_last)[:, 0], cache


def prefill_to_slots(cfg, params, batch: dict, cache: dict,
                     src: torch.Tensor):
    """Batched admission: prefill a fixed-shape batch of new requests and
    merge each into its slot of the engine cache.  src[s] is the batch row
    admitted into slot s, or -1 to leave slot s untouched.  The temporary
    cache is sized to the prefill window, and only its first p_len
    positions are merged, so padded prompt rows never reach a live slot.
    Returns (first_tokens [slots] int32, cache); -1 for untouched slots."""
    n, p_len = batch["tokens"].shape
    p_len = min(p_len, cache["k"].shape[2])
    tmp = init_cache(cfg, n, p_len, cache["k"].device)
    logits, tmp = prefill(cfg, params, batch, tmp)

    take = torch.clamp(src.long(), min=0)             # [slots] row gather
    keep = src < 0                                     # [slots] untouched
    for key in ("k", "v"):
        head = cache[key][:, :, :p_len]
        gathered = tmp[key].index_select(1, take)
        mask = keep.reshape(1, -1, 1, 1, 1)
        head.copy_(torch.where(mask, head, gathered))
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
    b, t = tokens.shape
    pos = cache["pos"]
    positions = pos[:, None] + torch.arange(t, device=pos.device)[None, :]
    h, positions = embed_inputs(cfg, params, {"tokens": tokens,
                                              "positions": positions})
    h = _transformer_backbone(cfg, params, h, positions, cache, "decode",
                              write_lens=chunk_lens)
    idx = torch.clamp(chunk_lens.long() - 1, 0, t - 1)
    h_last = h[torch.arange(b, device=h.device), idx][:, None]
    logits = lm_logits(cfg, params, h_last)
    cache["pos"] = pos + chunk_lens.to(torch.int32)
    return logits[:, 0], cache


def prefill_chunk(cfg, params, cache, tokens, chunk_lens):
    """`chunk_logits` followed by the greedy argmax."""
    logits, cache = chunk_logits(cfg, params, cache, tokens, chunk_lens)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def decode_step(cfg, params, cache: dict, tokens: torch.Tensor):
    """tokens [b, t] -> (logits [b, t, V], cache)."""
    b, t = tokens.shape
    pos = cache["pos"]
    positions = pos[:, None] + torch.arange(t, device=pos.device)[None, :]
    h, positions = embed_inputs(cfg, params, {"tokens": tokens,
                                              "positions": positions})
    h = _transformer_backbone(cfg, params, h, positions, cache, "decode")
    logits = lm_logits(cfg, params, h)
    cache["pos"] = pos + t
    return logits, cache
