"""Transformer building blocks: norms, RoPE and qwen2-vl's M-RoPE, the
SwiGLU and GELU MLPs, projections and attention — ports of
`repro.models.layers`.

Numerics follow the reference rounding point for rounding point, because
in bf16 they decide whether greedy tokens match: statistics and softmax in
f32, `rmsnorm` casts its rsqrt back to the activation dtype before the
multiplies, `layernorm` normalizes in f32 and casts before the scale,
`swiglu` runs silu in f32 and casts back (`gelu_mlp` its tanh GELU), RoPE and M-RoPE rotate split
halves in f32.  Attention comes as
  * `flash_attention` / `dense_attention` — prefill and training, causal
    or (the audio encoder) bidirectional (plain PyTorch, the reference's
    XLA code; never `scaled_dot_product_attention`);
  * `decode_attention_xla` — the plain decode path (oracle), over a dense
    slab or, for the paged layout, over `gather_kv_pages`' view;
  * `decode_attention_pim` / `decode_attention_pim_paged` — decode through
    the Attn-PIM kernel over a dense slab / over bank-row pages.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_sharded)
# gather_kv_pages: the paged layout's plain oracle path (the reference's
# `layers.gather_kv_pages`), lives beside the paged kernel's plain version
from repro_torch.kernels.paged_decode_attention import (  # noqa: F401
    gather_kv_pages, paged_decode_attention, paged_decode_attention_sharded)
from repro_torch.models.linear import papi_linear, papi_linear_group

_attn_state = threading.local()


def current_attn_impl() -> str:
    """Decode-attention implementation: "xla" (plain softmax path, the
    reference's name) or "pim" (the Attn-PIM flash-decode kernel)."""
    return getattr(_attn_state, "impl", "xla")


@contextlib.contextmanager
def attn_impl(impl: str):
    if impl not in ("xla", "pim"):
        raise ValueError(f"attention impl must be 'xla' or 'pim', not "
                         f"{impl!r}")
    prev = current_attn_impl()
    _attn_state.impl = impl
    try:
        yield
    finally:
        _attn_state.impl = prev


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * weight.to(x.dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Scale-only LayerNorm (no bias, as the reference's parameters)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(
        x.dtype)


def norm(x: torch.Tensor, weight: torch.Tensor, kind: str,
         eps: float) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, weight, eps)
    return layernorm(x, weight, eps)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2] (f32)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / torch.pow(theta, exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [b, seq, heads, hd]; positions broadcastable to [b, seq]."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * inv            # [b, seq, hd/2]
    angles = angles[..., None, :]                          # over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_m_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                 sections: tuple[int, ...]) -> torch.Tensor:
    """qwen2-vl's multimodal RoPE.  x: [b, seq, heads, hd]; positions:
    [b, 3, seq] (temporal, height, width).  The hd/2 frequency slots are
    split into `sections`, section i rotated by position stream i; as the
    reference's ``jnp.repeat(..., total_repeat_length=hd // 2)``, sections
    past hd/2 slots are cut and the last one fills what they leave (the
    smoke twin's (8, 12, 12) at hd 32 rotates 8 slots by t, 8 by h).  A
    [b, seq] position array is refused: it has no height and width rows."""
    hd = x.shape[-1]
    if positions.dim() != 3 or positions.shape[1] != len(sections):
        raise ValueError(
            f"M-RoPE takes positions [b, {len(sections)}, seq] for sections "
            f"{tuple(sections)}, got {tuple(positions.shape)}")
    inv = rope_freqs(hd, theta, x.device)
    half = hd // 2
    parts, lo = [], 0
    for i, n in enumerate(sections):
        hi = half if i == len(sections) - 1 else min(lo + n, half)
        if hi > lo:
            parts.append(positions[:, i, :, None].float() * inv[lo:hi])
        lo = hi
    angles = torch.cat(parts, dim=-1)[..., None, :]     # [b, seq, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu_mlp(x: torch.Tensor, p: dict,
               units: int | None = None) -> torch.Tensor:
    """down( silu(gate(x)) * up(x) ); gate and up in one FC group (column
    banks over "ffn"), down a row bank; `units` is the global FFN width,
    which a mesh needs to tell whether the banks are split."""
    gate, up = papi_linear_group(x, [p["w_gate"], p["w_up"]], tp="col",
                                 units=units)
    act = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    return papi_linear(act, p["w_down"], tp="row", units=units,
                       out_dim=x.shape[-1])


def gelu_mlp(x: torch.Tensor, p: dict,
             units: int | None = None) -> torch.Tensor:
    """GPT-style 2-layer MLP with biases; tanh GELU in f32, cast back
    (``jax.nn.gelu(approximate=True)``).  The banks as `swiglu_mlp`'s."""
    h = papi_linear(x, p["w_in"], tp="col", units=units) + p["b_in"]
    h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(x.dtype)
    return papi_linear(h, p["w_out"], tp="row", units=units,
                       out_dim=x.shape[-1]) + p["b_out"]


def qkv_project(x: torch.Tensor, p: dict, heads: int | None = None,
                kv_heads: int | None = None):
    """[b, s, d] -> q [b, s, nH, hd], k/v [b, s, nKV, hd], projected in
    one FC group of column banks (over "heads" for the q weight of a GQA
    model, "kv_heads" otherwise, as the reference).  Under a mesh the
    weights are the rank's blocks, so the heads are the rank's; `heads` /
    `kv_heads` are the global counts.  A column bank needs no collective,
    so the bank name decides nothing here: q is banked by its stored
    "heads" block, also on an MHA model such as olmoe-1b-7b, where the
    reference's "kv_heads" bank would run its FC-PIM q projection
    unsharded on a sharded weight.  A 2D weight-stationary rank holds a
    block of d (the weights' first dim), which `papi_linear_group`
    contracts in place."""
    b, s, _ = x.shape
    ws = [p["w_q"], p["w_k"], p["w_v"]]
    bank = "kv_heads" if heads == kv_heads else "heads"
    ys = papi_linear_group(x, [w.reshape(w.shape[0], -1) for w in ws],
                           tp="col", bank=bank, units=heads)
    q, k, v = (y.reshape(b, s, *w.shape[1:]) for y, w in zip(ys, ws))
    if "b_q" in p:
        q = q + p["b_q"]
        k = k + p["b_k"]
        v = v + p["b_v"]
    return q, k, v


def out_project(attn: torch.Tensor, p: dict, heads: int | None = None,
                d: int | None = None) -> torch.Tensor:
    """[b, s, nH, hd] -> [b, s, d]: a row bank over "heads" (`heads`
    global), whose partial products a mesh sums over the tensor group;
    `d` is the global model width (a 2D weight-stationary rank holds a
    block of it)."""
    b, s, nh, hd = attn.shape
    w = p["w_o"]
    return papi_linear(attn.reshape(b, s, nh * hd), w.reshape(nh * hd, -1),
                       tp="row", bank="heads", units=heads, out_dim=d)


def expand_kv_heads(k: torch.Tensor, nh: int) -> torch.Tensor:
    """[b, s, nKV, hd] -> [b, s, nH, hd] (head = kv * group + g)."""
    nkv = k.shape[2]
    if nkv == nh:
        return k
    return k.repeat_interleave(nh // nkv, dim=2)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """Attention that materializes [b, h, sq, sk] scores."""
    nh = q.shape[2]
    k, v = expand_kv_heads(k, nh), expand_kv_heads(v, nh)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhk,bshk->bhqs", q, k).float() * scale
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshk->bqhk", probs, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_block: int = 512,
                    kv_block: int = 512) -> torch.Tensor:
    """Blockwise online-softmax attention: peak score memory is
    [b, q_block, heads, kv_block].  Ragged shapes take `dense_attention`,
    as in the reference."""
    b, sq, nh, hd = q.shape
    sk = k.shape[1]
    if sq % q_block or sk % kv_block:
        return dense_attention(q, k, v, causal=causal)
    k, v = expand_kv_heads(k, nh), expand_kv_heads(v, nh)
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    for q0 in range(0, sq, q_block):
        qblk = q[:, q0:q0 + q_block]
        acc = torch.zeros((b, q_block, nh, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, q_block, nh), float("-inf"), device=q.device)
        l = torch.zeros((b, q_block, nh), device=q.device)
        q_pos = torch.arange(q0, q0 + q_block, device=q.device)
        for k0 in range(0, sk, kv_block):
            kblk, vblk = k[:, k0:k0 + kv_block], v[:, k0:k0 + kv_block]
            s = torch.einsum("bqhk,bshk->bqhs", qblk, kblk).float() * scale
            if causal:
                k_pos = torch.arange(k0, k0 + kv_block, device=q.device)
                mask = q_pos[:, None] >= k_pos[None, :]
                s = s.masked_fill(~mask[None, :, None, :], float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            # fully-masked rows (m_new = -inf) contribute nothing
            dead = torch.isinf(m_new)
            m_safe = torch.where(dead, torch.zeros_like(m_new), m_new)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(dead[..., None], torch.zeros_like(p), p)
            alpha = torch.where(torch.isinf(m), torch.zeros_like(m),
                                torch.exp(m - m_safe))
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bqhs,bshk->bqhk", p.to(v.dtype), vblk)
            acc = acc * alpha[..., None] + pv.float()
            m = m_new
        out[:, q0:q0 + q_block] = (
            acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)
    return out


def decode_attention_xla(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: torch.Tensor,
                         q_offset: torch.Tensor) -> torch.Tensor:
    """Decode attention against a padded KV cache — the plain path.
    q [b, t, nH, hd]; positions >= cache_len are masked, and within the t
    query tokens the mask is causal from q_offset (both [b])."""
    b, t, nh, hd = q.shape
    skv, nkv = k_cache.shape[1], k_cache.shape[2]
    group = nh // nkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, t, nkv, group, hd)
    s = torch.einsum("bthgk,bshk->bthgs", qg, k_cache).float() * scale
    kv_pos = torch.arange(skv, device=q.device)
    q_pos = q_offset[:, None] + torch.arange(t, device=q.device)[None, :]
    valid = ((kv_pos[None, None, :] <= q_pos[..., None])
             & (kv_pos[None, None, :] < cache_len[:, None, None]))
    s = s.masked_fill(~valid[:, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bthgs,bshk->bthgk", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, t, nh, hd)


def fold_query_window(q: torch.Tensor, nkv: int) -> torch.Tensor:
    """[b, t, nH, hd] -> the kernel's [b, nkv, t*g, hd] row layout, rows
    (window, group)-row-major within each KV head."""
    b, t, nh, hd = q.shape
    g = nh // nkv
    qh = q.reshape(b, t, nkv, g, hd).permute(0, 2, 1, 3, 4)
    return qh.reshape(b, nkv, t * g, hd)


def unfold_query_window(out: torch.Tensor, t: int, nh: int) -> torch.Tensor:
    """Inverse of `fold_query_window`: [b, nkv, t*g, hd] -> [b, t, nH, hd]."""
    b, nkv, tg, hd = out.shape
    o = out.reshape(b, nkv, t, tg // t, hd).permute(0, 2, 1, 3, 4)
    return o.reshape(b, t, nh, hd)


def decode_attention_pim(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lens: torch.Tensor,
                         shard: tuple | None = None) -> torch.Tensor:
    """Decode attention through the Attn-PIM kernel for any window t >= 1;
    the t rows sit at absolute positions lens - t .. lens - 1.  `shard`
    (mesh, global KV heads, axis): q and K/V are the rank's KV-head shard,
    run as one unit of `decode_attention_sharded`."""
    b, t, nh, hd = q.shape
    nkv = k_cache.shape[2]
    qh = fold_query_window(q, nkv).contiguous()
    lens = lens.to(torch.int32).contiguous()
    if shard is None:
        out = decode_attention(qh, k_cache, v_cache, lens, q_rows=t)
    else:
        mesh, heads, axis = shard
        out = decode_attention_sharded(qh, k_cache, v_cache, lens,
                                       mesh=mesh, heads=heads, axis=axis,
                                       q_rows=t)
    return unfold_query_window(out, t, nh)


def decode_attention_pim_paged(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, tables: torch.Tensor,
                               lens: torch.Tensor,
                               shard: tuple | None = None) -> torch.Tensor:
    """Paged decode attention through the block-table Attn-PIM kernel for
    any window t >= 1 (rows at absolute positions lens - t .. lens - 1); no
    contiguous view of the pages is built.  `shard` as in
    `decode_attention_pim`."""
    b, t, nh, hd = q.shape
    nkv = k_pages.shape[2]
    qh = fold_query_window(q, nkv).contiguous()
    lens = lens.to(torch.int32).contiguous()
    tables = tables.to(torch.int32).contiguous()
    if shard is None:
        out = paged_decode_attention(qh, k_pages, v_pages, lens, tables,
                                     q_rows=t)
    else:
        mesh, heads, axis = shard
        out = paged_decode_attention_sharded(qh, k_pages, v_pages, lens,
                                             tables, mesh=mesh, heads=heads,
                                             axis=axis, q_rows=t)
    return unfold_query_window(out, t, nh)
