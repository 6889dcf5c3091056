"""Attn-PIM: GQA flash-decode attention over a dense KV slab — the port of
`repro.kernels.decode_attention.decode_attention`.

Layouts follow the reference: q ``[b, nkv, t*g, hd]`` with rows
(window, group)-row-major, K/V ``[b, S, nkv, hd]``, lens ``[b]`` int32
counting ALL t window tokens.  Window row r sits at absolute position
``lens - t + r`` and sees KV position j iff ``j < lens - (t - 1) + r``.

`decode_attention` launches the hand-written CUDA kernel
(``csrc/decode_attention.cu``) for tensors on the card and uses the plain
PyTorch version `decode_attention_ref` for tensors on the CPU.  Both return
zeros for a request with ``lens == 0`` (the reference's softmax oracle
would give NaN there; the engine never produces it — idle slots are parked
at pos = 1).  `LAUNCHES` counts kernel launches only.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
NEG_INF = -1e30

LAUNCHES = 0
_fn = None


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lens: torch.Tensor,
                         q_rows: int = 1) -> torch.Tensor:
    """Plain version: masked softmax attention, scores and normalizer in
    f32, probabilities rounded to the cache dtype before ``p @ v``."""
    b, nkv, tg, hd = q.shape
    g = tg // q_rows
    skv = k_cache.shape[1]
    s = torch.einsum("bhrd,bshd->bhrs", q.float(), k_cache.float())
    s = s * (1.0 / math.sqrt(hd))
    row = torch.arange(tg, device=q.device) // g                    # [t*g]
    limit = lens.to(torch.int64)[:, None] - (q_rows - 1) + row[None, :]
    valid = (torch.arange(skv, device=q.device)[None, None, :]
             < limit[:, :, None])                                    # [b,tg,S]
    s = torch.where(valid[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1) * valid[:, None].any(-1, keepdim=True)
    p = p.to(v_cache.dtype).float()
    out = torch.einsum("bhrs,bshd->bhrd", p, v_cache.float())
    return out.to(q.dtype)


def _launch_fn():
    global _fn
    if _fn is None:
        fn = _build.load("decode_attention").decode_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lens: torch.Tensor, *,
                     q_rows: int = 1) -> torch.Tensor:
    """[b, nkv, t*g, hd] queries against the first `lens` cache positions
    -> [b, nkv, t*g, hd] in q's dtype, through Attn-PIM."""
    global LAUNCHES
    b, nkv, tg, hd = q.shape
    if (k_cache.dim() != 4 or k_cache.shape != v_cache.shape
            or k_cache.shape[0] != b or k_cache.shape[2] != nkv
            or k_cache.shape[3] != hd):
        raise ValueError(f"q {tuple(q.shape)} does not match K/V "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    if q_rows < 1 or tg % q_rows:
        raise ValueError(f"{tg} query rows are not a multiple of q_rows "
                         f"{q_rows}")
    if lens.shape != (b,):
        raise ValueError(f"lens must be [{b}], got {tuple(lens.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype and q.dtype in DTYPES):
        raise TypeError(f"decode_attention takes float32 or bfloat16, got "
                        f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if not (q.device == k_cache.device == v_cache.device == lens.device):
        raise ValueError("q, K/V and lens must share one device")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lens, q_rows)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if lens.dtype != torch.int32:
        raise TypeError(f"lens must be int32, got {lens.dtype}")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, lens)):
        raise ValueError("decode_attention needs contiguous inputs")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("K/V must be 16-byte aligned (vector loads)")
    out = torch.empty_like(q)
    err = _launch_fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                       lens.data_ptr(), out.data_ptr(), b, nkv, tg, hd,
                       k_cache.shape[1], q_rows, DTYPES[q.dtype],
                       torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    LAUNCHES += 1
    return out
