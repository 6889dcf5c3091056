"""Attn-PIM over bank-row pages: GQA flash-decode attention over a paged
KV pool — the port of `repro.kernels.paged_decode_attention`.

Layouts follow the reference: q ``[b, nkv, t*g, hd]`` (rows
(window, group)-row-major), K/V pages ``[num_pages, page_size, nkv, hd]``,
lens ``[b]`` int32 counting ALL t window tokens, tables ``[b, max_blocks]``
int32 mapping logical block ``j // page_size`` of request i to its physical
page.  The masking is the dense kernel's (`kernels.decode_attention`).

`paged_decode_attention` launches the hand-written CUDA kernel
(``csrc/paged_decode_attention.cu``, which shares its split-S body with the
dense kernel through ``csrc/decode_attention.cuh``) for tensors on the card
and uses the plain PyTorch version `paged_decode_attention_ref` for tensors
on the CPU.  The row tile and the split count come from the dense module's
`row_tile` and `num_splits`, on the shapes alone, so the paged and the
dense kernel split at the same tiles and agree bit for bit.  Table entries past a request's
length may name any page (the engine points them at the garbage page 0):
the kernel never reads them and the plain version masks them.  `LAUNCHES`
counts calls that ran the kernel, one per call; a call with more than one
split issues two CUDA launches (the split pass and the merge).
`LAUNCHES_BY_ROWS` counts the same calls by their window t (``q_rows``).
`paged_decode_attention_sharded` splits the pools by KV head, one Attn-PIM
unit per shard, as the dense module's `decode_attention_sharded` does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (DTYPES, HEAD_DIMS,
                                                  check_splits,
                                                  decode_attention_ref,
                                                  num_splits, row_tile,
                                                  shard_heads,
                                                  sharded_splits, sm_count,
                                                  split_scratch)

LAUNCHES = 0
LAUNCHES_BY_ROWS: dict[int, int] = {}
_fn = None


def gather_kv_pages(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """[num_pages, page, nkv, hd] gathered by [b, max_blocks] tables ->
    the contiguous per-request view [b, max_blocks * page, nkv, hd]."""
    b, nblk = tables.shape
    _, page, nkv, hd = pages.shape
    return pages[tables.long()].reshape(b, nblk * page, nkv, hd)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, lens: torch.Tensor,
                               tables: torch.Tensor,
                               q_rows: int = 1) -> torch.Tensor:
    """Plain version: gather the pages by `tables`, then the dense plain
    version over the gathered view."""
    return decode_attention_ref(q, gather_kv_pages(k_pages, tables),
                                gather_kv_pages(v_pages, tables), lens, q_rows)


def _launch_fn():
    global _fn
    if _fn is None:
        fn = _build.load("paged_decode_attention").paged_decode_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, lens: torch.Tensor,
                           tables: torch.Tensor, *,
                           q_rows: int = 1,
                           splits: int | None = None) -> torch.Tensor:
    """[b, nkv, t*g, hd] queries against the first `lens` logical positions
    of each request's pages -> [b, nkv, t*g, hd] in q's dtype, through
    Attn-PIM.  The table entries a request's length reaches must name pages
    of the pool: checking them on the card would cost a device->host copy,
    so the kernel trusts them (the engine's allocator only hands out pool
    pages).  `splits` fixes the KV split count (default `num_splits`)."""
    global LAUNCHES
    _build.refuse_autograd("paged_decode_attention", q, k_pages, v_pages)
    b, nkv, tg, hd = q.shape
    if (k_pages.dim() != 4 or k_pages.shape != v_pages.shape
            or k_pages.shape[2] != nkv or k_pages.shape[3] != hd):
        raise ValueError(f"q {tuple(q.shape)} does not match K/V pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if q_rows < 1 or tg % q_rows:
        raise ValueError(f"{tg} query rows are not a multiple of q_rows "
                         f"{q_rows}")
    if lens.shape != (b,):
        raise ValueError(f"lens must be [{b}], got {tuple(lens.shape)}")
    if tables.dim() != 2 or tables.shape[0] != b or tables.shape[1] < 1:
        raise ValueError(f"tables must be [{b}, max_blocks], got "
                         f"{tuple(tables.shape)}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype and q.dtype in DTYPES):
        raise TypeError(f"paged_decode_attention takes float32 or bfloat16, "
                        f"got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if not (q.device == k_pages.device == v_pages.device == lens.device
            == tables.device):
        raise ValueError("q, K/V pages, lens and tables must share one device")
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, lens, tables,
                                          q_rows)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if lens.dtype != torch.int32 or tables.dtype != torch.int32:
        raise TypeError(f"lens and tables must be int32, got {lens.dtype} "
                        f"and {tables.dtype}")
    if not all(t.is_contiguous() for t in (q, k_pages, v_pages, lens, tables)):
        raise ValueError("paged_decode_attention needs contiguous inputs")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("K/V pages must be 16-byte aligned (vector loads)")
    check_splits(splits)
    ns = splits or num_splits(b, nkv, tg, sm_count(q.device))
    part = split_scratch(q, ns)
    out = torch.empty_like(q)
    err = _launch_fn()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                       lens.data_ptr(), tables.data_ptr(), out.data_ptr(),
                       None if part is None else part.data_ptr(), b, nkv, tg,
                       hd, k_pages.shape[1], tables.shape[1], q_rows,
                       row_tile(tg, q.dtype), ns, DTYPES[q.dtype],
                       torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode_attention")
    LAUNCHES += 1
    LAUNCHES_BY_ROWS[q_rows] = LAUNCHES_BY_ROWS.get(q_rows, 0) + 1
    return out


def paged_decode_attention_sharded(q: torch.Tensor, k_pages: torch.Tensor,
                                   v_pages: torch.Tensor, lens: torch.Tensor,
                                   tables: torch.Tensor, *, mesh, heads: int,
                                   axis: str = "model",
                                   q_rows: int = 1) -> torch.Tensor:
    """One Attn-PIM unit per KV-head shard over pages — the reference's
    `paged_decode_attention_sharded` for one process per rank: q [b, n,
    t*g, hd] and the pools [P, page, n, hd] are this rank's blocks of
    `heads` KV heads split over `axis` (n = heads / size, or all of them
    where that does not divide), lens and tables are whole on every rank.
    No cross-rank term; the unsharded call's split count keeps the block
    bit-equal to the unsharded kernel's rows."""
    n = shard_heads(heads, mesh, axis)
    if q.shape[1] != n or k_pages.dim() != 4 or k_pages.shape[2] != n:
        raise ValueError(f"this rank holds {n} of {heads} KV heads; got q "
                         f"{tuple(q.shape)} and pages "
                         f"{tuple(k_pages.shape)}")
    return paged_decode_attention(q, k_pages, v_pages, lens, tables,
                                  q_rows=q_rows,
                                  splits=sharded_splits(q, heads))
