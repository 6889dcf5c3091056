"""Attn-PIM: GQA flash-decode attention over a dense KV slab — the port of
`repro.kernels.decode_attention.decode_attention`.

Layouts follow the reference: q ``[b, nkv, t*g, hd]`` with rows
(window, group)-row-major, K/V ``[b, S, nkv, hd]``, lens ``[b]`` int32
counting ALL t window tokens.  Window row r sits at absolute position
``lens - t + r`` and sees KV position j iff ``j < lens - (t - 1) + r``.

`decode_attention` launches the hand-written CUDA kernel
(``csrc/decode_attention.cu``, body in ``csrc/decode_attention.cuh``) for
tensors on the card and uses the plain PyTorch version
`decode_attention_ref` for tensors on the CPU.  Both return zeros for a
request with ``lens == 0`` (the reference's softmax oracle would give NaN
there; the engine never produces it — idle slots are parked at pos = 1).

The kernel is split-S (flash-decoding): each (request, KV head, row tile)
is cut into `num_splits` contiguous ranges of KV tiles, one block each,
whose f32 partials a second kernel merges in split order.  bf16 runs on
tensor cores in 16-row tiles, f32 on CUDA cores in row tiles fitted to the
rows (`row_tile`).  `num_splits` picks the split count from the shapes and
the card's SM count alone — never from ``lens`` (that would cost a
device->host copy) nor from the KV capacity nor the dtype (so the dense and
the paged kernel split alike and stay bit-equal).  `LAUNCHES` counts calls
that ran the kernel, one per call: a call with more than one split issues
two CUDA launches (the split pass and the merge), one with a single split
issues one (`cuda_launches`).  `LAUNCHES_BY_ROWS` counts the same calls by
their window t (``q_rows``): 1 for a decode step, the speculation length
for a verify window, the prefill window for a chunk wave.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
NEG_INF = -1e30
# the split planner's constants (tuned on an H100 SXM, PERF.md): query rows
# per f32 block, the least splits (so a chunk wave, already hundreds of
# blocks, still cuts a long request's chain), the most, the block waves
# aimed at (SPLITS_MAX is at most the kernel's 32: one merge lane each),
# and the f32 partials a call may take, sized for the widest head
ROW_TILES = (4, 8, 16)
SPLITS_MIN = 4
SPLITS_MAX = 32
WAVES = 2
SCRATCH_CAP = 64 * 2 ** 20

LAUNCHES = 0
LAUNCHES_BY_ROWS: dict[int, int] = {}
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


def row_tile(rows: int, dtype: torch.dtype) -> int:
    """Query rows per block: 16 for bf16 (the tensor-core mma's M); for f32
    the smallest of `ROW_TILES` that holds `rows` (a t = 1 decode: g rows),
    else the largest (a chunk wave's t*g rows over several blocks)."""
    if dtype == torch.bfloat16:
        return ROW_TILES[-1]
    return next((t for t in ROW_TILES if rows <= t), ROW_TILES[-1])


def num_splits(b: int, nkv: int, rows: int, sms: int) -> int:
    """KV splits per (request, KV head, row tile): enough blocks for `WAVES`
    waves over `sms` SMs, at least `SPLITS_MIN`, at most `SPLITS_MAX`, and
    no more than `SCRATCH_CAP` bytes of partials at the widest head dim.
    Blocks are counted in 16-row tiles: a smaller f32 tile only occurs where
    one tile holds all the rows, so the count holds for either dtype."""
    blocks = b * nkv * -(-rows // ROW_TILES[-1])
    ns = max(SPLITS_MIN, -(-WAVES * sms // blocks))
    cap = SCRATCH_CAP // (b * nkv * rows * (max(HEAD_DIMS) + 2) * 4)
    return max(1, min(ns, SPLITS_MAX, cap))


def cuda_launches(ns: int) -> int:
    """CUDA launches of one call with `ns` splits (split pass + merge)."""
    return 1 if ns == 1 else 2


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device (cached: no device work)."""
    index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def split_scratch(q: torch.Tensor, ns: int) -> torch.Tensor | None:
    """The f32 partials of `ns` splits (acc, then m, then l), or None for
    one split; allocated per call through PyTorch's caching allocator."""
    if ns == 1:
        return None
    b, nkv, tg, hd = q.shape
    return torch.empty(b * nkv * ns * tg * (hd + 2), dtype=torch.float32,
                       device=q.device)


def _launch_fn():
    global _fn
    if _fn is None:
        fn = _build.load("decode_attention").decode_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_splits(splits: int | None) -> None:
    if splits is not None and not 1 <= splits <= SPLITS_MAX:
        raise ValueError(f"splits must lie in [1, {SPLITS_MAX}], got "
                         f"{splits}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lens: torch.Tensor, *,
                     q_rows: int = 1,
                     splits: int | None = None) -> torch.Tensor:
    """[b, nkv, t*g, hd] queries against the first `lens` cache positions
    -> [b, nkv, t*g, hd] in q's dtype, through Attn-PIM.  `splits` fixes
    the KV split count (default `num_splits` of these shapes)."""
    global LAUNCHES
    _build.refuse_autograd("decode_attention", q, k_cache, v_cache)
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
    check_splits(splits)
    ns = splits or num_splits(b, nkv, tg, sm_count(q.device))
    part = split_scratch(q, ns)
    out = torch.empty_like(q)
    err = _launch_fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                       lens.data_ptr(), out.data_ptr(),
                       None if part is None else part.data_ptr(), b, nkv, tg,
                       hd, k_cache.shape[1], q_rows, row_tile(tg, q.dtype),
                       ns, DTYPES[q.dtype],
                       torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    LAUNCHES += 1
    LAUNCHES_BY_ROWS[q_rows] = LAUNCHES_BY_ROWS.get(q_rows, 0) + 1
    return out


def shard_heads(heads: int, mesh, axis: str) -> int:
    """KV heads one rank holds when `heads` are split over `axis`: heads /
    size where that divides, else all of them (the unsharded fallback)."""
    size = dict(mesh.shape).get(axis, 1) if mesh is not None else 1
    return heads // size if size > 1 and heads % size == 0 else heads


def sharded_splits(q: torch.Tensor, heads: int) -> int | None:
    """The unsharded call's split count over all `heads` KV heads (None on
    the CPU, whose plain version does not split)."""
    if q.device.type != "cuda":
        return None
    b, _, tg, _ = q.shape
    return num_splits(b, heads, tg, sm_count(q.device))


def decode_attention_sharded(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, lens: torch.Tensor, *,
                             mesh, heads: int, axis: str = "model",
                             q_rows: int = 1) -> torch.Tensor:
    """One Attn-PIM unit per KV-head shard — the reference's
    `decode_attention_sharded` for one process per rank.  q [b, n, t*g,
    hd] and K/V [b, S, n, hd] are this rank's blocks of a problem over
    `heads` KV heads split over the mesh axis `axis` (n = heads / size);
    the kernel runs on them with no cross-rank term and returns this
    rank's block of the output.  Where `heads` does not divide the axis
    the blocks are the whole tensors and every rank runs the unsharded
    kernel.  The split count is the unsharded call's, so the block is bit
    for bit the unsharded kernel's rows for these heads."""
    n = shard_heads(heads, mesh, axis)
    if q.shape[1] != n or k_cache.dim() != 4 or k_cache.shape[2] != n:
        raise ValueError(f"this rank holds {n} of {heads} KV heads; got q "
                         f"{tuple(q.shape)} and K {tuple(k_cache.shape)}")
    return decode_attention(q, k_cache, v_cache, lens, q_rows=q_rows,
                            splits=sharded_splits(q, heads))
