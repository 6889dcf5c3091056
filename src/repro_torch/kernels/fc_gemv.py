"""FC-PIM: the weight-streaming skinny matmul ``y = x @ w`` (f32 sums,
output in x's dtype, or in f32 on request) — the port of `repro.kernels.fc_gemv.fc_gemv`
(``src/repro/kernels/fc_gemv.py:86``).

`fc_gemv_group(x, ws)` computes ``x @ w`` for up to `WEIGHTS_MAX` weights
that share x and K (q/k/v, gate/up) in ONE launch of the hand-written CUDA
kernel (``csrc/fc_gemv.cu``); `fc_gemv(x, w)` is a group of one.  Tensors
on the CPU take the plain PyTorch version `fc_gemv_ref`.  `LAUNCHES`
counts kernel launches, one per call, grouped or not (CPU calls and
`fc_gemv_ref` do not count), so a run can show the path went through it;
`LAUNCHES_BY_M` counts the same launches by their rows m (slots x window).

The kernel splits K over a thread-block cluster of `cluster` blocks of
`k_slice` rows each and adds the ranks' partial sums inside the cluster,
in rank order; each block owns `col_tile` output columns of one weight.
`plan` reads shapes only.  Its K split (`k_split`) depends on K alone, and
each block adds its rows in k order, so a column's sum, bit for bit, does
not depend on the group it was launched in, on the column tile or on m.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import sm_count

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WEIGHTS_MAX = 3          # weights one launch takes (FC_MAX_W in the source)
# the planner's constants (tuned on an H100 SXM, PERF.md): the portable
# cluster size, the K that r ranks need, K_UNIT * r**2 (so that ranks and
# their rows both grow as the square root of K), the column tiles a block
# may take (a warp per 16 columns), and the share of the SMs a launch's
# blocks should fill before its tiles narrow
CLUSTER_MAX = 8
K_UNIT = 56
COL_TILES = (128, 64, 32)
FILL = 0.875
# x rows per pass over the weights (FC_MT tiles of 8 in the source); the
# ring's depth and its bytes of w per stage, for `smem_bytes`
M_ROWS_MAX = 64
STAGES = 6
STAGE_BYTES = 8192
SMEM_MAX = 232448        # dynamic shared memory one block may take

LAUNCHES = 0
LAUNCHES_BY_M: dict[int, int] = {}
_fn = None


class FcPlan(NamedTuple):
    cluster: int         # blocks per cluster = K slices
    k_slice: int         # K rows per cluster rank (a multiple of 16)
    col_tile: int        # output columns per block


def fc_gemv_ref(x: torch.Tensor, w: torch.Tensor,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version: x [m, K] @ w [K, N] with f32 accumulation, in
    `out_dtype` (None: x's dtype)."""
    return torch.matmul(x.float(), w.float()).to(out_dtype or x.dtype)


def k_split(K: int) -> tuple[int, int]:
    """(cluster size, K rows per rank) from K alone: the largest power of
    two of ranks, at most `CLUSTER_MAX`, not above sqrt(K / `K_UNIT`) (4
    at the served models' K = 896 and 2048, 8 at 4864 and 8192); slices
    of a multiple of 16 rows (the mma's k), none empty."""
    ranks = max(1, math.isqrt(K // K_UNIT))
    cluster = min(CLUSTER_MAX, 1 << (ranks.bit_length() - 1))
    k_slice = -(-K // cluster)
    k_slice = -(-k_slice // 16) * 16
    return -(-K // k_slice), k_slice


def plan(K: int, ns: list[int], sms: int = 132) -> FcPlan:
    """The launch of x [m, K] against weights of `ns` columns: `k_split`'s
    cluster and slice, and the widest column tile whose blocks still fill
    `FILL` of the `sms` SMs (else the narrowest)."""
    cluster, k_slice = k_split(K)
    col = next((t for t in COL_TILES
                if cluster * sum(-(-n // t) for n in ns) >= FILL * sms),
               COL_TILES[-1])
    return FcPlan(cluster, k_slice, col)


def m_rows(m: int) -> int:
    """x rows per pass over the weights: m rounded up to 8, at most
    `M_ROWS_MAX` (past it each pass re-reads the weights, from L2)."""
    return min(M_ROWS_MAX, -(-m // 8) * 8)


def smem_bytes(col_tile: int, rows: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block (FcLayout::bytes in the source):
    the ring's stages of w and x rows, or the f32 partial tile laid over
    them, whichever is larger."""
    es = torch.empty((), dtype=dtype).element_size()
    epc = 16 // es
    bk = STAGE_BYTES // (col_tile * es)
    ring = STAGES * (bk * (col_tile + epc) + rows * (bk + epc)) * es
    return max(ring, rows * (col_tile + 4) * 4)


def _launch_fn():
    global _fn
    if _fn is None:
        fn = _build.load("fc_gemv").fc_gemv_launch
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fc_gemv_group(x: torch.Tensor, ws: list[torch.Tensor],
                  out_dtype: torch.dtype | None = None
                  ) -> list[torch.Tensor]:
    """[x @ w for w in ws]: x [m, K], each w [K, N_i] -> [m, N_i] in
    `out_dtype` (x's dtype, or float32: the f32 sums unrounded, for a
    partial product summed over ranks before its one rounding), through
    FC-PIM in one launch."""
    global LAUNCHES
    _build.refuse_autograd("fc_gemv", x, *ws)
    if not 1 <= len(ws) <= WEIGHTS_MAX:
        raise ValueError(f"fc_gemv_group takes 1 to {WEIGHTS_MAX} weights, "
                         f"got {len(ws)}")
    if x.dim() != 2 or any(w.dim() != 2 or w.shape[0] != x.shape[1]
                           for w in ws):
        raise ValueError(f"fc_gemv wants x[m,K] @ w[K,N] with one K, got "
                         f"{tuple(x.shape)} @ "
                         f"{[tuple(w.shape) for w in ws]}")
    if x.dtype not in DTYPES or any(w.dtype != x.dtype for w in ws):
        raise TypeError(f"fc_gemv takes float32 or bfloat16 of one dtype, "
                        f"got {x.dtype} and {[w.dtype for w in ws]}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"fc_gemv writes {x.dtype} or float32, not "
                        f"{out_dtype}")
    if any(w.device != x.device for w in ws):
        raise ValueError(f"x on {x.device}, weights on "
                         f"{[str(w.device) for w in ws]}")
    if x.device.type == "cpu":
        return [fc_gemv_ref(x, w, out_dtype) for w in ws]
    if x.device.type != "cuda":
        raise ValueError(f"fc_gemv runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and all(w.is_contiguous() for w in ws)):
        raise ValueError("fc_gemv needs contiguous x and weights")
    m, K = x.shape
    ns = [w.shape[1] for w in ws]
    p = plan(K, ns, sm_count(x.device))
    ys = [torch.empty((m, n), dtype=out_dtype, device=x.device) for n in ns]
    pad = WEIGHTS_MAX - len(ws)
    err = _launch_fn()(
        x.data_ptr(), m, K, len(ws),
        *[w.data_ptr() for w in ws], *[None] * pad,
        *[y.data_ptr() for y in ys], *[None] * pad,
        *ns, *[0] * pad,
        p.cluster, p.k_slice, p.col_tile, m_rows(m), DTYPES[x.dtype],
        int(out_dtype != x.dtype),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fc_gemv")
    LAUNCHES += 1
    LAUNCHES_BY_M[m] = LAUNCHES_BY_M.get(m, 0) + 1
    return ys


def fc_gemv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [m, K] @ w [K, N] -> [m, N] in x's dtype, through FC-PIM."""
    return fc_gemv_group(x, [w])[0]
