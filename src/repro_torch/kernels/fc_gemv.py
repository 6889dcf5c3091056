"""FC-PIM: the weight-streaming skinny matmul ``y = x @ w`` (f32 sums,
output in x's dtype) — the port of `repro.kernels.fc_gemv.fc_gemv`.

`fc_gemv` launches the hand-written CUDA kernel (``csrc/fc_gemv.cu``) for
tensors on the card and uses the plain PyTorch version `fc_gemv_ref` for
tensors on the CPU.  `LAUNCHES` counts kernel launches (CPU calls and
`fc_gemv_ref` do not count), so a run can show the path went through it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_N = 128        # output columns per block (FC_BN in the source)
K_SLICE = 128        # K rows per block: FC_NW warps x FC_UK rows in flight
KS_MAX = 256         # longest K slice a block holds (FC_KS_MAX)

LAUNCHES = 0
_fn = None


def fc_gemv_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: x [m, K] @ w [K, N] with f32 accumulation."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def k_split_for(K: int) -> int:
    """Rows of K per block: one slice of K_SLICE rows, whose loads a block
    issues all at once (a K that fits one slice is not split)."""
    return min(K, K_SLICE)


def _launch_fn():
    global _fn
    if _fn is None:
        fn = _build.load("fc_gemv").fc_gemv_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fc_gemv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [m, K] @ w [K, N] -> [m, N] in x's dtype, through FC-PIM."""
    global LAUNCHES
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fc_gemv wants x[m,K] @ w[K,N], got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in DTYPES:
        raise TypeError(f"fc_gemv takes float32 or bfloat16 pairs, got "
                        f"{x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if x.device.type == "cpu":
        return fc_gemv_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"fc_gemv runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("fc_gemv needs contiguous x and w")
    m, K = x.shape
    N = w.shape[1]
    ks = k_split_for(K)
    splits = -(-K // ks)
    y = torch.empty((m, N), dtype=x.dtype, device=x.device)
    partial = (torch.empty((splits, m, N), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    err = _launch_fn()(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                       partial.data_ptr() if partial is not None else None,
                       m, K, N, ks, DTYPES[x.dtype],
                       torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fc_gemv")
    LAUNCHES += 1
    return y
