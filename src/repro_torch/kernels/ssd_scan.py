"""Mamba2 SSD chunk scan — the port of `repro.kernels.ssd_scan.ssd_scan`.

Per (batch, head) the chunks of cs = min(chunk, l) rows run in order and
carry the [hp, n] f32 state:

    y_c = (C_c B_cᵀ ∘ L_c) dtx_c + (e^{cum_c} ∘ C_c) Sᵀ
    S   ← e^{cum_c,last} S + (e^{cum_c,last − cum_c} ∘ dtx_c)ᵀ B_c

with cum the within-chunk inclusive cumsum of the log-decay lt (f32) and
L_c[i, j] = e^{cum_i − cum_j} for j ≤ i, else 0.  The wrapper takes cum
with `chunk_cumsum`, as the Pallas wrapper does, and the plain version
takes it the same way: at cs = 256, |cum| reaches hundreds, and two
summation orders would differ in e^{cum_i − cum_j} beyond the f32
tolerance.  Unlike the Pallas kernel, the scan also takes an initial
state and returns the state after the last chunk: the serving path
(`models.ssm._ssd_chunked`) needs both.

`ssd_scan` launches the hand-written CUDA kernels (``csrc/ssd_scan.cu``)
for tensors on the card and uses the plain PyTorch version `ssd_scan_ref`
for tensors on the CPU.  A call on the card is two CUDA launches
(`cuda_launches`): C·Bᵀ once per (batch row, chunk) into f32 scratch the
wrapper allocates (`cb_scratch`), then the scan over the heads.  `LAUNCHES`
counts calls that ran the kernels, one per call (CPU calls and
`ssd_scan_ref` do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)
SHAPES = ((32, 16), (64, 64), (64, 128))   # (hp, n) the kernel is built for
ROW_TILE = 64                               # the kernels' chunk rows per tile

LAUNCHES = 0
_fns = None


def chunk_cumsum(lt: torch.Tensor, cs: int) -> torch.Tensor:
    """Inclusive cumsum of lt [b, nh, l] within each chunk of cs rows, f32."""
    b, nh, l = lt.shape
    return torch.cumsum(lt.to(torch.float32).reshape(b, nh, l // cs, cs),
                        dim=-1)


def segment_decay(seg: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """L = e^seg on and below the diagonal, 0 above it, masked BEFORE the
    exp.  Above the diagonal seg is a positive decay sum that passes f32's
    exp limit (88.7) within a 256-row chunk under the init laws; e^seg is
    then inf, and a `where` after the exp multiplies its zero gradient by
    that inf (NaN).  e^-inf = 0 gives the same values, finite gradients."""
    return torch.exp(seg.masked_fill(~mask, float("-inf")))


def ssd_scan_ref(dtx: torch.Tensor, lt: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, *, chunk: int = 256,
                 init_state: torch.Tensor | None = None,
                 out_dtype: torch.dtype | None = None):
    """Plain version: the chunked SSD algorithm of `repro.models.ssm.
    _ssd_chunked` in the kernel's layout, f32 throughout.  Returns
    (y [b, nh, l, hp] in out_dtype (default dtx's), state [b, nh, hp, n]).
    Differentiable: it is also the training path's scan
    (`models.ssm._ssd_chunked` in mode "train")."""
    b, nh, l, hp = dtx.shape
    n = B.shape[-1]
    cs = min(chunk, l)
    assert l % cs == 0, f"seq {l} not divisible by chunk {cs}"
    nc = l // cs
    f32 = torch.float32
    x = dtx.to(f32).reshape(b, nh, nc, cs, hp)
    cum = chunk_cumsum(lt, cs)                             # [b, nh, nc, cs]
    Bc = B.to(f32).reshape(b, nc, cs, n)
    Cc = C.to(f32).reshape(b, nc, cs, n)

    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    seg = cum[..., :, None] - cum[..., None, :]            # [b, nh, nc, i, j]
    mask = torch.ones((cs, cs), dtype=torch.bool, device=dtx.device).tril()
    Lm = segment_decay(seg, mask)
    y = torch.einsum("bhcij,bhcjp->bhcip", CB[:, None] * Lm, x)

    decay_to_end = torch.exp(cum[..., -1:] - cum)          # [b, nh, nc, cs]
    S_chunk = torch.einsum("bhcjp,bcjn->bhcpn", x * decay_to_end[..., None],
                           Bc)
    G = torch.exp(cum[..., -1])                            # [b, nh, nc]
    state = (torch.zeros((b, nh, hp, n), dtype=f32, device=dtx.device)
             if init_state is None else init_state.to(f32))
    inter = []
    for c in range(nc):
        inter.append(torch.einsum("bin,bhi,bhpn->bhip", Cc[:, c],
                                  torch.exp(cum[:, :, c]), state))
        state = G[:, :, c, None, None] * state + S_chunk[:, :, c]
    y = y + torch.stack(inter, dim=2)
    return y.reshape(b, nh, l, hp).to(out_dtype or dtx.dtype), state


def cuda_launches() -> int:
    """CUDA launches of one call on the card (the C·Bᵀ pass, the scan)."""
    return 2


def cb_scratch(b: int, l: int, cs: int, device) -> torch.Tensor:
    """The f32 C·Bᵀ tiles of every (batch row, chunk): [b, l / cs, csp,
    csp] with csp = cs rounded up to `ROW_TILE`; only the tiles on and
    below the diagonal are written and read."""
    csp = -(-cs // ROW_TILE) * ROW_TILE
    return torch.empty((b, l // cs, csp, csp), dtype=torch.float32,
                       device=device)


def bind(lib: ctypes.CDLL):
    """(prepare, launch): the C functions of a built ``ssd_scan`` library
    with their argument types."""
    prep, launch = lib.ssd_scan_prepare, lib.ssd_scan_launch
    prep.argtypes = [ctypes.c_int] * 9
    prep.restype = ctypes.c_int
    launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    launch.restype = ctypes.c_int
    return prep, launch


def _launch_fns():
    global _fns
    if _fns is None:
        _fns = bind(_build.load("ssd_scan"))
    return _fns


def ssd_scan(dtx: torch.Tensor, lt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, chunk: int = 256,
             init_state: torch.Tensor | None = None,
             out_dtype: torch.dtype | None = None):
    """dtx [b, nh, l, hp], lt [b, nh, l] f32, B/C [b, l, n], init_state
    [b, nh, hp, n] f32 or None (zeros) -> (y [b, nh, l, hp] in out_dtype
    (default dtx's), final state [b, nh, hp, n] f32)."""
    global LAUNCHES
    _build.refuse_autograd("ssd_scan", dtx, lt, B, C, init_state)
    if dtx.dim() != 4 or lt.dim() != 3 or B.dim() != 3 or C.dim() != 3:
        raise ValueError("ssd_scan wants dtx[b,nh,l,hp], lt[b,nh,l], "
                         "B[b,l,n], C[b,l,n]")
    b, nh, l, hp = dtx.shape
    n = B.shape[-1]
    if (tuple(lt.shape) != (b, nh, l) or tuple(B.shape) != (b, l, n)
            or tuple(C.shape) != (b, l, n)):
        raise ValueError(f"ssd_scan shapes disagree: dtx {tuple(dtx.shape)}, "
                         f"lt {tuple(lt.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}")
    if init_state is not None and tuple(init_state.shape) != (b, nh, hp, n):
        raise ValueError(f"init_state {tuple(init_state.shape)}, expected "
                         f"{(b, nh, hp, n)}")
    out_dtype = out_dtype or dtx.dtype
    f32 = torch.float32
    if (dtx.dtype not in DTYPES or B.dtype not in DTYPES
            or B.dtype != C.dtype or out_dtype not in DTYPES
            or lt.dtype != f32
            or (init_state is not None and init_state.dtype != f32)):
        raise TypeError(f"ssd_scan takes dtx/B/C/y in float32 or bfloat16 "
                        f"(B and C alike) and lt/init_state in float32, got "
                        f"dtx {dtx.dtype}, lt {lt.dtype}, B {B.dtype}, "
                        f"C {C.dtype}, y {out_dtype}")
    cs = min(chunk, l)
    if l % cs:
        raise ValueError(f"seq {l} not divisible by chunk {cs}")
    tensors = [dtx, lt, B, C] + ([init_state] if init_state is not None
                                 else [])
    if any(t.device != dtx.device for t in tensors):
        raise ValueError("ssd_scan inputs lie on different devices")
    if dtx.device.type == "cpu":
        return ssd_scan_ref(dtx, lt, B, C, chunk=chunk,
                            init_state=init_state, out_dtype=out_dtype)
    if dtx.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {dtx.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in (dtx, B, C)):
        raise ValueError("dtx, B and C must be 16-byte aligned (cp.async)")
    if (hp, n) not in SHAPES:
        raise ValueError(f"ssd_scan kernel is built for (hp, n) in {SHAPES}, "
                         f"not {(hp, n)}")
    bf16 = torch.bfloat16
    kinds = (int(dtx.dtype == bf16), int(B.dtype == bf16),
             int(out_dtype == bf16))
    prepare, launch = _launch_fns()
    # a chunk past a block's shared memory is refused here, before the
    # scratch is allocated
    _build.check(prepare(b, nh, l, cs, hp, n, *kinds), "ssd_scan")
    y = torch.empty((b, nh, l, hp), dtype=out_dtype, device=dtx.device)
    final = torch.empty((b, nh, hp, n), dtype=f32, device=dtx.device)
    cb = cb_scratch(b, l, cs, dtx.device)
    cum = chunk_cumsum(lt, cs)
    err = launch(
        dtx.data_ptr(), cum.data_ptr(), B.data_ptr(), C.data_ptr(),
        init_state.data_ptr() if init_state is not None else None,
        y.data_ptr(), final.data_ptr(), cb.data_ptr(), b, nh, l, cs, hp, n,
        *kinds, torch.cuda.current_stream(dtx.device).cuda_stream)
    _build.check(err, "ssd_scan")
    LAUNCHES += 1
    return y, final
