"""Mamba2 / SSD block — the port of `repro.models.ssm`.

Recurrence (per head h, head_dim p, state n):
    S_t = exp(dt_t * A) * S_{t-1} + dt_t * (x_t outer B_t)      S: [p, n]
    y_t = S_t @ C_t + D * x_t

Prefill uses the chunked SSD form through the `ssd_scan` kernel (its plain
version on the CPU); decode uses the O(1) recurrent step in plain PyTorch,
as the reference does.  Training (``train=True``) takes the differentiable
chunked form `ssd_scan_ref` on every device, as the reference's training
lowers its plain `_ssd_chunked`: the kernel has no backward.  Precisions follow the reference: dtx = dt * x and
the state in f32, B/C/y in the model dtype.

The prefill updates a state handed in IN PLACE (the reference returns new
arrays): `mamba2_block` writes the new conv histories and SSM state into
the `SSMState` it was given — the cache's slices — as the KV cache is
written.  The decode step reads ``state`` and writes the new one into
``out``, leaving ``state`` as it was (the same bytes as an update in
place), so that a caller can keep the pre-step state of a decode step
until its logits are known to be finite.

A prefill given ``lens`` stops each row's state at its prompt's end: dt
is zero past it, so the decay there is e^0 = 1 and the update 0, and the
conv history is the K-1 inputs that end at the prompt's last token.  The
window's padding then never reaches the state (the reference's does).  A
decode step whose ``out`` has a leading [t] axis writes the state after
each of the window's t tokens, so that a speculative verify can be
rewound to any accepted prefix.

`ssd_impl("plain")` sends `_ssd_chunked` to the plain version even for
tensors on the card, so that the kernel path can be held against it.

Under a mesh whose rules put "ssm_heads" on the tensor axis (the
reference's `serve_rules`), each rank holds its heads: the head-major
columns of ``w_z`` / ``w_x`` / ``conv_x`` / ``norm_w``, the rows of
``w_out`` and its heads of ``w_dt``, ``A_log``, ``D``, ``dt_bias`` and the
state.  B and C are group-shared (``n_groups = 1``): ``w_B`` / ``w_C`` /
``conv_B`` / ``conv_C`` stay whole and every rank computes them.  The
block then runs at the rank's width (the scan on its heads), and two sums
cross the tensor group, both in rank order: the gated RMSNorm's sum of
squares ([b, l, 1] in f32, divided by the whole ``d_inner``: its mean
runs over every head) and ``w_out``'s partial product (a row split).
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.distributed.sharding import split_axis
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref

_ssd_state = threading.local()


def current_ssd_impl() -> str:
    """Chunked-scan implementation: "kernel" (default; its plain version
    for CPU tensors) or "plain"."""
    return getattr(_ssd_state, "impl", "kernel")


@contextlib.contextmanager
def ssd_impl(impl: str):
    if impl not in ("kernel", "plain"):
        raise ValueError(f"ssd impl must be 'kernel' or 'plain', not {impl!r}")
    prev = current_ssd_impl()
    _ssd_state.impl = impl
    try:
        yield
    finally:
        _ssd_state.impl = prev


class SSMState(NamedTuple):
    conv_x: torch.Tensor   # [b, K-1, di]
    conv_B: torch.Tensor   # [b, K-1, n]
    conv_C: torch.Tensor   # [b, K-1, n]
    ssm: torch.Tensor      # [b, nh, hp, n] (f32)


def init_state(batch: int, d_model: int, s: SSMConfig, dtype: torch.dtype,
               device: torch.device | str) -> SSMState:
    di, nh, k = s.d_inner(d_model), s.n_heads(d_model), s.conv_kernel - 1
    return SSMState(
        conv_x=torch.zeros((batch, k, di), dtype=dtype, device=device),
        conv_B=torch.zeros((batch, k, s.d_state), dtype=dtype, device=device),
        conv_C=torch.zeros((batch, k, s.d_state), dtype=dtype, device=device),
        ssm=torch.zeros((batch, nh, s.head_dim, s.d_state),
                        dtype=torch.float32, device=device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor | None,
                 lens: torch.Tensor | None = None, steps: bool = False):
    """Depthwise causal conv1d.  x: [b, l, c]; w: [K, c].  Returns
    (y [b, l, c], new_state [b, K-1, c]): the K-1 inputs that end at row
    lens[b] - 1 of the window (its last row when `lens` is None), history
    included (`state`, zeros when None), so that a row shorter than K-1
    keeps the tail of its history.  With `steps`, new_state is the
    history after each of the l rows, [l, b, K-1, c]."""
    k = w.shape[0]
    if state is None:
        hist = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    else:
        hist = state.to(x.dtype)
    xp = torch.cat([hist, x], dim=1)                   # [b, l+K-1, c]
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    if steps:
        # the window starting at row j of xp is the history after j rows
        return y, xp.unfold(1, k - 1, 1)[:, 1:].permute(1, 0, 3, 2)
    if lens is None:
        return y, xp[:, -(k - 1):, :]
    rows = lens.long()[:, None] + torch.arange(k - 1, device=x.device)
    return y, torch.gather(xp, 1, rows[..., None].expand(-1, -1, xp.shape[2]))


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int,
                 init_state: torch.Tensor | None = None,
                 train: bool = False):
    """Chunked SSD.  x [b, l, nh, hp], dt [b, l, nh] f32, A [nh] f32,
    B/C [b, l, n], init_state [b, nh, hp, n] f32 or None.  Returns
    (y [b, l, nh, hp] in x's dtype, final_state [b, nh, hp, n] f32).
    `train` takes the differentiable plain scan (the train path)."""
    dtx = (dt[..., None] * x.float()).permute(0, 2, 1, 3).contiguous()
    lt = (dt * A[None, None, :]).permute(0, 2, 1).contiguous()
    scan = (ssd_scan if current_ssd_impl() == "kernel" and not train
            else ssd_scan_ref)
    y, final = scan(dtx, lt, B.contiguous(), C.contiguous(), chunk=chunk,
                    init_state=(init_state.contiguous()
                                if init_state is not None else None),
                    out_dtype=x.dtype)
    return y.permute(0, 2, 1, 3), final


def _ssd_recurrent(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, state: torch.Tensor,
                   out: torch.Tensor, steps: bool = False):
    """The recurrent step over t (small) tokens: x [b, t, nh, hp], dt
    [b, t, nh] f32, state [b, nh, hp, n] f32, read, and the new state
    written to `out`; with `steps`, out is [t, b, nh, hp, n] and out[i]
    takes the state after token i.  Returns (y [b, t, nh, hp] in x's
    dtype, out)."""
    ys, src = [], state
    for i in range(x.shape[1]):
        dst = out[i] if steps else out
        dtt = dt[:, i].float()                                 # [b, nh]
        g = torch.exp(dtt * A[None, :])
        upd = torch.einsum("bh,bhp,bn->bhpn", dtt, x[:, i].float(),
                           B[:, i].float())
        torch.mul(src, g[..., None, None], out=dst).add_(upd)
        src = dst
        ys.append(torch.einsum("bhpn,bn->bhp", dst, C[:, i].float()))
    return torch.stack(ys, dim=1).to(x.dtype), out


def mamba2_block(u: torch.Tensor, p: dict, s: SSMConfig, d_model: int,
                 state: SSMState | None = None, decode: bool = False,
                 out: SSMState | None = None,
                 lens: torch.Tensor | None = None, train: bool = False):
    """Full Mamba2 block on the normed input u [b, l, d].  Returns
    (out [b, l, d], new_state): the prefill's is `state` itself, updated
    in place, when one was given; the decode step (which needs both)
    reads `state` and returns `out`, holding the new state — or, when
    `out`'s tensors have a leading [l] axis, the state after each token.
    `lens` [b] (prefill only): the valid rows of each window; the state
    stops at them, and the output rows past them are garbage.  `train`
    (no state): the differentiable scan, no kernel.  Under a mesh that
    splits "ssm_heads" `p` and the states hold the rank's heads (module
    docstring)."""
    b, l, _ = u.shape
    hp, heads = s.head_dim, s.n_heads(d_model)
    split = split_axis("ssm_heads", heads)
    nh = p["A_log"].shape[0]                 # the rank's heads
    if nh != (heads if split is None else heads // split[0].shape[split[1]]):
        raise ValueError(f"Mamba2 block holds {nh} of {heads} heads, not "
                         "its block under the rules")
    di = nh * hp

    z = torch.matmul(u, p["w_z"])
    x = torch.matmul(u, p["w_x"])
    Bp = torch.matmul(u, p["w_B"])
    Cp = torch.matmul(u, p["w_C"])
    dt = torch.matmul(u, p["w_dt"])

    has = state is not None
    steps = decode and out is not None and out.ssm.dim() == 5
    hist = state[:3] if has else (None,) * 3
    cx, new_cx = _causal_conv(x, p["conv_x"], hist[0], lens, steps)
    cB, new_cB = _causal_conv(Bp, p["conv_B"], hist[1], lens, steps)
    cC, new_cC = _causal_conv(Cp, p["conv_C"], hist[2], lens, steps)
    cx = F.silu(cx.float()).to(u.dtype)
    cB = F.silu(cB.float()).to(u.dtype)
    cC = F.silu(cC.float()).to(u.dtype)

    xh = cx.reshape(b, l, nh, hp)
    dtf = F.softplus(dt.float() + p["dt_bias"].float())
    if lens is not None:
        # dt = 0 past the prompt: no decay (e^0) and no update there, so
        # the state is the prompt's own (softplus itself is never 0)
        valid = (torch.arange(l, device=u.device)[None, :]
                 < lens.long()[:, None])
        dtf = torch.where(valid[..., None], dtf, torch.zeros_like(dtf))
    A = -torch.exp(p["A_log"].float())

    if decode:
        assert has and out is not None, "the decode step needs both states"
        y, new_ssm = _ssd_recurrent(xh, dtf, A, cB, cC, state.ssm, out.ssm,
                                    steps=steps)
    else:
        y, new_ssm = _ssd_chunked(xh, dtf, A, cB, cC, s.chunk_size,
                                  state.ssm if has else None, train=train)

    y = y + p["D"].to(u.dtype)[None, None, :, None] * xh
    y = y.reshape(b, l, di)

    # gated RMSNorm: norm(y * silu(z)) * w  (mamba2's RMSNormGated); its
    # mean runs over the whole d_inner, every rank's heads
    gated = y.float() * F.silu(z.float())
    if split is None:
        var = gated.square().mean(dim=-1, keepdim=True)
    else:
        mesh, axis = split
        var = mesh.all_reduce(gated.square().sum(dim=-1, keepdim=True),
                              axis) / s.d_inner(d_model)
    gated = gated * torch.rsqrt(var + 1e-5) * p["norm_w"].float()
    y_out = torch.matmul(gated.to(u.dtype), p["w_out"])
    if split is not None:                    # w_out: a row split
        y_out = mesh.all_reduce(y_out, axis)

    if not has:
        return y_out, SSMState(new_cx, new_cB, new_cC, new_ssm)
    dst = out if decode else state
    dst.conv_x.copy_(new_cx)
    dst.conv_B.copy_(new_cB)
    dst.conv_C.copy_(new_cC)
    if new_ssm is not dst.ssm:
        dst.ssm.copy_(new_ssm)
    return y_out, dst
