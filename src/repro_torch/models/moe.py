"""Mixture-of-Experts layer — the port of `repro.models.moe`: a top-k
softmax router, the Switch load-balancing loss and the expert SwiGLU MLPs.

The reference dispatches with one-hot einsums into an ``[experts,
capacity]`` buffer per group of `GROUP_SIZE` tokens, and drops what
overflows.  Its groups hold at most 1024 tokens, so `expert_capacity`
returns the group size and no expert can overflow: every (token, expert)
assignment is computed.  The port computes that same function by gather
instead of the ``[g, 1024, E, 1024]`` dispatch tensor, and runs each expert
over its routed rows only, not over the whole capacity:

  * the ``[tokens, top_k]`` assignments are sorted by expert;
  * each expert's rows go through its ``w_gate`` / ``w_up`` / ``w_down``
    with `torch.matmul` (the reference's experts are einsums, outside any
    Pallas kernel: no FC-PIM, no kernel here either);
  * each result is put back at its assignment and the top-k results of a
    token are summed in f32 with their renormalized weights, in top-k
    order (no atomics, so the sum is the same on every run).

The rows per expert are a host-side split, so `moe_mlp` reads the per-expert
counts back once per call: one device->host copy per MoE layer.  The copy
is counted (`host_copies`): the engine adds it to its iteration's
transfers and to the sanitizer's budget, and runs it inside the
sanitizer's allow-scope (`debug.sanitize.transfer_allowed`).  Numerics keep
the reference's dtype flow: router logits and softmax in f32, ``silu`` in
f32 cast back to x's dtype before ``* up``, the combine weights cast to x's
dtype.

Expert parallelism (the reference's "experts" -> "model" rule,
`serve_rules`): each rank holds ``E / tp`` experts (``w_gate`` / ``w_up``
/ ``w_down`` cut on the expert dim; the router whole), routes every token
over all E experts, and runs only the assignments that name its own.  It
weights its results with the renormalised top-k weights in f32, leaves
zeros for the other ranks' assignments, and the ``[tokens, d]`` f32
partials are summed over the tensor group in rank order, then cast to x's
dtype — where the reference's GSPMD sums the combine einsum over "model".
The count copy is then of the rank's own experts, still one a layer.  A
rank that owns none of a call's assignments computes nothing and adds
zeros.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.debug.sanitize import transfer_allowed
from repro_torch.distributed.sharding import split_axis, tensor_split

# tokens are routed in groups of this many (the reference's GShard "G")
GROUP_SIZE = 1024

# device->host copies of the per-expert counts, one per `moe_mlp` call
_COPIES = [0]


def host_copies() -> int:
    """Device->host copies `moe_mlp` has made in this process."""
    return _COPIES[0]


def expert_capacity(num_tokens: int, cfg: MoEConfig) -> int:
    """Buffer rows per expert for a group of `num_tokens`: all of them up to
    2048 tokens (serving is lossless), else top_k/E of them times the
    capacity factor, rounded up to a multiple of 8 (at least 8)."""
    if num_tokens <= 2048:
        return num_tokens
    cap = math.ceil(num_tokens * cfg.top_k / cfg.num_experts
                    * cfg.capacity_factor)
    return max(8, (cap + 7) // 8 * 8)


def router(x: torch.Tensor, w_router: torch.Tensor, cfg: MoEConfig):
    """x [tokens, d] -> (top-k expert ids [tokens, k], their weights
    renormalized to sum to one [tokens, k], router probs [tokens, E])."""
    logits = torch.matmul(x.float(), w_router.float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(dim=-1, keepdim=True), min=1e-9)
    return top_e, top_w, probs


def load_balancing_loss(probs: torch.Tensor, top_e: torch.Tensor,
                        num_experts: int) -> torch.Tensor:
    """Switch-transformer aux loss: E * sum_e f_e * P_e, with f_e the share
    of assignments routed to expert e and P_e its mean probability.  probs
    [..., tokens, E], top_e [..., tokens, k] -> one loss per leading index
    (a group)."""
    te = top_e.reshape(*top_e.shape[:-2], -1)
    occ = torch.zeros((*te.shape[:-1], num_experts), dtype=torch.float32,
                      device=probs.device)
    occ.scatter_add_(-1, te, torch.ones_like(te, dtype=torch.float32))
    f = occ / te.shape[-1]
    return num_experts * torch.sum(f * probs.mean(dim=-2), dim=-1)


def moe_mlp(x: torch.Tensor, p: dict, cfg: MoEConfig, data=None):
    """x [b, s, d] -> (y [b, s, d], aux loss).  p: w_router [d, E];
    w_gate / w_up [E, d, f]; w_down [E, f, d] (under an expert split the
    rank's E / tp of them: module docstring).  The aux loss is the mean of
    `load_balancing_loss` over groups of `GROUP_SIZE` tokens.

    ``data=(mesh, axis)`` (training over the data axis): x is this rank's
    rows of a global batch whose groups are the reference's, those of the
    whole batch in rank order.  Each rank computes its whole groups and
    returns its share of the mean over every rank's (its groups' sum over
    the global group count), which the caller sums over `axis`
    (`models.forward_train`, once for all layers).  A group that would
    straddle two ranks' rows raises."""
    b, s, d = x.shape
    tokens = b * s
    ranks = 1 if data is None else data[0].shape[data[1]]
    gs = min(GROUP_SIZE, tokens * ranks)
    if tokens % gs:
        if ranks > 1:
            raise ValueError(
                f"MoE groups of {gs} tokens straddle the data ranks: a "
                f"rank holds {tokens} tokens of the global batch's "
                f"{tokens * ranks}; give each rank a multiple of {gs}")
        raise ValueError(f"{tokens} tokens are not divisible into MoE groups "
                         f"of {gs}")
    g, k = tokens // gs, cfg.top_k
    xt = x.reshape(tokens, d)
    top_e, top_w, probs = router(xt, p["w_router"], cfg)
    aux = load_balancing_loss(probs.view(g, gs, -1), top_e.view(g, gs, k),
                              cfg.num_experts)
    if ranks > 1:
        aux = aux.sum() / (g * ranks)
    else:
        aux = aux.mean()

    # this rank's experts e0 .. e0 + n (all of them outside a split); the
    # other ranks' assignments sort last, into bucket n, and are not run
    split = split_axis("experts", cfg.num_experts)
    n = p["w_gate"].shape[0]
    e0 = tensor_split("experts", cfg.num_experts)[1] * n
    flat = top_e.reshape(-1) - e0                            # [tokens * k]
    own = (flat >= 0) & (flat < n)
    flat = torch.where(own, flat, torch.full_like(flat, n))
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(n + 1, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    _COPIES[0] += 1
    with transfer_allowed():
        counts = counts[:n].tolist()
    order = order[:sum(counts)]
    xs = xt.index_select(0, order // k)                      # sorted rows
    y_assign = torch.zeros((tokens * k, d), dtype=x.dtype, device=x.device)
    ys = []
    for e, rows in enumerate(torch.split(xs, counts)):
        if rows.shape[0] == 0:
            continue
        gate = torch.matmul(rows, p["w_gate"][e])
        up = torch.matmul(rows, p["w_up"][e])
        act = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
        ys.append(torch.matmul(act, p["w_down"][e]))
    if ys:
        y_assign.index_copy_(0, order, torch.cat(ys))
    w = top_w.to(x.dtype).float()[..., None]                 # [tokens, k, 1]
    y = (y_assign.view(tokens, k, d).float() * w).sum(dim=1)
    if split is not None:                    # the combine over the ranks
        y = split[0].all_reduce(y, split[1])
    return y.to(x.dtype).view(b, s, d), aux
