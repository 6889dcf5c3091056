"""AdamW from scratch — the port of `repro.training.optim`.

Mixed precision as in the reference: the moments m and v are f32 whatever
the parameter's dtype, the update is computed in f32 and cast to the
parameter's dtype.  Gradients are clipped by their global norm, the
moments bias-corrected, and weight decay applies to leaves with two or more
dimensions.  The parameters keep the reference's stacked layout (one leaf
per weight, with a leading layer axis), so the per-layer norm weights
``[L, d]`` are decayed too, exactly as in the reference.

Each function is plain PyTorch under ``torch.no_grad()``.  `adamw_update`
writes the new parameters and moments IN PLACE (the reference returns new
arrays) and returns the same objects; the step counter is a 0-d int32
tensor on the parameters' device, so no step reads back to the host.
Over a mesh (`launch.steps.build_step`'s train cell) the parameters,
gradients and both moments are a rank's blocks under the rules (ZeRO-3
over "data": the moments take the parameters' axes, so a leaf split over
"data" and "model" keeps its 2D block in both), so `adamw_update` runs
on the blocks as it is; only the gradient norm sums its blocks' sums of
squares over the axes each leaf is split over (`global_norm`'s
``split``).
`zero1_logical_axes` is the reference's ZeRO-1 rule for the states of a
parameter the rules keep whole; no step of the port calls it yet, as the
reference's `build_step` does not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.training.tree import leaves, tree_map

Tree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor       # 0-d int32
    m: Tree                  # first moment (f32)
    v: Tree                  # second moment (f32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def init_adamw(params: Tree) -> AdamWState:
    first = leaves(params)[0]

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(
        torch.zeros((), dtype=torch.int32, device=first.device),
        tree_map(zeros, params), tree_map(zeros, params))


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


@torch.no_grad()
def global_norm(tree: Tree, split=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares.  ``split=(mesh,
    axes)``: ``axes[i]`` names the mesh axes leaf i is a rank's block
    over; its sum is summed over each of them (one collective an axis for
    all the leaves split over it, the axes in name order), and a leaf
    whole over an axis counts once."""
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    if split is not None:
        mesh, axes = split
        for axis in sorted({a for ax in axes for a in ax}):
            idx = [i for i, ax in enumerate(axes) if axis in ax]
            whole = mesh.all_reduce(torch.stack([sq[i] for i in idx]), axis)
            for j, i in enumerate(idx):
                sq[i] = whole[j]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree,
                 state: AdamWState, split=None
                 ) -> tuple[Tree, AdamWState, dict]:
    """One AdamW step.  Writes params, m and v in place; returns (params,
    the state with the new step, {"grad_norm", "lr"}).  `split`: the
    mesh axes of the blocks (`global_norm`)."""
    gnorm = global_norm(grads, split)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.dim() >= 2:    # decay matrices only (standard LLM practice)
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm,
                                                        "lr": lr}


def zero1_logical_axes(param_axes: Tree, param_shapes: Tree) -> Tree:
    """Logical axes of the optimizer states (ZeRO-1), the reference's
    rule: a parameter with an "fsdp" dim passes its axes on; otherwise
    the first unnamed dim of at least 64 becomes "fsdp".  `param_shapes`
    holds shape tuples (or anything with ``.shape``)."""
    if isinstance(param_axes, dict):
        return {k: zero1_logical_axes(v, param_shapes[k])
                for k, v in param_axes.items()}
    axes = tuple(param_axes)
    if "fsdp" in axes:
        return axes
    shape = tuple(getattr(param_shapes, "shape", param_shapes))
    out = list(axes)
    for i, (a, d) in enumerate(zip(axes, shape)):
        if a is None and d >= 64:
            out[i] = "fsdp"
            break
    return tuple(out)
