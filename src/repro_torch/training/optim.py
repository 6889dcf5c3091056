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
The ZeRO-1 state sharding (`zero1_logical_axes`) waits for the mesh.
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
def global_norm(tree: Tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree,
                 state: AdamWState) -> tuple[Tree, AdamWState, dict]:
    """One AdamW step.  Writes params, m and v in place; returns (params,
    the state with the new step, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
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
