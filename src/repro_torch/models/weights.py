"""Weight bridge: the JAX package's parameter pytree -> the port's.

Both packages stack per-layer leaves on a leading layer axis under the same
keys, so the bridge is a straight copy, checked leaf by leaf against
`model_spec`.  The caller hands the tree over as nested dicts of numpy
arrays (e.g. ``jax.tree.map(np.asarray, params)``); bf16 leaves arrive as
``ml_dtypes.bfloat16`` and go through float32 (exact) to torch.bfloat16.
Each leaf takes its spec's dtype: the model's, except the SSM's A_log and
dt_bias, which stay f32 in a bf16 model as in the reference.  This is how
the tests hold the two packages to the same weights.

`shard_params` keeps each rank's block of every leaf under a rule table
and mesh (`model.param_shardings`): ``params_from_jax`` then
``shard_params`` gives every rank of a mesh its part of the reference's
weights (under `train_rules` the "fsdp" dims over "data", ZeRO-3).
`unshard_params` is its inverse: every leaf gathered back whole, on every
rank (a collective: every rank of the mesh calls it), for checkpoints and
for comparing a mesh's trees with one device's; any tree of the params'
structure takes it (the AdamW moments).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (block_range, full_tensor,
                                              local_block)
from repro_torch.models.model import (DTYPES, PSpec, model_spec,
                                      param_shapes, param_shardings)


def params_from_jax(cfg: ModelConfig, tree: dict,
                    device: torch.device | str) -> dict:
    def walk(spec: dict, node: dict, path: str) -> dict:
        missing = set(spec) - set(node)
        if missing:
            raise KeyError(f"{path or 'params'} lacks {sorted(missing)}")
        out = {}
        for key, sub in spec.items():
            where = f"{path}/{key}"
            if isinstance(sub, PSpec):
                arr = np.array(node[key], dtype=np.float32)  # own copy
                if arr.shape != sub.shape:
                    raise ValueError(f"{where}: shape {arr.shape}, expected "
                                     f"{sub.shape}")
                out[key] = torch.from_numpy(arr).to(
                    device=device, dtype=DTYPES[sub.dtype or cfg.dtype])
            else:
                out[key] = walk(sub, node[key], where)
        return out

    return walk(model_spec(cfg), tree, "")


def shard_params(cfg: ModelConfig, params: dict, rules, mesh) -> dict:
    """This rank's block of every leaf of `params` under `rules` and
    `mesh` (`model.param_shardings`); a leaf already cut to its block is
    kept as it is, so the call is idempotent."""
    def walk(specs: dict, shapes: dict, node: dict, path: str) -> dict:
        out = {}
        for key, spec in specs.items():
            where, leaf = f"{path}/{key}", node[key]
            if isinstance(spec, dict):
                out[key] = walk(spec, shapes[key], leaf, where)
                continue
            block = tuple(hi - lo for lo, hi in (
                block_range(n, e, mesh) for n, e in zip(shapes[key], spec)))
            if tuple(leaf.shape) == block:
                out[key] = leaf
            elif tuple(leaf.shape) == shapes[key]:
                out[key] = local_block(leaf, spec, mesh)
            else:
                raise ValueError(f"{where}: shape {tuple(leaf.shape)} is "
                                 f"neither the full leaf {shapes[key]} nor "
                                 f"this rank's block {block}")
        return out

    return walk(param_shardings(cfg, rules, mesh), param_shapes(cfg), params,
                "")


@torch.no_grad()
def unshard_params(cfg: ModelConfig, params: dict, rules, mesh) -> dict:
    """Every leaf of a rank's `params` (or of a tree of their structure)
    gathered whole under `rules` and `mesh`: the inverse of
    `shard_params`."""
    def walk(specs: dict, node: dict) -> dict:
        return {k: (walk(sp, node[k]) if isinstance(sp, dict)
                    else full_tensor(node[k].detach(), sp, mesh))
                for k, sp in specs.items()}

    return walk(param_shardings(cfg, rules, mesh), params)
