"""Stand-ins for every model input of a shape cell — the port of
`repro.launch.specs`.  Where the reference returns `ShapeDtypeStruct`s,
the port returns tensors on the ``meta`` device: the shapes and dtypes,
nothing allocated.

  input_specs(cfg, cell, data_shards) -> (batch_specs, cache_specs | None,
                                          accum)

  train_4k     -> the train step's batch, microbatched per
                  `configs.microbatch_plan` (a leading [accum] axis)
  prefill_32k  -> the prompt batch and the empty cache it fills
  decode_32k   -> one new token against a seq_len cache
  long_500k    -> the same at 524288 positions (SSM / hybrid only)

An audio batch carries frames and a mask, a VLM batch a quarter of its
positions as patch embeddings and [b, 3, s] M-RoPE triples, every other
family tokens; a train batch adds its targets.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell, microbatch_plan
from repro_torch.models.model import DTYPES, cache_shapes

Tree = Any

_I32 = torch.int32


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_like(cfg: ModelConfig, b: int, s: int, with_targets: bool) -> dict:
    d = DTYPES[cfg.dtype]
    if cfg.family == "audio":
        specs = {"frames": _meta((b, s, cfg.d_model), d),
                 "mask": _meta((b, s), torch.bool)}
        if with_targets:
            specs["targets"] = _meta((b, s), _I32)
            specs["target_mask"] = _meta((b, s), torch.float32)
        return specs
    if cfg.family == "vlm":
        sv = s // 4
        st = s - sv
        specs = {"tokens": _meta((b, st), _I32),
                 "patch_embeds": _meta((b, sv, cfg.d_model), d),
                 "positions": _meta((b, 3, s), _I32)}
        if with_targets:
            specs["targets"] = _meta((b, st), _I32)
        return specs
    specs = {"tokens": _meta((b, s), _I32)}
    if with_targets:
        specs["targets"] = _meta((b, s), _I32)
    return specs


def cache_specs(cfg: ModelConfig, batch: int, capacity: int) -> Tree:
    """The dense cache's leaves on ``meta``, with `models.init_cache`'s
    shapes and dtypes (the SSM state f32) — the encoder's KV slab too,
    which the reference sizes for its prefill cell."""
    shapes = cache_shapes(cfg, batch, capacity)
    d = DTYPES[cfg.dtype]
    out: dict = {"pos": _meta(shapes["pos"], _I32)}
    if "ssm" in shapes:
        out["ssm"] = type(shapes["ssm"])(*(
            _meta(shp, torch.float32 if name == "ssm" else d)
            for name, shp in zip(shapes["ssm"]._fields, shapes["ssm"])))
    for key in ("k", "v"):
        if key in shapes:
            out[key] = _meta(shapes[key], d)
    return out


def train_specs(cfg: ModelConfig, cell: ShapeCell, accum: int) -> dict:
    """A train cell's batch in `accum` microbatches (a leading [accum]
    axis when accum > 1)."""
    specs = _token_like(cfg, cell.global_batch // accum, cell.seq_len,
                        with_targets=True)
    if accum > 1:
        specs = {k: _meta((accum,) + tuple(v.shape), v.dtype)
                 for k, v in specs.items()}
    return specs


def input_specs(cfg: ModelConfig, cell: ShapeCell, data_shards: int = 16
                ) -> tuple[Tree, Tree | None, int]:
    """(batch_specs, cache_specs | None, accum) of `cell`."""
    if cell.kind == "train":
        accum, _ = microbatch_plan(cfg, cell, data_shards)
        return train_specs(cfg, cell, accum), None, accum
    if cell.kind == "prefill":
        specs = _token_like(cfg, cell.global_batch, cell.seq_len,
                            with_targets=False)
        specs["prompt_lens"] = _meta((cell.global_batch,), _I32)
        return specs, cache_specs(cfg, cell.global_batch, cell.seq_len), 1
    b = cell.global_batch
    specs = {"tokens": _meta((b, 1), _I32)}
    if cfg.m_rope:
        specs["positions"] = _meta((b, 3, 1), _I32)
    return specs, cache_specs(cfg, b, cell.seq_len), 1


__all__ = ["cache_specs", "input_specs", "train_specs"]
