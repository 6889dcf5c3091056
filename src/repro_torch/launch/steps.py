"""The shape cells' step builder — the port of `repro.launch.steps`: the
rule table of a cell (`choose_rules`), the logical axes of its batch
(`_batch_logical`), and `build_step(cfg, cell, mesh)`, the step a rank
runs with the stand-ins of its inputs and their specs.

    built = build_step(cfg, SHAPES["train_4k"], mesh)
    params, opt_state, loss = built.fn(params, opt_state, batch)

The train cell runs `training.make_train_step` under
``axis_rules(train_rules(), mesh)``: on a (dp, tp) mesh each rank holds
its blocks of every "fsdp" leaf over "data" and of every heads, FFN and
vocabulary leaf over "model", the same blocks of both AdamW moments (the
moments take the parameters' axes: ZeRO-1 comes with the ZeRO-3 weights,
as in the reference), and its data group's rows of the batch
(`draw_train_batch`: the ranks at data coordinate d draw the pipeline's
shard d); with tp > 1 the residual stream is split over its sequence on
"model" (`models.model.SeqSplit`).  The prefill and decode cells run
`prefill` / `decode_step` under the cell's rules, on the rank's blocks
(`models.shard_params`) and its cache block (`models.init_cache` under
the rules), on any (dp, tp) mesh:

  * the plain serve rules: the batch over "data", the weights and the KV
    sequence over "model";
  * the 2D weight-stationary decode (a big model's decode cell): the
    weights' "fsdp" dim over "data" too, the batch whole and the KV
    sequence over (data, model); every FC weight contracts the rank's 2D
    block in place (`models.linear`);
  * the FSDP prefill (a big model's prefill cell): the "fsdp" dim over
    "data" beside the batch; each layer's weights are gathered at its
    entry (`models.model.serve_split`);
  * `long_500k`: the batch (one row) whole, the KV sequence over (data,
    model).

The reference's `lower_step` has no counterpart: the port's cost analysis
(`dryrun`, `hlo`, `roofline`) comes with a later slice.

What raises, naming the later slice: a train cell with tp > 1 for the
MoE, SSM and hybrid families (the experts and the Mamba2 heads over
"model"), and with dp > 1 a MoE, SSM, hybrid or VLM model under a table
that puts its weights on "data" (`serving.engine.check_mesh`).

`choose_rules` switches a big model's serving to those rules when its
tensor share of the weights passes `WEIGHT_FSDP_SHARE` of a card's memory
(`hbm_bytes`, an H100's 80 GB by default): the reference's 6 GB of a
v5e's 16.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.distributed.sharding import (axis_rules, resolve_spec,
                                              serve_rules, train_rules,
                                              tree_shardings)
from repro_torch.launch.mesh import local_mesh
from repro_torch.launch.specs import input_specs, train_specs
from repro_torch.models.model import (DTYPES, TP_TRAIN_FAMILIES,
                                      cache_logical_axes, cache_shapes,
                                      decode_step, model_spec,
                                      param_logical_axes, param_shapes,
                                      prefill)
from repro_torch.serving.engine import check_mesh
from repro_torch.training.optim import AdamWConfig, AdamWState
from repro_torch.training.train_loop import make_train_step

Tree = Any

HBM_BYTES = 80e9             # one H100 80GB
# the reference's threshold as a share of a chip's memory: 6 GB of a v5e's
# 16 leaves room for deepseek-67b's 95-layer KV cache beside its weights
WEIGHT_FSDP_SHARE = 6e9 / 16e9


def param_bytes(cfg: ModelConfig) -> float:
    return cfg.param_count() * DTYPES[cfg.dtype].itemsize


def choose_rules(cfg: ModelConfig, cell: ShapeCell, mesh,
                 hbm_bytes: float = HBM_BYTES) -> dict:
    """The logical -> mesh rule table of `cell`: training always FSDP
    (weights over "data"); serving keeps the weights tensor-resident
    unless a tensor shard alone passes the threshold, then the 2D
    weight-stationary decode or the FSDP prefill."""
    multi_pod = "pod" in mesh.shape
    if cell.kind == "train":
        return train_rules(multi_pod=multi_pod, fsdp=True)
    need_fsdp = (param_bytes(cfg) / mesh.shape["model"]
                 > WEIGHT_FSDP_SHARE * hbm_bytes)
    rules = serve_rules(multi_pod=multi_pod,
                        long_context=(cell.seq_len >= 262_144))
    data = ("pod", "data") if multi_pod else "data"
    if need_fsdp and cell.kind == "decode":
        rules["fsdp"] = data
        rules["batch"] = None
        rules["act_kv_seq"] = ((data, "model") if not multi_pod
                               else ("pod", "data", "model"))
    elif need_fsdp:
        rules["fsdp"] = data
    return rules


def _batch_logical(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Logical axes of each batch leaf (a train leaf leads with its
    unsplit microbatch axis)."""
    lead = ("scan",) if cell.kind == "train" else ()

    def t(*ax):
        return lead + ax

    if cfg.family == "audio":
        common = {"frames": t("batch", "seq", None), "mask": t("batch", "seq"),
                  "targets": t("batch", "seq"),
                  "target_mask": t("batch", "seq")}
    elif cfg.family == "vlm":
        common = {"tokens": t("batch", None),
                  "patch_embeds": t("batch", None, None),
                  "positions": t("batch", None, None),
                  "targets": t("batch", None)}
    else:
        common = {"tokens": t("batch", "seq"), "targets": t("batch", "seq")}
    common["prompt_lens"] = ("batch",)
    return common


@dataclasses.dataclass
class BuiltStep:
    fn: Callable                 # runs on this rank's blocks
    args: tuple                  # the global inputs on ``meta``, in order
    in_shardings: tuple          # their spec trees under rules and mesh
    out_shardings: Any
    donate_argnums: tuple
    rules: dict
    accum: int
    kind: str


def _param_meta(cfg: ModelConfig) -> dict:
    """The params tree on ``meta``: full shapes and dtypes."""
    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict) else torch.empty(
            v.shape, dtype=DTYPES[v.dtype or cfg.dtype], device="meta"))
            for k, v in tree.items()}
    return walk(model_spec(cfg))


def _refuse(cfg: ModelConfig, cell: ShapeCell, rules: dict, mesh) -> None:
    if cell.kind == "train":
        if mesh.shape["model"] > 1 and cfg.family not in TP_TRAIN_FAMILIES:
            raise ValueError(
                f"{cell.name}: mesh {dict(mesh.shape)}: the train cell of "
                f"the {cfg.family} family with tp > 1 (the experts over "
                "\"model\" and the token dispatch across a tensor group; "
                "the Mamba2 heads over \"ssm_heads\", zamba2's shared "
                "block) comes with a later slice of the port, the next one")
        return
    check_mesh(mesh.shape, rules, cfg.family)


def build_step(cfg: ModelConfig, cell: ShapeCell, mesh=None, *,
               hbm_bytes: float = HBM_BYTES, accum: int | None = None,
               ocfg: AdamWConfig | None = None) -> BuiltStep:
    """The step of `cell` on this rank of `mesh` (None: one device).
    `accum` overrides `microbatch_plan`'s microbatches and `ocfg` the
    reference's default AdamW (the train cell only)."""
    mesh = local_mesh("cpu") if mesh is None else mesh
    rules = choose_rules(cfg, cell, mesh, hbm_bytes)
    _refuse(cfg, cell, rules, mesh)
    data_shards = mesh.shape["data"] * mesh.shape.get("pod", 1)
    batch_specs, cache_sp, plan = input_specs(cfg, cell, data_shards)
    if cell.kind == "train" and accum is not None:
        batch_specs, plan = train_specs(cfg, cell, accum), accum

    p_shapes = param_shapes(cfg)
    p_axes = param_logical_axes(cfg)
    p_shard = tree_shardings(p_axes, p_shapes, rules, mesh)
    blog = _batch_logical(cfg, cell)
    b_shard = {k: resolve_spec(blog[k], tuple(v.shape), rules, mesh)
               for k, v in batch_specs.items()}
    p_meta = _param_meta(cfg)

    if cell.kind == "train":
        ocfg = ocfg or AdamWConfig()
        opt_specs = AdamWState(
            torch.empty((), dtype=torch.int32, device="meta"),
            _f32(p_meta), _f32(p_meta))
        o_shard = AdamWState((), p_shard, p_shard)
        raw_step = make_train_step(cfg, ocfg, accum=plan, remat=True)

        def fn(params, opt_state, batch):
            with axis_rules(rules, mesh):
                new_p, new_o, _, metrics = raw_step(params, opt_state, {},
                                                    batch)
            return new_p, new_o, metrics["loss"]

        return BuiltStep(fn=fn, args=(p_meta, opt_specs, batch_specs),
                         in_shardings=(p_shard, o_shard, b_shard),
                         out_shardings=(p_shard, o_shard, ()),
                         donate_argnums=(0, 1), rules=rules, accum=plan,
                         kind="train")

    b = cell.global_batch
    c_shard = tree_shardings(cache_logical_axes(cfg),
                             cache_shapes(cfg, b, cell.seq_len), rules, mesh)
    if cell.kind == "prefill":
        def fn(params, batch, cache):
            with axis_rules(rules, mesh):
                return prefill(cfg, params, batch, cache)

        logits = resolve_spec(("batch", "vocab"), (b, cfg.vocab_size),
                              rules, mesh)
        return BuiltStep(fn=fn, args=(p_meta, batch_specs, cache_sp),
                         in_shardings=(p_shard, b_shard, c_shard),
                         out_shardings=(logits, c_shard),
                         donate_argnums=(2,), rules=rules, accum=1,
                         kind="prefill")

    def fn(params, cache, tokens, positions=None):
        with axis_rules(rules, mesh):
            return decode_step(cfg, params, cache, tokens,
                               positions=positions)

    tok = resolve_spec(("batch", None), (b, 1), rules, mesh)
    logits = resolve_spec(("batch", None, "vocab"), (b, 1, cfg.vocab_size),
                          rules, mesh)
    args = [p_meta, cache_sp, batch_specs["tokens"]]
    in_sh = [p_shard, c_shard, tok]
    if "positions" in batch_specs:
        args.append(batch_specs["positions"])
        in_sh.append(resolve_spec(("batch", None, None), (b, 3, 1), rules,
                                  mesh))
    return BuiltStep(fn=fn, args=tuple(args), in_shardings=tuple(in_sh),
                     out_shardings=(logits, c_shard), donate_argnums=(1,),
                     rules=rules, accum=1, kind="decode")


def _f32(tree: dict) -> dict:
    return {k: (_f32(v) if isinstance(v, dict) else torch.empty(
        v.shape, dtype=torch.float32, device="meta")) for k, v in tree.items()}


def draw_train_batch(cfg: ModelConfig, cell: ShapeCell, step: int, *,
                     accum: int = 1, seed: int = 0, shards: int = 1,
                     shard: int = 0) -> dict:
    """Shard `shard`'s rows of the train cell's batch at `step` (numpy):
    ``make_batch`` with the pipeline's ``num_shards`` / ``shard``, with a
    leading [accum] axis when the step accumulates.  On a (dp, tp) mesh
    the tp ranks of data group d all draw shard d of dp (the data
    coordinate, not the rank), and global microbatch i is every shard's
    microbatch i, in shard order."""
    raw = make_batch(cfg, DataConfig(seed=seed, batch=cell.global_batch,
                                     seq_len=cell.seq_len, num_shards=shards,
                                     shard=shard), step)
    if accum == 1:
        return raw
    return {k: np.ascontiguousarray(v.reshape(
        (accum, v.shape[0] // accum) + v.shape[1:])) for k, v in raw.items()}


__all__ = ["HBM_BYTES", "WEIGHT_FSDP_SHARE", "BuiltStep", "build_step",
           "choose_rules", "draw_train_batch", "param_bytes"]
