"""Rank bodies of the data-axis training tests
(`tests/test_torch_mesh_train.py`), run by
`repro_torch.launch.mesh.spawn_world` in spawned processes: this module
imports torch and the port only, never jax, so a rank starts in a second.

One world of 4 CPU ranks holds every case: a (4, 1) mesh over all of
them, and two (2, 1) meshes side by side (ranks 0-1 and 2-3) that share
the (2, 1) cases between them.  The parent runs the one-device steps
(`one_device`) and the reference's while the world runs.

The weights are the port's `init_params` from seed 0; each train case
runs `STEPS` steps of `launch.steps.build_step`'s train cell on the
rank's blocks and its rows of a global batch that the pipeline draws as
`shards` shards (rank r of a (dp, 1) mesh draws shard r itself)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import ShapeCell, get_config
from repro_torch.data import to_device
from repro_torch.distributed.sharding import axis_rules, local_block
from repro_torch.launch.mesh import local_mesh, make_serving_mesh
from repro_torch.launch.steps import build_step, draw_train_batch
from repro_torch.models import forward_train, init_params, shard_params
from repro_torch.models.model import (collectives_per_train_step,
                                      param_shardings)
from repro_torch.models.weights import unshard_params
from repro_torch.training import AdamWConfig, AdamWState, init_adamw
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.tree import flatten, leaves, unflatten

STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
# a train cell per family: global batch and sequence; olmoe's keeps each
# rank's microbatch a whole MoE group (1024 tokens) at (4, 1), accum 2
CELLS = {
    "qwen2-0.5b-smoke": ShapeCell("dense", 32, 8, "train"),
    "olmoe-1b-7b-smoke": ShapeCell("moe", 64, 128, "train"),
    "mamba2-1.3b-smoke": ShapeCell("ssm", 64, 8, "train"),
    "zamba2-1.2b-smoke": ShapeCell("hybrid", 64, 8, "train"),
    "hubert-xlarge-smoke": ShapeCell("audio", 32, 8, "train"),
    "qwen2-vl-7b-smoke": ShapeCell("vlm", 32, 8, "train"),
}
ARCHES = tuple(CELLS)
# a rank of a (2, 1) mesh holds 128 tokens: half of the one MoE group
SMALL_MOE = ShapeCell("moe_small", 32, 8, "train")
MAIN = "qwen2-0.5b-smoke"
RESUME_AT, RESUME_STEPS = 3, 2


def global_batch(cfg, cell: ShapeCell, accum: int, step: int,
                 shards: int) -> dict:
    """The global batch of `step`: every pipeline shard's draw, microbatch
    i of each concatenated in shard order."""
    parts = [draw_train_batch(cfg, cell, step, accum=accum, shards=shards,
                              shard=r) for r in range(shards)]
    axis = 1 if accum > 1 else 0
    return {k: np.concatenate([p[k] for p in parts], axis=axis)
            for k in parts[0]}


def rank_rows(batch: dict, accum: int, mesh) -> dict:
    """This rank's rows of a global batch (its data coordinate's block)."""
    lead = (None,) if accum > 1 else ()
    spec = lead + ("data",)
    return {k: local_block(torch.from_numpy(v), spec, mesh).numpy()
            for k, v in batch.items()}


def _numpy(tree) -> dict:
    return {k: v.detach().float().numpy().copy() for k, v in flatten(tree)}


def _shapes(tree) -> dict:
    return {k: tuple(v.shape) for k, v in flatten(tree)}


def train(arch: str, accum: int, mesh, device, *, shards: int | None = None,
          steps: int = STEPS, start: int = 0, ocfg=None, state=None,
          grads: bool = False, keep: bool = True, save=None,
          cell: ShapeCell | None = None) -> dict:
    """`steps` train steps of `arch` on this rank of `mesh` (None: one
    device) from seed-0 weights, or from `state` = (params, opt_state),
    this rank's blocks.  Returns the losses, the collectives the mesh ran,
    the blocks' shapes, and with `keep` the gathered parameters (and with
    `grads` the first step's gathered gradients).  `save` = (directory,
    step): a checkpoint over the mesh after that many steps."""
    cfg = get_config(arch)
    cell = cell or CELLS[arch]
    shards = shards or (1 if mesh is None else mesh.shape["data"])
    ocfg = AdamWConfig(**OPT) if ocfg is None else ocfg
    built = build_step(cfg, cell, mesh, accum=accum, ocfg=ocfg)
    mesh = mesh or local_mesh(device)
    rules = built.rules
    specs = param_shardings(cfg, rules, mesh)
    if state is None:
        full = init_params(cfg, torch.Generator().manual_seed(0))
        params = shard_params(cfg, full, rules, mesh)
        opt = init_adamw(params)
    else:
        params, opt = state
    out = {}

    def batch(step):
        return to_device(rank_rows(global_batch(cfg, cell, accum, step,
                                                shards), accum, mesh),
                         device)

    if grads:
        b0 = batch(start)
        if accum > 1:
            b0 = {k: v[0] for k, v in b0.items()}
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
        with axis_rules(rules, mesh):
            loss = forward_train(cfg, params, b0)[0]
        g = unflatten(params, list(torch.autograd.grad(loss, ps)))
        for p in ps:
            p.requires_grad_(False)
        out["grads"] = _numpy(unshard_params(cfg, g, rules, mesh))
    before = mesh.collectives
    losses = []
    ck = None if save is None else CheckpointManager(save[0])
    for step in range(start, start + steps):
        params, opt, loss = built.fn(params, opt, batch(step))
        losses.append(float(loss))
        if ck is not None and step + 1 == save[1]:
            ck.save(step + 1, {"params": params, "opt": opt},
                    shardings={"params": specs,
                               "opt": AdamWState((), specs, specs)},
                    mesh=mesh)
    out["losses"] = losses
    out["collectives"] = mesh.collectives - before
    with axis_rules(rules, mesh):
        out["reckoned"] = steps * collectives_per_train_step(cfg, accum)
    out["shapes"] = {"params": _shapes(params), "m": _shapes(opt.m),
                     "v": _shapes(opt.v)}
    if keep:
        out["params"] = _numpy(unshard_params(cfg, params, rules, mesh))
        out["m"] = _numpy(unshard_params(cfg, opt.m, rules, mesh))
    out["state"] = (params, opt)
    return out


def restore(arch: str, directory: str, step: int, mesh, device) -> tuple:
    """(params, opt_state): this rank's blocks of checkpoint `step` under
    the train rules on `mesh` (None: one device)."""
    cfg = get_config(arch)
    mesh = mesh or local_mesh(device)
    built = build_step(cfg, CELLS[arch], mesh)
    specs = param_shardings(cfg, built.rules, mesh)
    p_meta, o_meta, _ = built.args
    got = CheckpointManager(directory).restore(
        step, {"params": p_meta, "opt": o_meta}, device,
        shardings={"params": specs, "opt": AdamWState((), specs, specs)},
        mesh=mesh)
    return got["params"], got["opt"]


def _result(out: dict, rank0: bool) -> dict:
    """What a rank sends back: everything but the live state, and the
    gathered trees from a mesh's rank 0 only."""
    out = {k: v for k, v in out.items() if k != "state"}
    if not rank0:
        for key in ("params", "m", "grads"):
            out.pop(key, None)
    return out


def world(rank: int, device, ckpt_dir: str, ref_dir: str) -> dict:
    """Every case on a world of 4 ranks (module docstring)."""
    mesh4 = make_serving_mesh(4, 1, device=device)
    mesh2 = make_serving_mesh(2, 1, device=device)
    replica = rank // 2
    lead2 = mesh2.rank == 0
    res = {"coords4": mesh4.coords, "coords2": mesh2.coords, "cases": {}}
    for arch in ARCHES:
        for accum in (1, 2):
            out = train(arch, accum, mesh4, device, grads=(accum == 1),
                        keep=True)
            res["cases"][(4, arch, accum)] = _result(out, rank == 0)
    # the (2, 1) cases, shared by the two replicas: accum 1 on ranks 0-1,
    # accum 2 on ranks 2-3
    accum = 1 + replica
    for arch in ARCHES:
        out = train(arch, accum, mesh2, device, grads=(accum == 1))
        res["cases"][(2, arch, accum)] = _result(out, lead2)
    if replica == 0:
        try:
            train("olmoe-1b-7b-smoke", 1, mesh2, device, keep=False,
                  cell=SMALL_MOE)
            res["small_moe"] = "ran"
        except ValueError as e:
            res["small_moe"] = str(e)
        # the uninterrupted run, a checkpoint over the mesh after
        # RESUME_AT steps
        out = train(MAIN, 1, mesh2, device, steps=RESUME_AT + RESUME_STEPS,
                    save=(ckpt_dir, RESUME_AT))
        res["uninterrupted"] = _result(out, lead2)
    else:
        # a checkpoint the reference wrote, restored onto (2, 1), trained
        # on with the reference's default AdamW
        state = restore(MAIN, ref_dir, 0, mesh2, device)
        out = train(MAIN, 1, mesh2, device, state=state,
                    ocfg=AdamWConfig())
        res["from_reference"] = _result(out, lead2)
    mesh4.barrier()
    # elastic restore onto (4, 1) and onto one device: the same global
    # batches (2 pipeline shards) on
    state = restore(MAIN, ckpt_dir, RESUME_AT, mesh4, device)
    res["restored_shapes"] = {"params": _shapes(state[0]),
                              "m": _shapes(state[1].m)}
    out = train(MAIN, 1, mesh4, device, shards=2, steps=RESUME_STEPS,
                start=RESUME_AT, state=state)
    res["resumed4"] = _result(out, rank == 0)
    if rank == 0:
        state = restore(MAIN, ckpt_dir, RESUME_AT, None, device)
        out = train(MAIN, 1, None, device, shards=2, steps=RESUME_STEPS,
                    start=RESUME_AT, state=state)
        res["resumed1"] = _result(out, True)
    return res


def one_device(arch: str, accum: int, shards: int, **kw) -> dict:
    """The one-device step on the same global batches (the parent's)."""
    out = train(arch, accum, None, "cpu", shards=shards, grads=(accum == 1),
                **kw)
    return _result(out, True)
