"""Rank bodies of the tensor-split training tests
(`tests/test_torch_mesh_train_tp.py`), run by
`repro_torch.launch.mesh.spawn_world` in spawned processes: this module
imports torch, the port and the data-axis rank helpers
(`_mesh_train_ranks.py`) only, never jax, so a rank starts in a second.

One world of 4 CPU ranks holds every case: a (2, 2) mesh over all of
them, two (1, 2) meshes side by side (ranks 0-1 and 2-3) that share the
(1, 2) cases between them, the same world as one (1, 4) mesh, and, for
the checkpoints, a (4, 1) mesh and two (2, 1) meshes.  The parent runs the
one-device steps (`one_device`) while the world runs.

The weights are the port's `init_params` from seed 0; each train case
runs `STEPS` steps of `launch.steps.build_step`'s train cell on the
rank's blocks and its data group's rows of a global batch that the
pipeline draws as one shard per data group."""
from __future__ import annotations

import dataclasses

import torch

import _mesh_train_ranks as T
from repro_torch.configs import ShapeCell, get_config
from repro_torch.data import to_device
from repro_torch.distributed.sharding import axis_rules
from repro_torch.launch.mesh import local_mesh, make_serving_mesh
from repro_torch.launch.steps import build_step
from repro_torch.models import forward_train, init_params, shard_params
from repro_torch.models.model import (collectives_per_train_step,
                                      param_shardings)
from repro_torch.models.weights import unshard_params
from repro_torch.training import AdamWConfig, AdamWState, init_adamw
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.tree import leaves, unflatten

STEPS, MORE = 3, 2
# eps 1e-6, as the card's phase 7f: Adam's first update of an element is
# lr * g / (|g| + eps), which for |g| near 1e-8 turns on the gradient's
# last bits, and a tensor split sums the products in another order
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-6)
MAIN = "qwen2-0.5b-smoke"
ARCHES = ("qwen2-0.5b-smoke", "qwen2-vl-7b-smoke", "hubert-xlarge-smoke")
CELLS = {arch: ShapeCell(arch.split("-")[0], 32, 8, "train")
         for arch in ARCHES}
# the qwen2 twin with 6 heads, an FFN of 254 and a vocabulary of 254: at
# tp = 4 each stays whole (filter_spec_for_shape), as the full
# qwen2-0.5b's 14 heads do
WHOLE = "qwen2-0.5b-smoke-whole-banks"
# 30 positions: tp = 4 does not divide them, so the residual stays whole
ODD = ShapeCell("odd_seq", 30, 8, "train")
# the (1, 4) cases: (arch, accum, cell)
TP4 = ((MAIN, 1, CELLS[MAIN]), (MAIN, 2, CELLS[MAIN]), (MAIN, 1, ODD),
       (WHOLE, 1, CELLS[MAIN]))
REFUSED = ("olmoe-1b-7b-smoke", "mamba2-1.3b-smoke", "zamba2-1.2b-smoke")
# the two new collectives: a [2, 4 * tp, 3] tensor's blocks of dim 1
COLL_SHAPE = (2, 4, 3)


def config(arch: str):
    if arch == WHOLE:
        return dataclasses.replace(get_config(MAIN), name=WHOLE,
                                   num_heads=6, d_ff=254, vocab_size=254)
    return get_config(arch)


def case_key(shape: tuple, arch: str, accum: int, cell: ShapeCell) -> tuple:
    return shape, arch, accum, cell.seq_len


def train(arch: str, accum: int, mesh, device, *, cell: ShapeCell,
          shards: int | None = None, steps: int = STEPS, start: int = 0,
          state=None, grads: bool = False, save=None) -> dict:
    """`steps` train steps of `arch` on this rank of `mesh` (None: one
    device) from seed-0 weights, or from `state` = (params, opt_state),
    this rank's blocks.  Returns the losses, the collectives the steps
    ran beside `collectives_per_train_step`'s reckoning, the blocks' shapes,
    the gathered parameters and first moments, and with `grads` the
    first step's gathered gradients.  `save` = (directory, step): a
    checkpoint over the mesh after that many steps."""
    cfg = config(arch)
    shards = shards or (1 if mesh is None else mesh.shape["data"])
    built = build_step(cfg, cell, mesh, accum=accum,
                       ocfg=AdamWConfig(**OPT))
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
        return to_device(T.rank_rows(T.global_batch(cfg, cell, accum, step,
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
        out["grads"] = T._numpy(unshard_params(cfg, g, rules, mesh))
    losses, count = [], 0
    ck = None if save is None else CheckpointManager(save[0])
    for step in range(start, start + steps):
        before = mesh.collectives
        params, opt, loss = built.fn(params, opt, batch(step))
        count += mesh.collectives - before
        losses.append(float(loss))
        if ck is not None and step + 1 == save[1]:
            ck.save(step + 1, {"params": params, "opt": opt},
                    shardings={"params": specs,
                               "opt": AdamWState((), specs, specs)},
                    mesh=mesh)
    out["losses"] = losses
    out["collectives"] = count
    with axis_rules(rules, mesh):
        out["reckoned"] = steps * collectives_per_train_step(
            cfg, accum, seq_len=cell.seq_len)
    out["shapes"] = {"params": T._shapes(params), "m": T._shapes(opt.m),
                     "v": T._shapes(opt.v)}
    out["params"] = T._numpy(unshard_params(cfg, params, rules, mesh))
    out["m"] = T._numpy(unshard_params(cfg, opt.m, rules, mesh))
    out["state"] = (params, opt)
    return out


def restore(arch: str, directory: str, step: int, mesh, device) -> tuple:
    """(params, opt_state): this rank's blocks of checkpoint `step` under
    the train rules on `mesh` (None: one device)."""
    cfg = config(arch)
    mesh = mesh or local_mesh(device)
    built = build_step(cfg, CELLS[arch], mesh)
    specs = param_shardings(cfg, built.rules, mesh)
    p_meta, o_meta, _ = built.args
    got = CheckpointManager(directory).restore(
        step, {"params": p_meta, "opt": o_meta}, device,
        shardings={"params": specs, "opt": AdamWState((), specs, specs)},
        mesh=mesh)
    return got["params"], got["opt"]


def coll_tensor(seed: int, tp: int) -> torch.Tensor:
    """The seeded [2, 4 * tp, 3] f32 tensor of a collective check."""
    b, n, d = COLL_SHAPE
    return torch.randn((b, n * tp, d),
                       generator=torch.Generator().manual_seed(seed))


def collectives(mesh) -> dict:
    """`seq_gather` and `seq_scatter` over "model" on this rank's tensors
    (seeded by its model coordinate) and their backwards under seeded
    upstream gradients; the parent holds them to `torch.cat` and the sum
    of the ranks' tensors."""
    tp, r = mesh.shape["model"], mesh.coords["model"]
    n = COLL_SHAPE[1]
    x = coll_tensor(0, tp).narrow(1, r * n, n).clone().requires_grad_(True)
    before = mesh.collectives
    y = mesh.seq_gather(x, "model")
    (gx,) = torch.autograd.grad(y, x, coll_tensor(100 + r, tp))
    p = coll_tensor(200 + r, tp).requires_grad_(True)
    z = mesh.seq_scatter(p, "model")
    up = coll_tensor(300 + r, tp).narrow(1, r * n, n)
    (gp,) = torch.autograd.grad(z, p, up)
    return {"tp": tp, "rank": r, "gathered": y.detach(), "gather_grad": gx,
            "scattered": z.detach(), "scatter_grad": gp,
            "count": mesh.collectives - before}


def _result(out: dict, lead: bool) -> dict:
    """What a rank sends back: everything but the live state, and the
    gathered trees from a mesh's first rank only."""
    out = {k: v for k, v in out.items() if k != "state"}
    if not lead:
        for key in ("params", "m", "grads"):
            out.pop(key, None)
    return out


def world(rank: int, device, ckpt22: str, ckpt21: str) -> dict:
    """Every case on a world of 4 ranks (module docstring)."""
    mesh22 = make_serving_mesh(2, 2, device=device)
    mesh12 = make_serving_mesh(1, 2, device=device)
    mesh14 = make_serving_mesh(1, 4, device=device)
    mesh41 = make_serving_mesh(4, 1, device=device)
    mesh21 = make_serving_mesh(2, 1, device=device)
    pair = rank // 2
    res = {"coords": {"22": dict(mesh22.coords), "12": dict(mesh12.coords),
                      "14": dict(mesh14.coords), "41": dict(mesh41.coords)},
           "collectives": [collectives(mesh12), collectives(mesh14)],
           "cases": {}}
    for arch in ARCHES:
        for accum in (1, 2):
            # qwen2 at accum 1: the uninterrupted run, a checkpoint after
            # STEPS steps
            main = arch == MAIN and accum == 1
            out = train(arch, accum, mesh22, device, cell=CELLS[arch],
                        grads=(accum == 1),
                        steps=STEPS + MORE if main else STEPS,
                        save=(ckpt22, STEPS) if main else None)
            res["cases"][case_key((2, 2), arch, accum, CELLS[arch])] = \
                _result(out, rank == 0)
    # the (1, 2) cases: accum 1 on ranks 0-1, accum 2 on ranks 2-3
    accum = 1 + pair
    for arch in ARCHES:
        out = train(arch, accum, mesh12, device, cell=CELLS[arch],
                    grads=(accum == 1))
        res["cases"][case_key((1, 2), arch, accum, CELLS[arch])] = \
            _result(out, mesh12.rank == 0)
    for arch, accum, cell in TP4:
        out = train(arch, accum, mesh14, device, cell=cell,
                    grads=(accum == 1))
        res["cases"][case_key((1, 4), arch, accum, cell)] = \
            _result(out, rank == 0)
    if pair == 0:
        # the (2, 1) run, a checkpoint after STEPS steps
        out = train(MAIN, 1, mesh21, device, cell=CELLS[MAIN],
                    steps=STEPS + MORE, save=(ckpt21, STEPS))
        res["uninterrupted21"] = _result(out, rank == 0)
    mesh41.barrier()
    # the (2, 2) checkpoint onto (4, 1) and onto one device, the (2, 1)
    # one onto (2, 2): the same global batches (2 pipeline shards) on
    cell = CELLS[MAIN]
    state = restore(MAIN, ckpt22, STEPS, mesh41, device)
    res["restored41"] = {"params": T._shapes(state[0]),
                         "m": T._shapes(state[1].m)}
    out = train(MAIN, 1, mesh41, device, cell=cell, shards=2, steps=MORE,
                start=STEPS, state=state)
    res["resumed41"] = _result(out, rank == 0)
    state = restore(MAIN, ckpt21, STEPS, mesh22, device)
    res["restored22"] = {"params": T._shapes(state[0]),
                         "m": T._shapes(state[1].m)}
    out = train(MAIN, 1, mesh22, device, cell=cell, steps=MORE, start=STEPS,
                state=state)
    res["resumed22"] = _result(out, rank == 0)
    if rank == 0:
        state = restore(MAIN, ckpt22, STEPS, None, device)
        out = train(MAIN, 1, None, device, cell=cell, shards=2, steps=MORE,
                    start=STEPS, state=state)
        res["resumed1"] = _result(out, True)
    return res


def one_device(arch: str, accum: int, shards: int, cell: ShapeCell,
               steps: int = STEPS) -> dict:
    """The one-device step on the same global batches (the parent's)."""
    out = train(arch, accum, None, "cpu", cell=cell, shards=shards,
                grads=(accum == 1), steps=steps)
    return _result(out, True)
