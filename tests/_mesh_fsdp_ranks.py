"""Rank bodies of the tests of serving with the weights or the KV sequence
over the data axis (`tests/test_torch_mesh_fsdp_serve.py`), run by
`repro_torch.launch.mesh.spawn_world` in spawned processes: this module
imports torch and the port only, never jax, so a rank starts in a second.

One world of 4 CPU ranks holds every case: a (2, 2) mesh over all of
them, and two (2, 1) meshes side by side (ranks 0-1 and 2-3, which share
the (2, 1) cases), made by every rank in that order (`make_serving_mesh`
splits a world into meshes).  The parent runs `one_device` meanwhile.

The weights are the port's `init_params` from seed 0 (f32); caches,
prompts and tokens are drawn with numpy from fixed seeds, so every rank
and the parent hold the same whole tensors and a rank takes its block of
each.  `HBM` forces `choose_rules` onto the FSDP tables for the smoke
twins, whose weights are far below an 80 GB card's threshold."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed.sharding import (axis_rules, batch_block,
                                              local_block, serve_rules)
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.launch.steps import HBM_BYTES, build_step, choose_rules
from repro_torch.models import init_params, shard_params
from repro_torch.models.model import (cache_shardings,
                                      collectives_per_forward, decode_step,
                                      init_cache, prefill)
from repro_torch.models.weights import unshard_params
from repro_torch.serving import PapiEngine, ServeRequest

HBM = 1.0
DENSE = ("deepseek-67b-smoke", "command-r-plus-104b-smoke",
         "gpt3-175b-smoke")
SSM = ("mamba2-1.3b-smoke", "zamba2-1.2b-smoke")
MESHES = ((2, 2), (2, 1))
CELLS = {"decode": "decode_32k", "prefill": "prefill_32k"}
# the 2D decode cell: 4 rows at positions in each quarter of a 32-position
# slab, so every (data, model) slice takes a write
DECODE_POS = [3, 12, 21, 29]
DECODE_CAP, DECODE_STEPS = 32, 2
# the FSDP prefill cell: the cache holds the window, so at tp 2 a rank's
# 8-position slice is narrower than the 16-token write
PREFILL_LENS = [16, 9, 13, 5]
PREFILL_T = 16
# the long-context decode cell: a few hundred positions over (data,
# model); row 1 writes position 250, in data rank 1's slices
LONG_POS = [100, 250]
LONG_CAP, LONG_STEPS = 256, 2
ENGINE = dict(max_slots=4, cache_capacity=64, prefill_len=8, alpha=3.0,
              eos_token=1, debug_invariants=True)
# prompts past the 8-token window (chunked admission) for the dense twin;
# full 8-token windows for the SSM twins
REQS = [([3 + (7 * i + j) % 250 for j in range(n)], 3 + 2 * i)
        for i, n in enumerate([20, 5, 31, 12, 9, 17])]
SSM_REQS = [([3 + i, 5, 7, 11, 13 + i, 17, 19, 23], 4 + 3 * i)
            for i in range(6)]
# engine case -> (arch, rules maker, engine keywords, requests)
ENGINE_CASES = {
    "qwen2 2D decode": ("qwen2-0.5b-smoke", "decode_32k", {}, REQS),
    "qwen2 FSDP prefill table": ("qwen2-0.5b-smoke", "prefill_32k", {},
                                 REQS),
    "mamba2 long-context": ("mamba2-1.3b-smoke", "long", {}, SSM_REQS),
    "zamba2 long-context": ("zamba2-1.2b-smoke", "long", {}, SSM_REQS),
    "zamba2 long-context attn_pim": ("zamba2-1.2b-smoke", "long_pim",
                                     dict(attn_pim=True), SSM_REQS),
}


def params(cfg) -> dict:
    return init_params(cfg, torch.Generator().manual_seed(0))


def engine_rules(cfg, which: str, mesh) -> dict:
    if which == "long":
        return serve_rules(long_context=True)
    if which == "long_pim":
        return serve_rules(long_context=True, attn_pim=True)
    return choose_rules(cfg, SHAPES[which], mesh, hbm_bytes=HBM)


def decode_inputs(cfg, pos: list, cap: int, steps: int,
                  seed: int = 1) -> tuple[dict, list]:
    """A whole cache (KV and SSM state drawn from `seed`, every row at
    its position of `pos`) and `steps` token columns."""
    rng = np.random.default_rng(seed)
    b = len(pos)
    cache = init_cache(cfg, b, cap, "cpu")
    for key in ("k", "v"):
        if key in cache:
            cache[key] = torch.from_numpy(rng.standard_normal(
                tuple(cache[key].shape), dtype=np.float32) * 0.5)
    if "ssm" in cache:
        cache["ssm"] = type(cache["ssm"])(*(
            torch.from_numpy(rng.standard_normal(tuple(x.shape),
                                                 dtype=np.float32) * 0.1)
            for x in cache["ssm"]))
    cache["pos"] = torch.tensor(pos, dtype=torch.int32)
    tokens = [rng.integers(3, cfg.vocab_size, size=(b, 1)).astype(np.int32)
              for _ in range(steps)]
    return cache, tokens


def prefill_inputs(cfg, seed: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(3, cfg.vocab_size,
                                   size=(len(PREFILL_LENS), PREFILL_T)
                                   ).astype(np.int32),
            "prompt_lens": np.array(PREFILL_LENS, np.int32)}


def cache_numpy(cache: dict) -> dict:
    out = {"pos": cache["pos"].numpy().copy()}
    for key in ("k", "v"):
        if key in cache:
            out[key] = cache[key].numpy().copy()
    if "ssm" in cache:
        for name, x in zip(cache["ssm"]._fields, cache["ssm"]):
            out[name] = x.numpy().copy()
    return out


def rank_cache(cfg, whole: dict, cap: int, rules, mesh) -> dict:
    """This rank's block of a whole cache under `rules`."""
    b = whole["pos"].shape[0]
    with axis_rules(rules, mesh):
        cache = init_cache(cfg, b, cap, "cpu")
        lo, hi = batch_block(b)
    specs = cache_shardings(cfg, b, cap, rules, mesh)
    for key in ("k", "v"):
        if key in whole:
            cache[key].copy_(local_block(whole[key], specs[key], mesh))
    if "ssm" in whole:
        for dst, src, sp in zip(cache["ssm"], whole["ssm"], specs["ssm"]):
            dst.copy_(local_block(src, sp, mesh))
    cache["pos"] = whole["pos"][lo:hi].clone()
    return cache


def decode_cell(arch: str, cell: str, mesh, pos: list, cap: int,
                steps: int, hbm: float = HBM) -> dict:
    """`build_step`'s decode cell of `cell` on this rank (`hbm`: the
    card's bytes for `choose_rules`): its blocks of the weights and of a
    drawn cache, `steps` steps; each step's logits, the cache blocks after
    them, the weights' block shapes, the weights gathered back, the
    collectives a step ran and those reckoned."""
    cfg = get_config(arch)
    built = build_step(cfg, SHAPES[cell], mesh, hbm_bytes=hbm)
    full = params(cfg)
    p = shard_params(cfg, full, built.rules, mesh)
    whole, tokens = decode_inputs(cfg, pos, cap, steps)
    cache = rank_cache(cfg, whole, cap, built.rules, mesh)
    logits, ran = [], []
    for tok in tokens:
        n0 = mesh.collectives
        out, cache = built.fn(p, cache, torch.from_numpy(tok))
        ran.append(mesh.collectives - n0)
        logits.append(out.numpy().copy())
    with axis_rules(built.rules, mesh):
        reckoned = collectives_per_forward(cfg, cache, False)
    back = unshard_params(cfg, p, built.rules, mesh)
    return {"rules": built.rules, "logits": logits,
            "cache": cache_numpy(cache), "ran": ran, "reckoned": reckoned,
            "shapes": _shapes(p), "unsharded": _same(back, full)}


def prefill_cell(arch: str, mesh) -> dict:
    """`build_step`'s prefill cell (the FSDP prefill's table) on this
    rank: its data group's rows of the prompts, into its cache block."""
    cfg = get_config(arch)
    built = build_step(cfg, SHAPES["prefill_32k"], mesh, hbm_bytes=HBM)
    p = shard_params(cfg, params(cfg), built.rules, mesh)
    batch = prefill_inputs(cfg)
    n = len(PREFILL_LENS)
    with axis_rules(built.rules, mesh):
        lo, hi = batch_block(n)
        cache = init_cache(cfg, n, PREFILL_T, "cpu")
    n0 = mesh.collectives
    out, cache = built.fn(p, {k: torch.from_numpy(v[lo:hi])
                              for k, v in batch.items()}, cache)
    ran = mesh.collectives - n0
    # a prefill attends over the window's own KV: no sequence-split merge
    window = {k: v for k, v in cache.items() if k != "kv_seq"}
    with axis_rules(built.rules, mesh):
        reckoned = collectives_per_forward(cfg, window, False)
    return {"rules": built.rules, "rows": (lo, hi),
            "logits": out.numpy().copy(), "cache": cache_numpy(cache),
            "ran": ran, "reckoned": reckoned, "shapes": _shapes(p)}


def _shapes(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_shapes(v, key) if isinstance(v, dict)
                   else {key: tuple(v.shape)})
    return out


def _same(a: dict, b: dict) -> bool:
    return all(_same(a[k], b[k]) if isinstance(b[k], dict)
               else torch.equal(a[k], b[k]) for k in b)


def serve(arch: str, rules, device, mesh=None, **kw) -> dict:
    """The engine case's streams and FC variant per iteration."""
    cfg = get_config(arch)
    eng = PapiEngine(cfg, params(cfg), mesh=mesh, rules=rules,
                     device=device, **{**ENGINE, **kw["engine"]})
    for i, (p, n) in enumerate(kw["reqs"]):
        eng.submit(ServeRequest(i, p, n))
    results = eng.run(max_iterations=300)
    return {"streams": {r.req_id: (list(r.tokens), r.finished_reason)
                        for r in results},
            "fc": [s.fc_variant for s in eng.stats],
            "data_split": eng._data_split,
            "kv": tuple(eng.cache["k"].shape) if "k" in eng.cache else None}


def world(rank: int, device) -> dict:
    """Every case on this rank: the (2, 2) mesh's, then its (2, 1)
    mesh's share."""
    torch.set_num_threads(1)
    meshes = {shape: make_serving_mesh(*shape, device=device)
              for shape in MESHES}
    out: dict = {}
    for shape, mesh in meshes.items():
        share = DENSE if shape == (2, 2) else DENSE[rank // 2::2]
        for arch in share:
            out[shape, arch, "decode"] = decode_cell(
                arch, CELLS["decode"], mesh, DECODE_POS, DECODE_CAP,
                DECODE_STEPS)
            out[shape, arch, "prefill"] = prefill_cell(arch, mesh)
        out[shape, "coords"] = dict(mesh.coords)
    mesh = meshes[2, 2]
    for arch in SSM:
        out["long", arch] = decode_cell(arch, "long_500k", mesh, LONG_POS,
                                        LONG_CAP, LONG_STEPS, HBM_BYTES)
    for name, (arch, which, kw, reqs) in ENGINE_CASES.items():
        rules = engine_rules(get_config(arch), which, mesh)
        out["engine", name] = serve(arch, rules, device, mesh, engine=kw,
                                    reqs=reqs)
    return out


def one_device(cell: str, arch: str) -> dict:
    """The one-device counterpart of a case (no mesh)."""
    cfg = get_config(arch)
    full = params(cfg)
    if cell == "prefill":
        batch = {k: torch.from_numpy(v)
                 for k, v in prefill_inputs(cfg).items()}
        cache = init_cache(cfg, len(PREFILL_LENS), PREFILL_T, "cpu")
        out, cache = prefill(cfg, full, batch, cache)
        return {"logits": out.numpy(), "cache": cache_numpy(cache)}
    if cell in ENGINE_CASES:
        _, _, kw, reqs = ENGINE_CASES[cell]
        return serve(arch, None, "cpu", engine=kw, reqs=reqs)
    pos, cap, steps = ((LONG_POS, LONG_CAP, LONG_STEPS) if cell == "long"
                       else (DECODE_POS, DECODE_CAP, DECODE_STEPS))
    cache, tokens = decode_inputs(cfg, pos, cap, steps)
    logits = []
    for tok in tokens:
        out, cache = decode_step(cfg, full, cache, torch.from_numpy(tok))
        logits.append(out.numpy())
    return {"logits": logits, "cache": cache_numpy(cache)}
