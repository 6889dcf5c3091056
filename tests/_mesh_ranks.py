"""Rank bodies of the mesh tests (`tests/test_torch_mesh.py`), run by
`repro_torch.launch.mesh.spawn_world` in spawned processes: this module
imports torch and the port only, never jax, so a rank starts in a second.

Each body gets the reference's weights as a numpy tree (the parent made
them with jax), builds the port's qwen2 smoke twin from them, runs its
cases on this rank's block and returns plain Python results for the parent
to compare."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.distributed.sharding import (axis_rules, local_block,
                                              serve_rules)
from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                  decode_attention_sharded)
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention_ref, paged_decode_attention_sharded)
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import fc_variant, params_from_jax
from repro_torch.models import model as model_mod
from repro_torch.models.layers import decode_attention_xla
from repro_torch.models.linear import papi_linear, papi_linear_group
from repro_torch.serving import PapiEngine, ServeRequest

ARCH = "qwen2-0.5b-smoke"
ENGINE = dict(max_slots=4, cache_capacity=64, prefill_len=8, alpha=6.0,
              eos_token=1, debug_invariants=True)
# tests/test_serving_sharded.py's requests
REQS = [([3 + i, 5, 7, 11], 4 + 3 * i) for i in range(6)]


def long_requests() -> list:
    """Prompts past the 8-token prefill window (chunked admission)."""
    rng = np.random.default_rng(0)
    return [(rng.integers(3, 256, size=n).tolist(), 3 + 2 * i)
            for i, n in enumerate([20, 5, 31, 12, 9, 17])]


# name -> (engine keywords, requests, drive through serve())
CASES = {
    "dense": (dict(), "short", False),
    "attn_pim": (dict(attn_pim=True), "short", False),
    "paged": (dict(kv_layout="paged", page_size=8), "short", False),
    "spec": (dict(spec_len=3), "short3", False),
    "chunked_paged": (dict(kv_layout="paged", page_size=8), "long", False),
    "serve": (dict(), "long", True),
    "flip": (dict(alpha=3.0), "short", False),
}


# the other mesh families' smoke twins (seeded port weights): the untied
# head splits lm_head over the vocabulary, the VLM backbone rotates M-RoPE
FAMILIES = ("deepseek-67b-smoke", "qwen2-vl-7b-smoke")


def case_requests(kind: str) -> list:
    return {"short": REQS, "short3": REQS[:3],
            "long": long_requests()}[kind]


def run_engine(cfg, params, name: str, device="cpu", mesh=None,
               draft=None) -> dict:
    """One case on an engine (a mesh rank's or one device's): the streams,
    each iteration's FC variant and host transfers."""
    kw, kind, live = CASES[name]
    if name == "spec":
        kw = dict(kw, draft=draft)
    eng = PapiEngine(cfg, params, mesh=mesh, device=device,
                     **{**ENGINE, **kw})
    reqs = [ServeRequest(i, p, n) for i, (p, n) in enumerate(
        case_requests(kind))]
    if live:
        sched = [[r] for r in reqs]
        results = [ev.result for ev in eng.serve(sched, max_iterations=300)
                   if ev.finished]
    else:
        for r in reqs:
            eng.submit(r)
        results = eng.run(max_iterations=300)
    return {"streams": {r.req_id: (list(r.tokens), r.finished_reason)
                        for r in results},
            "fc": [s.fc_variant for s in eng.stats],
            "transfers": [s.transfers for s in eng.stats]}


def family_run(arch: str, device="cpu", mesh=None) -> dict:
    """A family twin's attn_pim run on REQS, weights from seed 0."""
    from repro_torch.models import init_params
    cfg = get_config(arch)
    eng = PapiEngine(cfg, init_params(cfg, _gen(0)), mesh=mesh,
                     device=device, attn_pim=True, **ENGINE)
    for i, (p, n) in enumerate(REQS):
        eng.submit(ServeRequest(i, p, n))
    results = eng.run(max_iterations=300)
    return {"streams": {r.req_id: (list(r.tokens), r.finished_reason)
                        for r in results},
            "fc": [s.fc_variant for s in eng.stats],
            "head": tuple(eng.params.get("lm_head", eng.params["embed"])
                          ["w"].shape)}


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def bank_checks(mesh, tp: int) -> dict:
    """Column and row FC banks ("pu" and "pim") on this rank's block
    against the unsharded product: the column outputs are gathered."""
    g = _gen(1)
    x = torch.randn(5, 64, generator=g)
    w = torch.randn(64, 96, generator=g) / 8
    want = x @ w
    rules = serve_rules()
    out = {}
    with axis_rules(rules, mesh):
        for variant in ("pu", "pim"):
            with fc_variant(variant):
                wc = local_block(w, (None, "model"), mesh)
                col = papi_linear_group(x, [wc], tp="col", units=96)[0]
                col = mesh.all_gather(col, dim=1)
                wr = local_block(w, ("model", None), mesh)
                xr = local_block(x, (None, "model"), mesh)
                row = papi_linear(xr, wr, tp="row", units=64)
            out[f"col_{variant}"] = float((col - want).abs().max())
            out[f"row_{variant}"] = float((row - want).abs().max())
            out[f"col_shape_{variant}"] = tuple(wc.shape)
            out[f"row_shape_{variant}"] = tuple(wr.shape)
    return out


def attention_checks(mesh, tp: int) -> dict:
    """Both sharded Attn-PIM wrappers against the unsharded plain versions
    (8 KV heads split, 2 KV heads: split at tp 2, the whole-tensor
    fallback at tp 4), windows t = 1 and 3, and the sequence-split merge
    against the plain decode attention."""
    out = {}
    for nkv in (8, 2):
        g = _gen(nkv)
        b, grp, hd, S, t = 3, 2, 32, 64, 3
        for rows in (1, t):
            q = torch.randn(b, nkv, rows * grp, hd, generator=g)
            k = torch.randn(b, S, nkv, hd, generator=g)
            v = torch.randn(b, S, nkv, hd, generator=g)
            lens = torch.tensor([5, 64, 33], dtype=torch.int32)
            split = nkv % tp == 0
            spec = "model" if split else None
            ql = local_block(q, (None, spec), mesh)
            kl = local_block(k, (None, None, spec), mesh)
            vl = local_block(v, (None, None, spec), mesh)
            got = decode_attention_sharded(ql, kl, vl, lens, mesh=mesh,
                                           heads=nkv, q_rows=rows)
            if split:
                got = mesh.all_gather(got, dim=1)
            want = decode_attention_ref(q, k, v, lens, rows)
            out[f"dense_nkv{nkv}_t{rows}"] = (
                float((got - want).abs().max()), tuple(kl.shape))
            page = 8
            kp = k.reshape(b * S // page, page, nkv, hd)
            vp = v.reshape(b * S // page, page, nkv, hd)
            tables = torch.arange(b * S // page, dtype=torch.int32).reshape(
                b, S // page).flip(1).contiguous()
            kpl = local_block(kp, (None, None, spec), mesh)
            vpl = local_block(vp, (None, None, spec), mesh)
            got = paged_decode_attention_sharded(ql, kpl, vpl, lens, tables,
                                                 mesh=mesh, heads=nkv,
                                                 q_rows=rows)
            if split:
                got = mesh.all_gather(got, dim=1)
            want = paged_decode_attention_ref(q, kp, vp, lens, tables, rows)
            out[f"paged_nkv{nkv}_t{rows}"] = (
                float((got - want).abs().max()), tuple(kpl.shape))
    # the sequence-split slab's merge, q at global positions
    g = _gen(7)
    b, t, nh, nkv, hd, S = 3, 2, 4, 2, 32, 64
    q = torch.randn(b, t, nh, hd, generator=g)
    k = torch.randn(b, S, nkv, hd, generator=g)
    v = torch.randn(b, S, nkv, hd, generator=g)
    pos = torch.tensor([3, 40, 62], dtype=torch.int32)
    span = S // tp
    lo = mesh.coords["model"] * span
    sp = model_mod.HeadSplit(mesh, "model", nh, 0, nh, False, nh // nkv)
    got = model_mod._seq_split_attention(q, k[:, lo:lo + span],
                                         v[:, lo:lo + span], pos,
                                         (lo, S), sp)
    want = decode_attention_xla(q, k, v, cache_len=pos + t, q_offset=pos)
    out["seq_merge"] = float((got - want).abs().max())
    return out


def footprint(eng) -> dict:
    """Shapes of the rank's leaves that the rules split (params, cache)."""
    lay = eng.params["layers"]
    return {"w_q": tuple(lay["attn"]["w_q"].shape),
            "w_o": tuple(lay["attn"]["w_o"].shape),
            "w_k": tuple(lay["attn"]["w_k"].shape),
            "w_gate": tuple(lay["mlp"]["w_gate"].shape),
            "w_down": tuple(lay["mlp"]["w_down"].shape),
            "embed": tuple(eng.params["embed"]["w"].shape),
            "k": tuple(eng.cache["k"].shape),
            "kv_seq": eng.cache.get("kv_seq")}


def mesh_world(rank: int, device, tp: int, tree: dict, draft_tree: dict,
               cases: list) -> dict:
    """The whole world's work of one test module: the kernel and bank
    checks, the layouts, then every engine case."""
    mesh = make_serving_mesh(1, tp, device=device)
    cfg = get_config(ARCH)
    params = params_from_jax(cfg, tree, device)
    draft = (cfg, params_from_jax(cfg, draft_tree, device))
    out = {"banks": bank_checks(mesh, tp),
           "attention": attention_checks(mesh, tp), "layout": {}}
    for name, kw in (("dense", {}), ("attn_pim", dict(attn_pim=True)),
                     ("paged", dict(kv_layout="paged", page_size=8))):
        eng = PapiEngine(cfg, params, mesh=mesh, device=device,
                         **{**ENGINE, **kw})
        out["layout"][name] = footprint(eng)
    out["engine"] = {name: run_engine(cfg, params, name, device, mesh, draft)
                     for name in cases}
    out["families"] = {arch: family_run(arch, device, mesh)
                       for arch in FAMILIES}
    out["collectives"] = mesh.collectives
    return out
