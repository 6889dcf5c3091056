"""Rank bodies of the data-axis mesh tests (`tests/test_torch_mesh_data.py`),
run by `repro_torch.launch.mesh.spawn_world` in spawned processes: this
module imports torch and the port only, never jax, so a rank starts in a
second.

Each body gets the reference's weights as numpy trees (the parent made
them with jax), runs its cases on this rank's data group and returns
plain Python results for the parent to compare with the one-device
engines."""
from __future__ import annotations

import _mesh_ranks as R
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import params_from_jax
from repro_torch.serving import PapiEngine, ServeRequest

# the families the data axis serves at tp = 1 beside the dense decoder
FAMILIES = ("mamba2-1.3b-smoke", "zamba2-1.2b-smoke", "olmoe-1b-7b-smoke")
# full prefill windows (ENGINE's 8 tokens): the reference pushes a shorter
# prompt's padding through the SSM state (ROADMAP queue 3), so only an
# unpadded prompt makes its engine an oracle of the SSM families' streams
FAMILY_REQS = [([3 + i, 5, 7, 11, 13 + i, 17, 19, 23], 4 + 3 * i)
               for i in range(6)]
# a batch the data axis does not divide stays whole on every data group
ODD_SLOTS = 3


def serve_requests(eng, reqs) -> dict:
    """Submit `reqs`, run to the end; the streams, finish reasons, FC
    variants and host transfers per iteration."""
    for i, (p, n) in enumerate(reqs):
        eng.submit(ServeRequest(i, p, n))
    results = eng.run(max_iterations=300)
    return {"streams": {r.req_id: (list(r.tokens), r.finished_reason)
                        for r in results},
            "fc": [s.fc_variant for s in eng.stats],
            "transfers": [s.transfers for s in eng.stats]}


def family_engine(arch: str, params, device, mesh=None, **kw) -> PapiEngine:
    return PapiEngine(get_config(arch), params, mesh=mesh, device=device,
                      **{**R.ENGINE, **kw})


def footprint(eng) -> dict:
    """Shapes of the rank's cache leaves (the batch dim is the slots')."""
    c = eng.cache
    out = {"pos": tuple(c["pos"].shape)}
    for key in ("k", "block_tables"):
        if key in c:
            out[key] = tuple(c[key].shape)
    if "ssm" in c:
        out["ssm"] = tuple(c["ssm"].ssm.shape)
        out["conv_x"] = tuple(c["ssm"].conv_x.shape)
    return out


def tp_world(rank: int, device, tree: dict, draft_tree: dict,
             cases: list) -> dict:
    """The (2, 2) world: the layouts of the qwen2 twin's three caches,
    then every engine case of `tests/_mesh_ranks.py`."""
    mesh = make_serving_mesh(2, 2, device=device)
    cfg = get_config(R.ARCH)
    params = params_from_jax(cfg, tree, device)
    draft = (cfg, params_from_jax(cfg, draft_tree, device))
    layout = {}
    for name in ("dense", "attn_pim", "paged"):
        eng = PapiEngine(cfg, params, mesh=mesh, device=device,
                         **{**R.ENGINE, **R.CASES[name][0]})
        layout[name] = footprint(eng)
    engine = {name: R.run_engine(cfg, params, name, device, mesh, draft)
              for name in cases}
    return {"coords": dict(mesh.coords), "layout": layout, "engine": engine}


def dp_world(rank: int, device, trees: dict, qwen_tree: dict) -> dict:
    """The (2, 1) world: the SSM, hybrid and MoE twins on full windows,
    and the qwen2 twin on a batch of 3 slots that the data axis does not
    divide."""
    mesh = make_serving_mesh(2, 1, device=device)
    out = {"coords": dict(mesh.coords), "layout": {}, "engine": {}}
    for arch in FAMILIES:
        params = params_from_jax(get_config(arch), trees[arch], device)
        eng = family_engine(arch, params, device, mesh)
        out["layout"][arch] = footprint(eng)
        out["engine"][arch] = serve_requests(eng, FAMILY_REQS)
    cfg = get_config(R.ARCH)
    params = params_from_jax(cfg, qwen_tree, device)
    eng = PapiEngine(cfg, params, mesh=mesh, device=device,
                     **{**R.ENGINE, "max_slots": ODD_SLOTS})
    out["layout"]["odd"] = footprint(eng)
    out["engine"]["odd"] = serve_requests(eng, R.REQS)
    return out


def one_device(rank: int, device, tree: dict, draft_tree: dict,
               trees: dict, cases: list) -> dict:
    """Both worlds' runs on the port's one-device engine (no mesh), in a
    process of its own beside them."""
    cfg = get_config(R.ARCH)
    params = params_from_jax(cfg, tree, "cpu")
    draft = (cfg, params_from_jax(cfg, draft_tree, "cpu"))
    out = {name: R.run_engine(cfg, params, name, "cpu", None, draft)
           for name in cases}
    for arch in FAMILIES:
        fam = params_from_jax(get_config(arch), trees[arch], "cpu")
        out[arch] = serve_requests(family_engine(arch, fam, "cpu"),
                                   FAMILY_REQS)
    out["odd"] = serve_requests(
        PapiEngine(cfg, params, device="cpu",
                   **{**R.ENGINE, "max_slots": ODD_SLOTS}), R.REQS)
    return out
