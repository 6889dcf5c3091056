"""Rank bodies of the family mesh tests (`tests/test_torch_mesh_families.py`),
run by `repro_torch.launch.mesh.spawn_world` in spawned processes: this
module imports torch and the port only, never jax, so a rank starts in a
second.

Each body gets the reference's weights as numpy trees (the parent made
them with jax), runs every case on this rank's block of the MoE, SSM,
hybrid and gelu twins and returns plain Python results for the parent to
compare with the one-device engines."""
from __future__ import annotations

import contextlib

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.distributed.sharding import (axis_rules, batch_block,
                                              local_block, serve_rules)
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import (init_cache, init_params, params_from_jax,
                                prefill)
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.model import param_shardings
from repro_torch.models.weights import shard_params
from repro_torch.serving import PapiEngine, ServeRequest

ENGINE = dict(max_slots=4, cache_capacity=64, prefill_len=8, alpha=6.0,
              eos_token=1, debug_invariants=True)
# full prefill windows (ENGINE's 8 tokens): the reference pushes a shorter
# prompt's padding through the SSM state (ROADMAP queue 3), so only an
# unpadded prompt makes its engine an oracle of the SSM families' streams
REQS = [([3 + i, 5, 7, 11, 13 + i, 17, 19, 23], 4 + 3 * i) for i in range(6)]
OLMOE, GRANITE = "olmoe-1b-7b-smoke", "granite-moe-1b-a400m-smoke"
MAMBA, ZAMBA, GPT3 = ("mamba2-1.3b-smoke", "zamba2-1.2b-smoke",
                      "gpt3-175b-smoke")
ARCHES = (OLMOE, GRANITE, MAMBA, ZAMBA, GPT3)
# name -> (arch, engine keywords); "spec" cases take the seed-9 draft
CASES = {
    "olmoe dense": (OLMOE, {}),
    "olmoe attn_pim": (OLMOE, dict(attn_pim=True)),
    "olmoe paged": (OLMOE, dict(kv_layout="paged", page_size=8)),
    "granite-moe dense": (GRANITE, {}),
    "granite-moe attn_pim": (GRANITE, dict(attn_pim=True)),
    "granite-moe paged": (GRANITE, dict(kv_layout="paged", page_size=8)),
    "mamba2 plain": (MAMBA, {}),
    "mamba2 spec": (MAMBA, dict(spec_len=3)),
    "zamba2 attn_pim": (ZAMBA, dict(attn_pim=True)),
    "gpt3 dense": (GPT3, {}),
}


def run_case(name: str, params: dict, device, mesh=None,
             draft=None) -> dict:
    """One case's engine run: the streams, finish reasons, each iteration's
    FC variant and host transfers."""
    arch, kw = CASES[name]
    if kw.get("spec_len"):
        kw = dict(kw, draft=(get_config(arch), draft))
    eng = PapiEngine(get_config(arch), params, mesh=mesh, device=device,
                     **{**ENGINE, **kw})
    for i, (p, n) in enumerate(REQS):
        eng.submit(ServeRequest(i, p, n))
    results = eng.run(max_iterations=300)
    return {"streams": {r.req_id: (list(r.tokens), r.finished_reason)
                        for r in results},
            "fc": [s.fc_variant for s in eng.stats],
            "transfers": [s.transfers for s in eng.stats]}


def first_logits(arch: str, params: dict, device, mesh=None) -> dict:
    """The prefill logits of the first 4 prompts under `serve_rules()` (on
    a mesh: this rank's block and its data group's rows, the gathered
    vocabulary)."""
    cfg = get_config(arch)
    rules = serve_rules()
    scope = (axis_rules(rules, mesh) if mesh is not None
             else contextlib.nullcontext())
    with scope, torch.no_grad():
        lo, hi = batch_block(4)
        toks = torch.tensor([p for p, _ in REQS[lo:hi]], dtype=torch.int32,
                            device=device)
        if mesh is not None:
            params = shard_params(cfg, params, rules, mesh)
        cache = init_cache(cfg, 4, 16, device)
        logits, _ = prefill(cfg, params, {"tokens": toks}, cache)
    return {"rows": (lo, hi), "logits": logits.tolist()}


def _leaves(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        out.update(_leaves(v, name) if isinstance(v, dict)
                   else {name: tuple(v.shape)})
    return out


def footprint(eng) -> dict:
    """Shapes of every leaf of the rank's params and of its cache's KV and
    SSM state."""
    out = {"params": _leaves(eng.params)}
    c = eng.cache
    for key in ("k", "block_tables"):
        if key in c:
            out[key] = tuple(c[key].shape)
    if "ssm" in c:
        out["ssm"] = {f: tuple(t.shape)
                      for f, t in zip(S.SSMState._fields, c["ssm"])}
    return out


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def idle_rank_moe(mesh) -> dict:
    """A call in which every token routes to experts 0 and 1 (rank 0's at
    tp 2): rank 1 owns none of its assignments, runs no expert, adds
    zeros, and every rank gets the one-rank result."""
    cfg = MoEConfig(num_experts=4, top_k=2, d_ff=16)
    g = _gen(3)
    d = 32
    x = torch.randn(2, 3, d, generator=g).abs() + 0.1
    p = {"w_router": torch.cat([torch.ones(d, 2), -torch.ones(d, 2)], 1),
         "w_gate": torch.randn(4, d, 16, generator=g) / 6,
         "w_up": torch.randn(4, d, 16, generator=g) / 6,
         "w_down": torch.randn(4, 16, d, generator=g) / 4}
    want, _ = M.moe_mlp(x, p, cfg)
    spec = ("model", None, None)
    local = dict(p, **{k: local_block(p[k], spec, mesh)
                       for k in ("w_gate", "w_up", "w_down")})
    with axis_rules(serve_rules(), mesh):
        got, _ = M.moe_mlp(x, local, cfg)
    top_e, _, _ = M.router(x.reshape(-1, d), p["w_router"], cfg)
    return {"err": float((got - want).abs().max()),
            "experts": tuple(local["w_gate"].shape),
            "routed": sorted(set(top_e.reshape(-1).tolist()))}


class _PerRankMean:
    """A mesh whose sums of [..., 1] tensors return this rank's part times
    the rank count: the gated RMSNorm then takes a per-rank mean, the
    fault the norm's sum over the ranks exists to avoid."""

    def __init__(self, mesh):
        self.mesh, self.shape = mesh, mesh.shape

    def all_reduce(self, x, axis="model"):
        if x.shape[-1] == 1:
            return x * self.shape[axis]
        return self.mesh.all_reduce(x, axis)


def mamba2_norm(mesh) -> dict:
    """The Mamba2 block (mamba2's twin, seed 0) on this rank's heads
    against the whole block: with the gated norm's sum over the ranks, and
    with a per-rank mean in its place."""
    cfg = get_config(MAMBA)
    lp = {k: v[0] for k, v in init_params(cfg, _gen(0))["layers"]["ssm"]
          .items()}
    u = torch.randn(2, 8, cfg.d_model, generator=_gen(4))
    want, _ = S.mamba2_block(u, lp, cfg.ssm, cfg.d_model)
    rules = serve_rules()
    specs = param_shardings(cfg, rules, mesh)["layers"]["ssm"]
    mine = {k: local_block(v[None], specs[k], mesh)[0]
            for k, v in lp.items()}
    out = {}
    for label, m in (("sum", mesh), ("per_rank_mean", _PerRankMean(mesh))):
        with axis_rules(rules, m):
            got, st = S.mamba2_block(u, mine, cfg.ssm, cfg.d_model)
        out[label] = float((got - want).abs().max())
    out["state"] = tuple(st.ssm.shape)
    return out


def _params(arch: str, trees: dict, device) -> dict:
    return params_from_jax(get_config(arch), trees[arch], device)


def mesh_world(rank: int, device, dp: int, tp: int, trees: dict,
               draft_tree: dict, cases: list) -> dict:
    """One world's work: every case on this rank, the first-step logits,
    each arch's footprint under both rule tables; at (1, 2) the idle-rank
    MoE call and the Mamba2 norm check."""
    mesh = make_serving_mesh(dp, tp, device=device)
    params = {a: _params(a, trees, device) for a in ARCHES}
    draft = params_from_jax(get_config(MAMBA), draft_tree, device)
    out = {"coords": dict(mesh.coords), "engine": {}, "logits": {},
           "layout": {}}
    for name in cases:
        arch = CASES[name][0]
        out["engine"][name] = run_case(name, params[arch], device, mesh,
                                       draft)
    for arch in ARCHES:
        out["logits"][arch] = first_logits(arch, params[arch], device, mesh)
        for attn_pim in (False, True):
            eng = PapiEngine(get_config(arch), params[arch], mesh=mesh,
                             device=device, attn_pim=attn_pim, **ENGINE)
            out["layout"][arch, attn_pim] = footprint(eng)
    if (dp, tp) == (1, 2):
        out["idle_moe"] = idle_rank_moe(mesh)
        out["norm"] = mamba2_norm(mesh)
    return out


def one_device(rank: int, device, trees: dict, draft_tree: dict,
               cases: list) -> dict:
    """Every case and the first-step logits on the port's one-device
    engine, in a process of its own beside the worlds."""
    params = {a: _params(a, trees, "cpu") for a in ARCHES}
    draft = params_from_jax(get_config(MAMBA), draft_tree, "cpu")
    out = {"engine": {n: run_case(n, params[CASES[n][0]], "cpu",
                                  draft=draft) for n in cases},
           "logits": {a: first_logits(a, params[a], "cpu") for a in ARCHES}}
    return out
