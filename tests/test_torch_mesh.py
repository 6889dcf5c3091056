"""Mesh serving on the tensor axis (PAPI §5.3) against one device.

Gloo worlds of 2 and 4 CPU ranks, each started once for this module by a
fixture (`launch.mesh.spawn_world`: rendezvous through a file under
tmp_path, every rank and the world bounded in time), run the rank bodies
of `tests/_mesh_ranks.py` on the qwen2 smoke twin (f32) with the
reference's `PRNGKey(0)` weights through `params_from_jax` and
`shard_params`.  What is held:

  * the column and row FC banks ("pu" and "pim") against the unsharded
    product; both sharded Attn-PIM wrappers against the unsharded plain
    versions, the whole-tensor fallback at tp = 4 (2 KV heads) included;
    the sequence-split slab's merge against the plain decode attention;
  * each rank holds only its block of every leaf the rules split;
  * the engine's streams on every rank equal the port's one-device engine
    and the reference's one-device engine, request for request, with the
    same FC variant and host transfers per iteration: dense (default
    rules: the slab split by sequence), attn_pim (by KV head), paged,
    speculative with a seed-9 draft, chunked paged admission, serve(), and
    alpha 3 with both FC variants;
  * deepseek-67b's twin (untied head: lm_head split over the vocabulary)
    and qwen2-vl-7b's (M-RoPE) equal the port's one-device engine;
  * the launcher's ``--mesh 1,2 --device cpu`` prints the one-device
    launcher's lines;
  * what still raises at dp > 1 (a paged cache under the long-context
    rules, a MoE model with its weights over "data") names the later
    slice; the data axis itself is `tests/test_torch_mesh_data.py`'s, the
    MoE, SSM, hybrid and gelu families `tests/test_torch_mesh_families.py`'s,
    the weights and the KV sequence over "data"
    `tests/test_torch_mesh_fsdp_serve.py`'s.
"""
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _mesh_ranks as R  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving import PapiEngine as JaxEngine  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.sharding import (block_range,  # noqa: E402
                                              serve_rules)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.mesh import spawn_world  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.models.model import param_shardings  # noqa: E402
from repro_torch.serving import PapiEngine  # noqa: E402
from repro_torch.serving.engine import check_mesh  # noqa: E402

WORLD_TIMEOUT_S = 90
CASES = list(R.CASES)


@pytest.fixture(scope="module")
def trees():
    jcfg = jax_config("qwen2-0.5b").reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jdraft = jax_init_params(jcfg, jax.random.PRNGKey(9))
    return (jcfg, jparams, jdraft, jax.tree.map(np.asarray, jparams),
            jax.tree.map(np.asarray, jdraft))


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def world(request, trees, tmp_path_factory):
    """One gloo world of tp ranks: every check and engine case at once."""
    tp = request.param
    _, _, _, tree, dtree = trees
    return tp, spawn_world(
        R.mesh_world, tp, device="cpu", timeout_s=WORLD_TIMEOUT_S,
        args=(tp, tree, dtree, CASES),
        store_dir=tmp_path_factory.mktemp(f"world{tp}"))


@pytest.fixture(scope="module")
def one_device(trees):
    """Each case on the port's one-device engine and the reference's."""
    jcfg, jparams, jdraft, tree, dtree = trees
    cfg = get_config(R.ARCH)
    params = params_from_jax(cfg, tree, "cpu")
    draft = (cfg, params_from_jax(cfg, dtree, "cpu"))
    port = {c: R.run_engine(cfg, params, c, "cpu", None, draft)
            for c in CASES}
    ref = {c: _reference(jcfg, jparams, jdraft, c) for c in CASES}
    return port, ref


def _reference(jcfg, jparams, jdraft, name: str) -> dict:
    kw, kind, live = R.CASES[name]
    if name == "spec":
        kw = dict(kw, draft=(jcfg, jdraft))
    eng = JaxEngine(jcfg, jparams, **{**R.ENGINE, **kw})
    reqs = [JaxRequest(i, p, n)
            for i, (p, n) in enumerate(R.case_requests(kind))]
    if live:
        results = [ev.result for ev in eng.serve([[r] for r in reqs],
                                                 max_iterations=300)
                   if ev.finished]
    else:
        for r in reqs:
            eng.submit(r)
        results = eng.run(max_iterations=300)
    return {"streams": {r.req_id: (list(r.tokens), r.finished_reason)
                        for r in results},
            "fc": [s.fc_variant for s in eng.stats]}


def test_fc_banks_match_the_unsharded_product(world):
    tp, ranks = world
    for res in ranks:
        b = res["banks"]
        for variant in ("pu", "pim"):
            assert b[f"col_{variant}"] <= 1e-4
            assert b[f"row_{variant}"] <= 1e-4
            assert b[f"col_shape_{variant}"] == (64, 96 // tp)
            assert b[f"row_shape_{variant}"] == (64 // tp, 96)


def test_sharded_attention_matches_the_unsharded_plain_version(world):
    tp, ranks = world
    for res in ranks:
        att = res["attention"]
        for nkv in (8, 2):
            local = nkv // tp if nkv % tp == 0 else nkv  # whole: fallback
            for rows in (1, 3):
                err, shape = att[f"dense_nkv{nkv}_t{rows}"]
                assert err <= 1e-4 and shape == (3, 64, local, 32)
                err, shape = att[f"paged_nkv{nkv}_t{rows}"]
                assert err <= 1e-4 and shape == (24, 8, local, 32)
        assert att["seq_merge"] <= 1e-5


class _Mesh:
    def __init__(self, tp, rank):
        self.shape = {"data": 1, "model": tp}
        self.coords = {"data": 0, "model": rank}


def test_each_rank_holds_only_its_block(world):
    tp, ranks = world
    cfg = get_config(R.ARCH)
    names = {"w_q": ("layers", "attn", "w_q"),
             "w_o": ("layers", "attn", "w_o"),
             "w_k": ("layers", "attn", "w_k"),
             "w_gate": ("layers", "mlp", "w_gate"),
             "w_down": ("layers", "mlp", "w_down"),
             "embed": ("embed", "w")}
    full = {"w_q": (2, 128, 4, 32), "w_o": (2, 4, 32, 128),
            "w_k": (2, 128, 2, 32), "w_gate": (2, 128, 256),
            "w_down": (2, 256, 128), "embed": (256, 128)}
    for rank, res in enumerate(ranks):
        mesh = _Mesh(tp, rank)
        for layout, attn_pim in (("dense", False), ("attn_pim", True),
                                 ("paged", True)):
            specs = param_shardings(cfg, serve_rules(attn_pim=attn_pim),
                                    mesh)
            got = res["layout"][layout]
            for name, path in names.items():
                spec = specs
                for key in path:
                    spec = spec[key]
                want = tuple(hi - lo for lo, hi in (
                    block_range(n, e, mesh)
                    for n, e in zip(full[name], spec)))
                assert got[name] == want, (layout, name)
            assert got["embed"] == (256 // tp, 128)
            assert got["w_gate"] == (2, 128, 256 // tp)
        # the dense slab splits by sequence, attn_pim by KV head where the
        # 2 KV heads divide the axis, the pools likewise
        assert res["layout"]["dense"]["k"] == (2, 4, 64 // tp, 2, 32)
        assert res["layout"]["dense"]["kv_seq"] == (rank * 64 // tp, 64)
        kv = 2 // tp if 2 % tp == 0 else 2
        assert res["layout"]["attn_pim"]["k"] == (2, 4, 64, kv, 32)
        assert res["layout"]["paged"]["k"] == (2, 33, 8, kv, 32)


@pytest.mark.parametrize("case", CASES)
def test_mesh_streams_equal_one_device(world, one_device, case):
    tp, ranks = world
    port, ref = one_device
    got = ranks[0]["engine"][case]
    for res in ranks[1:]:
        assert res["engine"][case] == got
    assert got["streams"] == port[case]["streams"]
    assert got["streams"] == ref[case]["streams"]
    assert got["fc"] == port[case]["fc"] == ref[case]["fc"]
    assert got["transfers"] == port[case]["transfers"]
    if case == "flip":
        assert {"pu", "pim"} <= set(got["fc"])


@pytest.mark.parametrize("arch", R.FAMILIES)
def test_mesh_families_equal_one_device(world, arch):
    tp, ranks = world
    want = R.family_run(arch)
    for res in ranks:
        got = res["families"][arch]
        assert got["streams"] == want["streams"]
        assert got["fc"] == want["fc"]
    vocab = get_config(arch).vocab_size
    assert vocab // tp in ranks[0]["families"][arch]["head"]


def _lines(text: str) -> list[str]:
    """The launcher's deterministic lines (no wall-clock figures)."""
    return [ln for ln in text.splitlines()
            if ln and not ln.startswith(("tokens:", "mesh:"))
            and not re.search(r"\d+ms", ln)]


def test_launcher_mesh_prints_the_one_device_lines(capfd, tmp_path):
    argv = ["--arch", "qwen2-0.5b-smoke", "--device", "cpu",
            "--requests", "6", "--capacity", "128"]
    serve_cli.main(argv)
    one = capfd.readouterr().out
    serve_cli.main(argv + ["--mesh", "1,2"])
    out = capfd.readouterr().out
    assert "mesh: {'data': 1, 'model': 2} over 2 ranks (gloo on cpu)" in out
    assert _lines(out) == _lines(one)
    assert "completed 6 requests" in out


def test_refusals_raise():
    """What the mesh still refuses at dp > 1, naming the later slice: a
    paged cache under the long-context rules (the batch whole, the KV
    sequence over (data, model)).  Those rules themselves serve every
    decoder family on the dense slab (`tests/test_torch_mesh_fsdp_serve.py`),
    and every family is served on both axes under the plain rules
    (`tests/test_torch_mesh_families.py`)."""
    for arch in ("mamba2-1.3b-smoke", "olmoe-1b-7b-smoke",
                 "zamba2-1.2b-smoke", R.ARCH):
        family = get_config(arch).family
        for attn_pim in (False, True):
            rules = serve_rules(long_context=True, attn_pim=attn_pim)
            for shape in ({"data": 2, "model": 2}, {"data": 2, "model": 1}):
                check_mesh(shape, rules, family)
                with pytest.raises(ValueError,
                                   match="paged.*long-context.*later slice"):
                    check_mesh(shape, rules, family, "paged")
            check_mesh({"data": 1, "model": 2}, rules, family, "paged")
        for shape in ({"data": 1, "model": 2}, {"data": 2, "model": 2}):
            check_mesh(shape, serve_rules(), family)
    cfg = get_config("olmoe-1b-7b-smoke")
    from repro_torch.models import init_params
    params = init_params(cfg, torch.Generator().manual_seed(0))
    mesh = type("M", (), {"shape": {"data": 2, "model": 2},
                          "device": torch.device("cpu"), "rank": 0})()
    with pytest.raises(ValueError, match="long-context.*later slice"):
        PapiEngine(cfg, params, mesh=mesh, device="cpu", kv_layout="paged",
                   rules=serve_rules(long_context=True))


def test_engine_refuses_without_spawning():
    """The engine checks the mesh before any collective: a shape-only mesh
    is enough to see it refuse a paged cache under the long-context rules
    with dp > 1, and a MoE model under the 2D weight-stationary decode's
    table (its weights over "data")."""
    cfg = get_config(R.ARCH)
    from repro_torch.models import init_params
    params = init_params(cfg, torch.Generator().manual_seed(0))
    mesh = type("M", (), {"shape": {"data": 2, "model": 1},
                          "device": torch.device("cpu"), "rank": 0})()
    with pytest.raises(ValueError, match="later slice"):
        PapiEngine(cfg, params, mesh=mesh, device="cpu", kv_layout="paged",
                   rules=serve_rules(long_context=True, attn_pim=True))
    moe = get_config("olmoe-1b-7b-smoke")
    rules = dict(serve_rules(), fsdp="data", batch=None,
                 act_kv_seq=("data", "model"))
    with pytest.raises(ValueError, match="moe.*weight-stationary.*later"):
        PapiEngine(moe, init_params(moe, torch.Generator().manual_seed(0)),
                   mesh=mesh, device="cpu", rules=rules)
