"""Serving with the weights or the KV sequence over the data axis against
one device: the 2D weight-stationary decode, the FSDP prefill and the
long-context table (`launch.steps.choose_rules`) at dp > 1.

One gloo world of 4 CPU ranks, started once for this module
(`launch.mesh.spawn_world`: rendezvous through a file under tmp_path,
every rank and the world bounded in time), runs every case while the
parent runs the one-device oracles on one torch thread, then the JAX
reference's one-device `decode_step`, `prefill` and engine on the same
weights (the port's seed-0 weights as a JAX tree) and inputs; the rank
bodies live in `tests/_mesh_fsdp_ranks.py` (no jax).

  * the one-device oracle of every case equals the reference's: logits
    and caches within 1e-5, streams and FC variants token for token, so
    the mesh results below reach the reference through the same inputs;

  * `build_step`'s decode cell under the 2D table and its prefill cell
    under the FSDP prefill's table (forced on the smoke twins through
    ``hbm_bytes``) at (2, 2) and (2, 1), for deepseek-67b's twin (untied
    head), command-r-plus-104b's (tied, layernorm) and gpt3-175b's (gelu,
    biases): every rank's logits and cache blocks equal the one-device
    step's, each rank holds exactly the rules' block of every leaf (its
    2D block of every "fsdp" leaf), the blocks gather back whole, and a
    step runs the collectives `collectives_per_forward` reckons;
  * `build_step`'s `long_500k` decode cell for mamba2's and zamba2's
    twins at (2, 2) over a few hundred positions, one row writing into
    data rank 1's slices;
  * `PapiEngine(rules=)` at (2, 2): the qwen2 twin under the 2D table
    (both FC variants) and under the FSDP prefill's table, mamba2 and
    zamba2 under the long-context table, zamba2 also with Attn-PIM (the
    KV heads over "model", the batch whole over "data"): streams and FC
    variants equal the one-device engine's;
  * `build_step(cfg, SHAPES["long_500k"], mesh)` at the full 524288
    positions, on ``meta`` only;
  * a bf16 column group's partials reach the sum over "data" in f32 and
    are rounded once (`models.linear.contract_block`);
  * what still raises names the later slice;
  * the rank module imports neither jax nor the JAX package.

Tolerance: logits and caches within 1e-5 relative to their largest
magnitude (f32); streams token for token.
"""
import ast
import concurrent.futures
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _mesh_fsdp_ranks as F  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.serving import PapiEngine as JaxEngine  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.distributed.sharding import (block_range,  # noqa: E402
                                              serve_rules)
from repro_torch.launch.mesh import spawn_world  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.model import (cache_shardings,  # noqa: E402
                                      param_shapes, param_shardings)
from repro_torch.serving import PapiEngine  # noqa: E402
from repro_torch.serving.engine import check_mesh  # noqa: E402

WORLD_TIMEOUT_S = 90
DENSE_CASES = [(shape, arch, cell) for shape in F.MESHES
               for arch in F.DENSE for cell in ("decode", "prefill")]
ORACLES = ([(cell, arch) for arch in F.DENSE for cell in ("decode",
                                                           "prefill")]
           + [("long", arch) for arch in F.SSM]
           + [("engine", name) for name in F.ENGINE_CASES])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(spawn_world, F.world, 4, device="cpu",
                      timeout_s=WORLD_TIMEOUT_S,
                      store_dir=tmp_path_factory.mktemp("world4"))
    yield fut
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def one_device(world):
    """Every case on one device, run while the world runs (on one thread:
    the smoke twins' ops are too small to share)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {(cell, arch): F.one_device(cell, arch)
               for arch in F.DENSE for cell in ("decode", "prefill")}
        out.update({("long", arch): F.one_device("long", arch)
                    for arch in F.SSM})
        out.update({("engine", name): F.one_device(name, case[0])
                    for name, case in F.ENGINE_CASES.items()})
    finally:
        torch.set_num_threads(threads)
    return out


def _jax_tree(tree: dict) -> dict:
    """The port's weights as the reference's tree (the same keys and
    layouts)."""
    return {k: _jax_tree(v) if isinstance(v, dict)
            else jnp.asarray(v.numpy()) for k, v in tree.items()}


def _jax_cache(jc, whole: dict, cap: int) -> dict:
    cache = jm.init_cache(jc, whole["pos"].shape[0], cap)
    for key in cache:
        cache[key] = (type(cache[key])(*(jnp.asarray(x.numpy())
                                         for x in whole[key]))
                      if key == "ssm" else jnp.asarray(whole[key].numpy()))
    return cache


def _jax_cache_numpy(cache: dict) -> dict:
    out = {k: np.asarray(cache[k]) for k in ("pos", "k", "v") if k in cache}
    if "ssm" in cache:
        out.update((name, np.asarray(x))
                   for name, x in zip(cache["ssm"]._fields, cache["ssm"]))
    return out


def _reference_case(cell: str, arch: str) -> dict:
    """A case on the reference's one device, from the port's weights."""
    cfg, jc = get_config(arch), jax_config(arch)
    jp = _jax_tree(F.params(cfg))
    if cell in F.ENGINE_CASES:
        _, _, kw, reqs = F.ENGINE_CASES[cell]
        eng = JaxEngine(jc, jp, **{**F.ENGINE, **kw})
        for i, (p, n) in enumerate(reqs):
            eng.submit(JaxRequest(i, p, n))
        results = eng.run(max_iterations=300)
        return {"streams": {r.req_id: (list(r.tokens), r.finished_reason)
                            for r in results},
                "fc": [s.fc_variant for s in eng.stats]}
    if cell == "prefill":
        batch = jax.tree.map(jnp.asarray, F.prefill_inputs(cfg))
        logits, cache = jax.jit(jm.prefill, static_argnums=0)(
            jc, jp, batch, jm.init_cache(jc, len(F.PREFILL_LENS),
                                         F.PREFILL_T))
        return {"logits": np.asarray(logits),
                "cache": _jax_cache_numpy(cache)}
    pos, cap, steps = ((F.LONG_POS, F.LONG_CAP, F.LONG_STEPS)
                       if cell == "long"
                       else (F.DECODE_POS, F.DECODE_CAP, F.DECODE_STEPS))
    whole, tokens = F.decode_inputs(cfg, pos, cap, steps)
    cache = _jax_cache(jc, whole, cap)
    step = jax.jit(jm.decode_step, static_argnums=0)
    logits = []
    for tok in tokens:
        out, cache = step(jc, jp, cache, jnp.asarray(tok))
        logits.append(np.asarray(out))
    return {"logits": logits, "cache": _jax_cache_numpy(cache)}


@pytest.fixture(scope="module")
def reference(one_device):
    """Every case on the reference's one device, run here after the
    port's oracles while the world runs; the qwen2 engine cases share one
    run (the tables differ only on a mesh)."""
    out, engines = {}, {}
    for cell, key in ORACLES:
        if cell == "engine":
            arch, _, kw, reqs = F.ENGINE_CASES[key]
            ident = (arch, repr(kw), repr(reqs))
            if ident not in engines:
                engines[ident] = _reference_case(key, arch)
            out[cell, key] = engines[ident]
        else:
            out[cell, key] = _reference_case(cell, key)
    return out


def _mesh(shape: tuple, coords: dict):
    return types.SimpleNamespace(shape={"data": shape[0], "model": shape[1]},
                                 coords=coords)


def _block(arr: np.ndarray, spec, mesh) -> np.ndarray:
    for dim, entry in enumerate(spec):
        lo, hi = block_range(arr.shape[dim], entry, mesh)
        arr = np.take(arr, range(lo, hi), axis=dim)
    return arr


def _close(got, want, what: str) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


def _cache_blocks(cfg, got: dict, want: dict, rules, mesh, b: int,
                  cap: int, rows: tuple, what: str) -> None:
    """Each leaf of a rank's cache equals its block of the one-device
    cache (the SSM state's leaves by their field names)."""
    specs = cache_shardings(cfg, b, cap, rules, mesh)
    flat = {k: specs[k] for k in ("k", "v") if k in specs}
    if "ssm" in specs:
        flat.update(zip(specs["ssm"]._fields, specs["ssm"]))
    np.testing.assert_array_equal(got["pos"], want["pos"][rows[0]:rows[1]])
    for key, spec in flat.items():
        assert got[key].shape == _block(want[key], spec, mesh).shape, key
        _close(got[key], _block(want[key], spec, mesh), f"{what} {key}")


def _rank_shapes_are_blocks(cfg, res: dict, rules, mesh) -> None:
    """Every leaf is the rules' block; every "fsdp" leaf is split over
    "data" (the twins' d = 128 divides by dp)."""
    specs = dict(_flat(param_shardings(cfg, rules, mesh)))
    for key, shape in _flat(param_shapes(cfg)):
        block = tuple(hi - lo for lo, hi in (
            block_range(n, e, mesh) for n, e in zip(shape, specs[key])))
        assert res["shapes"][key] == block, key
    fsdp = [k for k, sp in specs.items() if "data" in sp]
    assert fsdp and all(res["shapes"][k] != dict(_flat(param_shapes(cfg)))[k]
                        for k in fsdp)


def _flat(tree: dict, prefix: str = "") -> list:
    out = []
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out += _flat(v, key) if isinstance(v, dict) else [(key, v)]
    return out


@pytest.mark.parametrize("cell,key", ORACLES)
def test_one_device_oracle_equals_the_reference(one_device, reference,
                                                cell, key):
    got, want = one_device[cell, key], reference[cell, key]
    if cell == "engine":
        assert got["streams"] == want["streams"]
        assert got["fc"] == want["fc"]
        return
    logits = got["logits"] if cell != "prefill" else [got["logits"]]
    ref = want["logits"] if cell != "prefill" else [want["logits"]]
    assert len(logits) == len(ref)
    for step, (g, w) in enumerate(zip(logits, ref)):
        _close(np.asarray(g).reshape(w.shape), w,
               f"{key} {cell} step {step} logits")
    assert sorted(got["cache"]) == sorted(want["cache"])
    np.testing.assert_array_equal(got["cache"]["pos"], want["cache"]["pos"])
    for name, w in want["cache"].items():
        _close(got["cache"][name], w, f"{key} {cell} cache {name}")


@pytest.mark.parametrize("shape,arch,cell", DENSE_CASES)
def test_dense_cells_equal_one_device(world, one_device, shape, arch, cell):
    ranks = world.result()
    cfg = get_config(arch)
    want = one_device[cell, arch]
    seen = 0
    for r, res in enumerate(ranks):
        got = res.get((shape, arch, cell))
        if got is None:
            continue
        seen += 1
        mesh = _mesh(shape, res[shape, "coords"])
        rules = got["rules"]
        tag = f"{arch} {cell} {shape} rank {r}"
        assert rules["fsdp"] == "data", rules
        _rank_shapes_are_blocks(cfg, got, rules, mesh)
        if cell == "decode":
            assert rules["batch"] is None
            assert rules["act_kv_seq"] == ("data", "model")
            assert len(got["logits"]) == len(want["logits"])
            for step, (g, w) in enumerate(zip(got["logits"],
                                              want["logits"])):
                _close(g, w, f"{tag} step {step} logits")
            b = len(F.DECODE_POS)
            _cache_blocks(cfg, got["cache"], want["cache"], rules, mesh, b,
                          F.DECODE_CAP, (0, b), tag)
            assert got["ran"] == [got["reckoned"]] * F.DECODE_STEPS
            assert got["unsharded"]
        else:
            assert rules["batch"] == "data"
            lo, hi = got["rows"]
            assert hi - lo == len(F.PREFILL_LENS) // shape[0]
            _close(got["logits"], want["logits"][lo:hi], f"{tag} logits")
            _cache_blocks(cfg, got["cache"], want["cache"], rules, mesh,
                          len(F.PREFILL_LENS), F.PREFILL_T, (lo, hi), tag)
            assert got["ran"] == got["reckoned"] > 0
    assert seen == shape[0] * shape[1]


@pytest.mark.parametrize("arch", F.SSM)
def test_long_context_decode_equals_one_device(world, one_device, arch):
    cfg = get_config(arch)
    want = one_device["long", arch]
    whole, _ = F.decode_inputs(cfg, F.LONG_POS, F.LONG_CAP, F.LONG_STEPS)
    for r, res in enumerate(world.result()):
        got = res["long", arch]
        mesh = _mesh((2, 2), res[(2, 2), "coords"])
        rules = got["rules"]
        assert rules["batch"] is None and rules["fsdp"] is None
        assert rules["act_kv_seq"] == ("data", "model")
        for step, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            _close(g, w, f"{arch} rank {r} step {step} logits")
        b = len(F.LONG_POS)
        _cache_blocks(cfg, got["cache"], want["cache"], rules, mesh, b,
                      F.LONG_CAP, (0, b), f"{arch} rank {r}")
        assert got["ran"] == [got["reckoned"]] * F.LONG_STEPS
        _rank_shapes_or_whole(cfg, got, rules, mesh)
        if "k" not in got["cache"]:
            continue
        # row 1 writes positions 250 and 251, in data rank 1's slices
        lo, hi = block_range(F.LONG_CAP, ("data", "model"), mesh)
        at = [p for p in (250, 251) if lo <= p < hi]
        assert bool(at) == (mesh.coords == {"data": 1, "model": 1})
        for p in at:
            assert not np.array_equal(got["cache"]["k"][:, 1, p - lo],
                                      whole["k"].numpy()[:, 1, p])


def _rank_shapes_or_whole(cfg, res: dict, rules, mesh) -> None:
    specs = dict(_flat(param_shardings(cfg, rules, mesh)))
    for key, shape in _flat(param_shapes(cfg)):
        assert res["shapes"][key] == tuple(hi - lo for lo, hi in (
            block_range(n, e, mesh) for n, e in zip(shape, specs[key]))), key


@pytest.mark.parametrize("name", list(F.ENGINE_CASES))
def test_engine_streams_equal_one_device(world, one_device, name):
    want = one_device["engine", name]
    assert len(want["streams"]) == len(F.ENGINE_CASES[name][3])
    for r, res in enumerate(world.result()):
        got = res["engine", name]
        assert got["streams"] == want["streams"], f"rank {r}"
        assert got["fc"] == want["fc"], f"rank {r}"
        # the batch stays whole on every data group except under the FSDP
        # prefill's table, which splits it beside the weights
        assert got["data_split"] == name.endswith("prefill table")
    if name.startswith("qwen2"):
        assert {"pu", "pim"} <= set(want["fc"])


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_long_500k_specs_at_full_capacity(arch):
    """`long_500k` builds at dp > 1 (meta stand-ins only): the batch of
    one row whole, zamba2's KV sequence over (data, model) in 131072
    positions a rank, the SSM state over "model"."""
    cfg = get_config(arch)
    for shape in ((2, 2), (4, 1)):
        mesh = _mesh(shape, {"data": 0, "model": 0})
        built = build_step(cfg, SHAPES["long_500k"], mesh)
        assert built.kind == "decode" and built.rules["batch"] is None
        _, cache_sh, tok = built.in_shardings
        assert tok == (None, None)
        cache = built.args[1]
        assert all(t.device.type == "meta" for t in cache.values()
                   if isinstance(t, torch.Tensor))
        if "k" in cache:
            assert tuple(cache["k"].shape)[2] == 524288
            assert cache_sh["k"][2] == ("data", "model")
            lo, hi = block_range(524288, cache_sh["k"][2], mesh)
            assert hi - lo == 524288 // 4
        assert cache_sh["ssm"].ssm[:3] == (None, None, "model")


def test_refusals_name_the_later_slice():
    """What still raises at dp > 1: a MoE, SSM, hybrid or VLM model under
    a table that puts its weights on "data", and a paged cache under the
    FSDP, 2D or long-context tables."""
    mesh = _mesh((2, 2), {"data": 0, "model": 0})
    for arch, cell, what in (
            ("olmoe-1b-7b-smoke", "decode_32k", "2D weight-stationary"),
            ("qwen2-vl-7b-smoke", "prefill_32k", "FSDP prefill"),
            ("mamba2-1.3b-smoke", "decode_32k", "2D weight-stationary"),
            ("zamba2-1.2b-smoke", "prefill_32k", "FSDP prefill")):
        with pytest.raises(ValueError, match="later slice") as err:
            build_step(get_config(arch), SHAPES[cell], mesh, hbm_bytes=1.0)
        assert what in str(err.value)
        build_step(get_config(arch), SHAPES[cell],
                   _mesh((1, 2), {"data": 0, "model": 0}), hbm_bytes=1.0)
    cfg = get_config("qwen2-0.5b-smoke")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    shaped = types.SimpleNamespace(shape={"data": 2, "model": 1},
                                   device=torch.device("cpu"), rank=0)
    for rules, what in ((F.engine_rules(cfg, "decode_32k", mesh),
                         "2D weight-stationary"),
                        (F.engine_rules(cfg, "prefill_32k", mesh),
                         "FSDP prefill"),
                        (serve_rules(long_context=True), "long-context")):
        with pytest.raises(ValueError, match=f"paged.*{what}.*later slice"):
            PapiEngine(cfg, params, mesh=shaped, rules=rules, device="cpu",
                       kv_layout="paged")
        check_mesh({"data": 1, "model": 2}, rules, "moe", "paged")
    check_mesh({"data": 2, "model": 2}, serve_rules(attn_pim=True), "moe",
               "paged")


@pytest.mark.parametrize("pim", [False, True])
def test_2d_partials_stay_f32_until_summed(pim):
    """A bf16 column group under the 2D layout hands its partial products
    over "data" to the sum in f32 and rounds the sum once: rank 0 holds
    rows [0, 32) of the weight [w; w], the stand-in sum adds rank 1's
    partial over the other half of x."""
    from repro_torch.models.linear import contract_block
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 64), np.float32)).bfloat16()
    ws = [torch.from_numpy(rng.standard_normal((32, n), np.float32)
                           ).bfloat16() for n in (16, 8)]
    seen = []

    class Summed:
        """Both data ranks' partials, summed as `all_reduce_many` does."""

        def all_reduce_many(self, outs, axis):
            seen.append([o.dtype for o in outs])
            other = [x[:, 32:].float() @ w.float() for w in ws]
            return [o + p for o, p in zip(outs, other)]

    got = contract_block(x, ws, (Summed(), "data", 0, 32), pim=pim)
    assert seen == [[torch.float32, torch.float32]]
    for g, w in zip(got, ws):
        want = (x[:, :32].float() @ w.float()
                + x[:, 32:].float() @ w.float()).bfloat16()
        assert g.dtype == torch.bfloat16 and torch.equal(g, want)


def test_rank_bodies_import_neither_jax_nor_repro():
    """A spawned rank imports `tests/_mesh_fsdp_ranks.py`: torch, numpy
    and the port only, so it starts in a second."""
    names = set()
    for node in ast.walk(ast.parse(Path(F.__file__).read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"jax", "jaxlib", "repro"}, sorted(tops)
    assert "repro_torch" in tops
