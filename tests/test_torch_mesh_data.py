"""Mesh serving on the data axis (PAPI §5.3) against one device.

The reference's data axis is the batch dim of one engine (the "batch":
"data" rule): every rank runs the same host loop, and each data group
computes only its own slots' rows.  Its claim is
`tests/test_serving_sharded.py::test_mesh_dp_axis_also_matches` (a (2, 4)
mesh gives the one-device streams), which needs 8 host devices and skips
in tier 1.  Here two gloo worlds of CPU ranks, each started once for this
module (`launch.mesh.spawn_world`: rendezvous through a file under
tmp_path, every rank and the world bounded in time) and run side by side
while the parent runs the one-device engines, hold it:

  * (2, 2), the qwen2 smoke twin with the reference's `PRNGKey(0)`
    weights: every engine case of `tests/_mesh_ranks.py` (dense, attn_pim,
    paged, speculative with a seed-9 draft, chunked paged admission,
    serve(), alpha 3 with both FC variants) gives the port's and the
    reference's one-device streams, finish reasons and FC variants, and
    the port's host transfers per iteration;
  * (2, 1): the mamba2, zamba2 and olmoe smoke twins (full prefill windows:
    the reference pushes a shorter prompt's padding through the SSM state,
    ROADMAP queue 3), and the qwen2 twin on 3 slots, a batch the data axis
    does not divide;
  * each rank holds only its block under the reference's rules: the slab's
    and the SSM state's batch dim is halved (whole on 3 slots), the paged
    pools are whole, ``pos`` and the block tables hold the group's slots;
  * the launcher's ``--mesh 2,1`` and ``--mesh 2,2 --device cpu`` print the
    one-device launcher's lines.

The rank bodies live in `tests/_mesh_data_ranks.py` (no jax).
"""
import concurrent.futures
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _mesh_data_ranks as D  # noqa: E402
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
from repro_torch.models.model import (cache_shardings,  # noqa: E402
                                      paged_cache_shardings)

WORLD_TIMEOUT_S = 90
CASES = list(R.CASES)
DP_CASES = list(D.FAMILIES) + ["odd"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    """The reference's weights (jax) and their numpy trees: the qwen2 twin
    and its seed-9 draft, and each family twin from PRNGKey(0)."""
    init = jax.jit(jax_init_params, static_argnums=0)
    jcfg = jax_config("qwen2-0.5b").reduced()
    jp = init(jcfg, jax.random.PRNGKey(0))
    jd = init(jcfg, jax.random.PRNGKey(9))
    fam = {a: init(jax_config(a[:-len("-smoke")]).reduced(),
                   jax.random.PRNGKey(0)) for a in D.FAMILIES}
    return {"jcfg": jcfg, "jp": jp, "jd": jd, "fam": fam,
            "tree": _np(jp), "dtree": _np(jd),
            "ftrees": {a: _np(p) for a, p in fam.items()}}


@pytest.fixture(scope="module")
def worlds(trees, tmp_path_factory):
    """Both worlds, and a process running the port's one-device engine,
    started at once in the background; each test waits for what it
    reads."""
    pool = concurrent.futures.ThreadPoolExecutor(3)
    futs = {
        "tp": pool.submit(spawn_world, D.tp_world, 4, device="cpu",
                          timeout_s=WORLD_TIMEOUT_S,
                          args=(trees["tree"], trees["dtree"], CASES),
                          store_dir=tmp_path_factory.mktemp("world22")),
        "dp": pool.submit(spawn_world, D.dp_world, 2, device="cpu",
                          timeout_s=WORLD_TIMEOUT_S,
                          args=(trees["ftrees"], trees["tree"]),
                          store_dir=tmp_path_factory.mktemp("world21")),
        "one": pool.submit(spawn_world, D.one_device, 1, device="cpu",
                           timeout_s=WORLD_TIMEOUT_S,
                           args=(trees["tree"], trees["dtree"],
                                 trees["ftrees"], CASES),
                           store_dir=tmp_path_factory.mktemp("one")),
    }
    yield futs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def one_device(trees, worlds):
    """Every case on the reference's one-device engine, run here while the
    worlds run, and on the port's (its own process)."""
    ref = {c: _reference(trees["jcfg"], trees["jp"], trees["jd"], c)
           for c in CASES}
    for arch in D.FAMILIES:
        jcfg = jax_config(arch[:-len("-smoke")]).reduced()
        ref[arch] = _run_reference(jcfg, trees["fam"][arch], D.FAMILY_REQS)
    ref["odd"] = _run_reference(trees["jcfg"], trees["jp"], R.REQS,
                                max_slots=D.ODD_SLOTS)
    return worlds["one"].result()[0], ref


def _run_reference(jcfg, jparams, reqs, live=False, **kw) -> dict:
    eng = JaxEngine(jcfg, jparams, **{**R.ENGINE, **kw})
    reqs = [JaxRequest(i, p, n) for i, (p, n) in enumerate(reqs)]
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


def _reference(jcfg, jparams, jdraft, name: str) -> dict:
    kw, kind, live = R.CASES[name]
    if name == "spec":
        kw = dict(kw, draft=(jcfg, jdraft))
    return _run_reference(jcfg, jparams, R.case_requests(kind), live, **kw)


def _ranks(worlds, key: str) -> list:
    return worlds[key].result()


def _held(ranks: list, port: dict, ref: dict, case: str) -> None:
    got = ranks[0]["engine"][case]
    for res in ranks[1:]:
        assert res["engine"][case] == got
    assert got["streams"] == port[case]["streams"]
    assert got["streams"] == ref[case]["streams"]
    assert got["fc"] == port[case]["fc"] == ref[case]["fc"]
    assert got["transfers"] == port[case]["transfers"]


@pytest.mark.parametrize("case", CASES)
def test_mesh_2x2_streams_equal_one_device(worlds, one_device, case):
    port, ref = one_device
    _held(_ranks(worlds, "tp"), port, ref, case)
    if case == "flip":
        assert {"pu", "pim"} <= set(port[case]["fc"])


@pytest.mark.parametrize("case", DP_CASES)
def test_mesh_2x1_streams_equal_one_device(worlds, one_device, case):
    port, ref = one_device
    _held(_ranks(worlds, "dp"), port, ref, case)


class _Mesh:
    """A shape-only mesh with one rank's coordinates."""

    def __init__(self, dp, tp, coords):
        self.shape = {"data": dp, "model": tp}
        self.coords = coords


def _block(full, spec, mesh) -> tuple:
    return tuple(hi - lo for lo, hi in (block_range(n, e, mesh)
                                        for n, e in zip(full, spec)))


def test_mesh_2x2_ranks_hold_their_block(worlds):
    """The slab's batch dim is the data group's slots, its sequence (dense)
    or KV-head dim (attn_pim) the tensor shard's; the paged pools are whole
    over the pages, their KV heads split; ``pos`` and the tables hold the
    group's 2 slots."""
    cfg = get_config(R.ARCH)
    slots, cap, page = R.ENGINE["max_slots"], R.ENGINE["cache_capacity"], 8
    pages, blocks = slots * cap // page + 1, slots * cap // page
    for rank, res in enumerate(_ranks(worlds, "tp")):
        assert res["coords"] == {"data": rank // 2, "model": rank % 2}
        mesh = _Mesh(2, 2, res["coords"])
        got = res["layout"]
        for name, attn_pim in (("dense", False), ("attn_pim", True)):
            spec = cache_shardings(cfg, slots, cap,
                                   serve_rules(attn_pim=attn_pim), mesh)["k"]
            assert spec[1] == "data"
            assert got[name]["k"] == _block((2, slots, cap, 2, 32), spec,
                                            mesh)
            assert got[name]["pos"] == (slots // 2,)
        assert got["dense"]["k"] == (2, 2, 32, 2, 32)
        assert got["attn_pim"]["k"] == (2, 2, 64, 1, 32)
        spec = paged_cache_shardings(cfg, slots, pages, page, blocks,
                                     serve_rules(attn_pim=True), mesh)["k"]
        assert got["paged"]["k"] == _block((2, pages, page, 2, 32), spec,
                                           mesh) == (2, pages, page, 1, 32)
        assert got["paged"]["pos"] == (slots // 2,)
        assert got["paged"]["block_tables"] == (slots // 2, blocks)


def test_mesh_2x1_ranks_hold_their_block(worlds):
    """mamba2's SSM state, zamba2's state and shared-block slab and olmoe's
    slab hold the group's 2 of 4 slots; 3 slots stay whole."""
    rules = serve_rules()
    for rank, res in enumerate(_ranks(worlds, "dp")):
        assert res["coords"] == {"data": rank, "model": 0}
        mesh = _Mesh(2, 1, res["coords"])
        got = res["layout"]
        for arch in D.FAMILIES:
            cfg = get_config(arch)
            specs = cache_shardings(cfg, 4, R.ENGINE["cache_capacity"],
                                    rules, mesh)
            assert got[arch]["pos"] == (2,)
            if "ssm" in specs:
                assert specs["ssm"].ssm[1] == "data"
                full = get_config(arch).num_layers
                assert got[arch]["ssm"][:2] == (full, 2)
                assert got[arch]["conv_x"][:2] == (full, 2)
            if "k" in specs:
                assert specs["k"][1] == "data"
                assert got[arch]["k"][1] == 2
        assert "ssm" in got["mamba2-1.3b-smoke"]
        assert "k" in got["zamba2-1.2b-smoke"]
        assert "ssm" in got["zamba2-1.2b-smoke"]
        assert got["odd"]["pos"] == (D.ODD_SLOTS,)
        assert got["odd"]["k"][1] == D.ODD_SLOTS


def _lines(text: str) -> list[str]:
    """The launcher's deterministic lines (no wall-clock figures)."""
    return [ln for ln in text.splitlines()
            if ln and not ln.startswith(("tokens:", "mesh:"))
            and not re.search(r"\d+ms", ln)]


LAUNCH = ["--arch", "qwen2-0.5b-smoke", "--device", "cpu", "--requests",
          "6", "--capacity", "128"]


@pytest.fixture(scope="module")
def one_device_lines():
    """The one-device launcher's output for `LAUNCH`."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_cli.main(LAUNCH)
    return out.getvalue()


@pytest.mark.parametrize("shape", ["2,1", "2,2"])
def test_launcher_data_mesh_prints_the_one_device_lines(capfd, shape,
                                                        one_device_lines):
    one = one_device_lines
    serve_cli.main(LAUNCH + ["--mesh", shape])
    out = capfd.readouterr().out
    dp, tp = (int(x) for x in shape.split(","))
    assert (f"mesh: {{'data': {dp}, 'model': {tp}}} over {dp * tp} ranks "
            "(gloo on cpu)") in out
    assert _lines(out) == _lines(one)
    assert "completed 6 requests" in out


class _StagedMesh(_Mesh):
    """A shape-only stand-in for a shared card's mesh: the engine reads
    its shape, coordinates, device and rank, and that it stages."""
    staged = True
    device = torch.device("cpu")
    rank = 0


@pytest.mark.parametrize("arch, want", [("mamba2-1.3b-smoke", 2),
                                        ("olmoe-1b-7b-smoke", 4),
                                        ("qwen2-0.5b-smoke", 2)])
def test_transfer_budget_counts_the_staged_data_gather(arch, want):
    """On a shared card a (2, 1) engine's steady iteration stages its
    fetch's gather over "data" through one host copy beside the fetch
    (olmoe adds its 2 layers' count copies); a batch the data axis does
    not divide gathers nothing."""
    from repro_torch.models import init_params
    from repro_torch.serving import PapiEngine
    cfg = get_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    mesh = _StagedMesh(2, 1, {"data": 1, "model": 0})
    eng = PapiEngine(cfg, params, mesh=mesh, device="cpu", **R.ENGINE)
    assert eng.transfer_budget == want
    odd = PapiEngine(cfg, params, mesh=mesh, device="cpu",
                     **{**R.ENGINE, "max_slots": D.ODD_SLOTS})
    assert odd.transfer_budget == want - 1
