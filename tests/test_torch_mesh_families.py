"""Mesh serving of the MoE, SSM, hybrid and gelu decoders under a tensor
split (PAPI §5.3), against one device.

The reference serves every decoder family with one rule table
(`serve_rules`): "experts" and "ssm_heads" map onto the tensor axis, so an
MoE layer runs its experts where they are stored and GSPMD sums the
combine over "model", and a Mamba2 block runs its heads, with B and C
whole, the gated norm's mean over the whole ``d_inner`` and ``w_out`` a
row split.  Two gloo worlds of CPU ranks, (1, 2) and (2, 2), each started
once for this module (`launch.mesh.spawn_world`: rendezvous through a file
under tmp_path, every rank and the world bounded in time) beside a process
running the port's one-device engine, while the parent runs the
reference's engines, hold on the smoke twins with the reference's
`PRNGKey(0)` weights (f32, full prefill windows, since the reference
pushes a shorter prompt's padding through the SSM state, ROADMAP queue 3):

  * streams, finish reasons, FC variants and host transfers per iteration
    equal the port's one-device engine and the reference's: olmoe and
    granite-moe (dense, attn_pim, paged), mamba2 (plain, and speculative
    with a seed-9 draft, held to the reference's TLP = 1 streams: its own
    speculation is not lossless there), zamba2 (attn_pim) and gpt3-175b's
    gelu / layernorm / qkv-bias twin; first-step logits within 1e-4;
  * each rank holds its block of every leaf (`param_shardings`): 1/tp of
    the experts, of the Mamba2 heads' leaves and of the SSM state, B and C
    whole, zamba2's shared block banked as a dense layer;
  * a rank that owns none of a call's assignments adds zeros; the gated
    norm's sum over the ranks is what makes the block exact (a per-rank
    mean is not);
  * `transfer_budget` per family on a shape-only staged mesh;
  * the launcher's ``--mesh 1,2`` and ``--mesh 2,2`` print the one-device
    launcher's lines for each of the four families.

The rank bodies live in `tests/_mesh_family_ranks.py` (no jax).
"""
import concurrent.futures
import contextlib
import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _mesh_family_ranks as F  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.serving import PapiEngine as JaxEngine  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.sharding import (block_range,  # noqa: E402
                                              serve_rules)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.mesh import spawn_world  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.model import (cache_shardings,  # noqa: E402
                                      param_shapes, param_shardings)
from repro_torch.serving import PapiEngine  # noqa: E402

WORLD_TIMEOUT_S = 120
CASES = list(F.CASES)
WORLDS = {"1,2": (1, 2), "2,2": (2, 2)}


def _jax_cfg(arch: str):
    return jax_config(arch[:-len("-smoke")]).reduced()


@pytest.fixture(scope="module")
def trees():
    """The reference's weights from PRNGKey(0) for each twin (and the
    seed-9 mamba2 draft), as jax trees and numpy trees."""
    init = jax.jit(jax_init_params, static_argnums=0)
    jp = {a: init(_jax_cfg(a), jax.random.PRNGKey(0)) for a in F.ARCHES}
    jd = init(_jax_cfg(F.MAMBA), jax.random.PRNGKey(9))
    return {"jp": jp, "jd": jd,
            "np": {a: jax.tree.map(np.asarray, p) for a, p in jp.items()},
            "dnp": jax.tree.map(np.asarray, jd)}


@pytest.fixture(scope="module")
def worlds(trees, tmp_path_factory):
    """Both worlds and the port's one-device process, started at once in
    the background; each test waits for what it reads."""
    pool = concurrent.futures.ThreadPoolExecutor(3)
    futs = {key: pool.submit(spawn_world, F.mesh_world, dp * tp,
                             device="cpu", timeout_s=WORLD_TIMEOUT_S,
                             args=(dp, tp, trees["np"], trees["dnp"], CASES),
                             store_dir=tmp_path_factory.mktemp(f"w{dp}{tp}"))
            for key, (dp, tp) in WORLDS.items()}
    futs["one"] = pool.submit(spawn_world, F.one_device, 1, device="cpu",
                              timeout_s=WORLD_TIMEOUT_S,
                              args=(trees["np"], trees["dnp"], CASES),
                              store_dir=tmp_path_factory.mktemp("one"))
    yield futs
    pool.shutdown(wait=True)


def _reference_run(arch: str, jparams, kw: dict) -> dict:
    eng = JaxEngine(_jax_cfg(arch), jparams, **{**F.ENGINE, **kw})
    for i, (p, n) in enumerate(F.REQS):
        eng.submit(JaxRequest(i, p, n))
    results = eng.run(max_iterations=300)
    return {"streams": {r.req_id: (list(r.tokens), r.finished_reason)
                        for r in results},
            "fc": [s.fc_variant for s in eng.stats]}


@pytest.fixture(scope="module")
def reference(trees, worlds):
    """Every case but the speculative one on the reference's one-device
    engine (run here while the worlds run), and gpt3's prefill logits."""
    ref = {name: _reference_run(arch, trees["jp"][arch], kw)
           for name, (arch, kw) in F.CASES.items() if "spec_len" not in kw}
    jcfg = _jax_cfg(F.GPT3)
    toks = jax.numpy.asarray([p for p, _ in F.REQS[:4]], jax.numpy.int32)
    logits, _ = jax_prefill(jcfg, trees["jp"][F.GPT3], {"tokens": toks},
                            jax_init_cache(jcfg, 4, 16))
    ref["gpt3 logits"] = np.asarray(logits)
    return ref


def _ranks(worlds, key: str) -> list:
    return worlds[key].result()


# ------------------------------------------------------------ streams
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", list(WORLDS))
def test_family_mesh_streams_equal_one_device(worlds, reference, world,
                                              case):
    ranks = _ranks(worlds, world)
    port = _ranks(worlds, "one")[0]["engine"][case]
    got = ranks[0]["engine"][case]
    for res in ranks[1:]:
        assert res["engine"][case] == got
    assert got["streams"] == port["streams"]
    assert got["fc"] == port["fc"]
    assert got["transfers"] == port["transfers"]
    # the reference's speculation on mamba2 is not lossless (ROADMAP queue
    # 3): the port's speculative streams are held to its TLP = 1 streams
    ref = reference["mamba2 plain" if case == "mamba2 spec" else case]
    assert got["streams"] == ref["streams"]
    if case != "mamba2 spec":
        assert got["fc"] == ref["fc"]


@pytest.mark.parametrize("arch", F.ARCHES)
@pytest.mark.parametrize("world", list(WORLDS))
def test_first_step_logits_within_1e4(worlds, reference, world, arch):
    """Every rank's gathered prefill logits (the rules' KV sequence split
    on the attention families) are within 1e-4 of one rank's; gpt3's, and
    one rank's, of the reference's."""
    dp, _ = WORLDS[world]
    one = np.asarray(_ranks(worlds, "one")[0]["logits"][arch]["logits"])
    assert one.shape == (4, get_config(arch).vocab_size)
    for rank, res in enumerate(_ranks(worlds, world)):
        lo, hi = res["logits"][arch]["rows"]
        assert (lo, hi) == (res["coords"]["data"] * 4 // dp,
                            (res["coords"]["data"] + 1) * 4 // dp)
        got = np.asarray(res["logits"][arch]["logits"])
        np.testing.assert_allclose(got, one[lo:hi], atol=1e-4, rtol=0)
        if arch == F.GPT3:
            np.testing.assert_allclose(got, reference["gpt3 logits"][lo:hi],
                                       atol=1e-4, rtol=0)
    if arch == F.GPT3:
        np.testing.assert_allclose(one, reference["gpt3 logits"], atol=1e-4,
                                   rtol=0)


# ------------------------------------------------------------- blocks
class _Mesh:
    """A shape-only mesh with one rank's coordinates."""

    def __init__(self, dp, tp, coords):
        self.shape = {"data": dp, "model": tp}
        self.coords = coords


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _block(full, spec, mesh) -> tuple:
    return tuple(hi - lo for lo, hi in (block_range(n, e, mesh)
                                        for n, e in zip(full, spec)))


# the leaves a rank holds whole, beside the rules' own say
# (`param_shardings`): the router, and the group-shared B and C
WHOLE = ("w_router", "w_B", "w_C", "conv_B", "conv_C")
# the leaves a rank holds 1/tp of, and the dim (the expert dim, or the
# Mamba2 heads' head-major one; after the stacked layer axis)
SPLIT_DIM = {"w_gate": 1, "w_up": 1, "w_down": 1, "w_z": 2, "w_x": 2,
             "w_dt": 2, "conv_x": 2, "A_log": 1, "D": 1, "dt_bias": 1,
             "norm_w": 1, "w_out": 1}


@pytest.mark.parametrize("world", list(WORLDS))
def test_each_rank_holds_its_block(worlds, world):
    dp, tp = WORLDS[world]
    for rank, res in enumerate(_ranks(worlds, world)):
        assert res["coords"] == {"data": rank // tp, "model": rank % tp}
        mesh = _Mesh(dp, tp, res["coords"])
        for arch in F.ARCHES:
            cfg = get_config(arch)
            full = _flat(param_shapes(cfg))
            for attn_pim in (False, True):
                got = res["layout"][arch, attn_pim]
                specs = _flat(param_shardings(
                    cfg, serve_rules(attn_pim=attn_pim), mesh))
                assert set(got["params"]) == set(full)
                for name, shape in got["params"].items():
                    assert shape == _block(full[name], specs[name], mesh), \
                        (arch, name)
                    leaf = name.rsplit("/", 1)[1]
                    if name.startswith("/layers/") and leaf in SPLIT_DIM:
                        dim = SPLIT_DIM[leaf]
                        assert shape[dim] * tp == full[name][dim], name
                    if name.startswith("/layers/") and leaf in WHOLE:
                        assert shape == full[name], name
                if "ssm" in got:
                    # the state: this data group's slots, the rank's heads
                    s = cfg.ssm
                    nh = s.n_heads(cfg.d_model)
                    slots = F.ENGINE["max_slots"] // dp
                    assert got["ssm"]["ssm"] == (
                        cfg.num_layers, slots, nh // tp, s.head_dim,
                        s.d_state)
                    assert got["ssm"]["conv_x"][-1] * tp == s.d_inner(
                        cfg.d_model)
                    assert got["ssm"]["conv_B"][-1] == s.d_state
                    spec = cache_shardings(
                        cfg, F.ENGINE["max_slots"], F.ENGINE["cache_capacity"],
                        serve_rules(attn_pim=attn_pim), mesh)["ssm"].ssm
                    assert spec[2] == "model"
        zamba = res["layout"][F.ZAMBA, True]
        shared = {k: v for k, v in zamba["params"].items()
                  if k.startswith("/shared/")}
        assert shared["/shared/attn/w_q"] == (128, 4 // tp, 32)
        assert shared["/shared/attn/w_k"] == (128, 4 // tp, 32)
        assert shared["/shared/mlp/w_down"] == (256 // tp, 128)
        assert zamba["k"][3] == 4 // tp                 # KV heads a rank
        olmoe = res["layout"][F.OLMOE, True]["params"]
        assert olmoe["/layers/moe/w_gate"] == (2, 4 // tp, 128, 64)


def test_a_rank_without_assignments_adds_zeros(worlds):
    """Every token routes to experts 0 and 1, rank 0's: rank 1 runs no
    expert (no `torch.cat` of nothing), and both ranks get the one-rank
    result."""
    for res in _ranks(worlds, "1,2"):
        got = res["idle_moe"]
        assert got["routed"] == [0, 1]
        assert got["experts"] == (2, 32, 16)
        assert got["err"] <= 1e-6


def test_gated_norm_sums_over_the_ranks(worlds):
    """The Mamba2 block on a rank's heads equals the whole block only with
    the gated RMSNorm's mean over every rank's heads: a per-rank mean is
    off by far more than the tolerance."""
    for res in _ranks(worlds, "1,2"):
        got = res["norm"]
        assert got["state"] == (2, 4, 32, 16)
        assert got["sum"] <= 1e-5
        assert got["per_rank_mean"] > 1e-3


# ------------------------------------------------------------- budget
class _StagedMesh(_Mesh):
    """A shape-only stand-in for a shared card's mesh: the engine reads its
    shape, coordinates, device and rank, and that it stages."""
    staged = True
    device = torch.device("cpu")
    rank = 0


# (arch, attn_pim, want at (1, 2)): the fetch, the MoE layers' count
# copies (2) and one staged copy per collective: the vocab split's 2, then
# per layer olmoe / granite-moe 1 out-projection + 1 expert combine (+ 2
# for the sequence-split slab's gathers without attn_pim), mamba2 2 per
# Mamba2 layer (norm, w_out), zamba2 2 per Mamba2 layer (4) and per shared
# application (2) the out-projection and down banks, gpt3 1 + 1 + 2.
BUDGETS = [("olmoe-1b-7b-smoke", True, 1 + 2 + 2 + 2 * 2),
           ("olmoe-1b-7b-smoke", False, 1 + 2 + 2 + 2 * 4),
           ("granite-moe-1b-a400m-smoke", True, 1 + 2 + 2 + 2 * 2),
           ("mamba2-1.3b-smoke", False, 1 + 2 + 2 * 2),
           ("zamba2-1.2b-smoke", True, 1 + 2 + 4 * 2 + 2 * 2),
           ("zamba2-1.2b-smoke", False, 1 + 2 + 4 * 2 + 2 * 4),
           ("gpt3-175b-smoke", False, 1 + 2 + 2 * 4)]


@pytest.mark.parametrize("arch, attn_pim, want", BUDGETS)
def test_transfer_budget_per_family(arch, attn_pim, want):
    """A steady iteration's transfers on a shared card: the counts of
    `models.collectives_per_forward`, plus the staged gather over "data"
    at (2, 2)."""
    cfg = get_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    for (dp, tp), extra in (((1, 2), 0), ((2, 2), 1)):
        mesh = _StagedMesh(dp, tp, {"data": dp - 1, "model": 1})
        eng = PapiEngine(cfg, params, mesh=mesh, device="cpu",
                         attn_pim=attn_pim, **F.ENGINE)
        assert eng.transfer_budget == want + extra


# ----------------------------------------------------------- launcher
def _lines(text: str) -> list[str]:
    """The launcher's deterministic lines (no wall-clock figures)."""
    return [ln for ln in text.splitlines()
            if ln and not ln.startswith(("tokens:", "mesh:"))
            and not re.search(r"\d+ms", ln)]


LAUNCH = ["--device", "cpu", "--requests", "3", "--capacity", "96",
          "--prefill-len", "32"]
LAUNCH_ARCHES = (F.OLMOE, F.GRANITE, F.MAMBA, F.ZAMBA)


@pytest.fixture(scope="module")
def one_device_lines():
    """The one-device launcher's output per arch."""
    out = {}
    for arch in LAUNCH_ARCHES:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_cli.main(["--arch", arch] + LAUNCH)
        out[arch] = buf.getvalue()
    return out


@pytest.mark.parametrize("shape", list(WORLDS))
@pytest.mark.parametrize("arch", LAUNCH_ARCHES)
def test_launcher_family_mesh_prints_the_one_device_lines(
        capfd, worlds, one_device_lines, arch, shape):
    serve_cli.main(["--arch", arch] + LAUNCH + ["--mesh", shape])
    out = capfd.readouterr().out
    dp, tp = WORLDS[shape]
    assert (f"mesh: {{'data': {dp}, 'model': {tp}}} over {dp * tp} ranks "
            "(gloo on cpu)") in out
    assert _lines(out) == _lines(one_device_lines[arch])
    assert "completed 3 requests" in out
