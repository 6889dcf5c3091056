"""The train cell with tp > 1 (sequence parallelism over "model", the
vocab-split cross-entropy, ZeRO-3 over "data") against one device.

One gloo world of 4 CPU ranks, started once for this module
(`launch.mesh.spawn_world`: rendezvous through a file under tmp_path,
every rank and the world bounded in time), runs every case while the
parent runs the one-device steps, then the JAX reference's
`forward_train` on the same weights (the port's seed-0 weights as a JAX
tree) and inputs; the rank bodies live in `tests/_mesh_train_tp_ranks.py`
(no jax):

  * the one-device oracle's first loss and gradients equal the
    reference's, so the mesh results below reach the reference through
    the same inputs;
  * `launch.steps.build_step`'s train step at (2, 2) and (1, 2) for the
    dense, VLM and audio smoke twins, accum 1 and 2, and at (1, 4) for
    the dense twin (accum 1 and 2; a 30-position cell, whose residual
    stays whole; a twin whose heads, FFN and vocabulary tp = 4 does not
    divide, so they stay whole): every rank's loss, the first step's
    gathered gradients and the gathered parameters and first moments
    after 3 steps equal the one-device step's on the global batch, and
    the steps run the collectives `collectives_per_train_step` reckons;
  * each rank holds exactly the rules' 2D blocks of every parameter and
    of both AdamW moments;
  * the (2, 2) checkpoint restores onto (4, 1) and onto one device, the
    (2, 1) one onto (2, 2), and two more steps equal the uninterrupted
    run's;
  * the MoE, SSM and hybrid twins at (1, 2) raise, naming the next slice;
  * `seq_gather` and `seq_scatter` equal `torch.cat` and the sum of the
    ranks' tensors, forward and backward.

Tolerances: loss 1e-5 relative, gradients 1e-5 of the largest,
parameters 1e-4 absolute (f32).
"""
import ast
import concurrent.futures
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _mesh_train_ranks as T1  # noqa: E402
import _mesh_train_tp_ranks as T  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro_torch.distributed.sharding import (axis_rules,  # noqa: E402
                                              block_range, train_rules)
from repro_torch.launch.mesh import spawn_world  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.model import (data_split,  # noqa: E402
                                      param_shapes, param_shardings)

# the world takes ~16 s alone on the CPU, ~26 s beside 5 other workers
WORLD_TIMEOUT_S = 120
CASES = ([((dp, 2), arch, accum, T.CELLS[arch]) for dp in (2, 1)
          for arch in T.ARCHES for accum in (1, 2)]
         + [((1, 4), arch, accum, cell) for arch, accum, cell in T.TP4])


def _case_id(case) -> str:
    shape, arch, accum, cell = case
    return f"{shape[0]}x{shape[1]}-{arch}-accum{accum}-seq{cell.seq_len}"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    dirs = (str(tmp_path_factory.mktemp("ckpt22")),
            str(tmp_path_factory.mktemp("ckpt21")))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(spawn_world, T.world, 4, device="cpu",
                      timeout_s=WORLD_TIMEOUT_S, args=dirs,
                      store_dir=tmp_path_factory.mktemp("world4"))
    yield fut
    pool.shutdown(wait=True)


def _steps(case) -> int:
    """The (2, 2) qwen2 run at accum 1 goes on to its checkpoint's end."""
    shape, arch, accum, _ = case
    main = shape == (2, 2) and arch == T.MAIN and accum == 1
    return T.STEPS + T.MORE if main else T.STEPS


def _oracle_key(case) -> tuple:
    shape, arch, accum, cell = case
    return arch, accum, shape[0], cell.seq_len


@pytest.fixture(scope="module")
def one_device(world):
    """The port's one-device steps on each case's global batches, run
    while the world runs (on one thread: the smoke twins' ops are too
    small to share)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for case in CASES:
            key = _oracle_key(case)
            if key not in out:
                out[key] = T.one_device(case[1], case[2], case[0][0],
                                        case[3], steps=_steps(case))
    finally:
        torch.set_num_threads(threads)
    return out


def _jax_tree(tree: dict) -> dict:
    """A port params tree as the reference's (f32 arrays)."""
    return {k: _jax_tree(v) if isinstance(v, dict)
            else jnp.asarray(v.numpy()) for k, v in tree.items()}


def _flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v, np.float32)})
    return out


@pytest.fixture(scope="module")
def reference(one_device):
    """The reference's `forward_train` loss and gradients, on the port's
    seed-0 weights and the first global batch of each (2, 2) case."""
    out = {}
    for arch in T.ARCHES:
        jc = jax_config(arch[:-len("-smoke")]).reduced()
        jp = _jax_tree(init_params(T.config(arch),
                                   torch.Generator().manual_seed(0)))
        batch = T1.global_batch(T.config(arch), T.CELLS[arch], 1, 0, 2)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: jm.forward_train(jc, p, b)[0]))(
                jp, jax.tree.map(jnp.asarray, batch))
        out[arch] = {"loss": float(loss), "grads": _flat(grads)}
    return out


def _ranks(world) -> list:
    return world.result()


def _close_losses(got, want) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-5 * abs(b), (got, want)


def _close_trees(got: dict, want: dict, atol: float) -> None:
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol,
                                   err_msg=key)


def _close_grads(got: dict, want: dict) -> None:
    top = max(float(np.abs(g).max()) for g in want.values())
    _close_trees(got, want, 1e-5 * top)


def _members(shape: tuple, accum: int) -> range:
    """The world ranks of a case: every rank but at (1, 2), where accum 1
    ran on ranks 0-1 and accum 2 on ranks 2-3."""
    if shape == (1, 2):
        return range(2 * (accum - 1), 2 * (accum - 1) + 2)
    return range(4)


@pytest.mark.parametrize("arch", T.ARCHES)
def test_one_device_oracle_equals_the_reference(one_device, reference,
                                                arch):
    want = reference[arch]
    got = one_device[(arch, 1, 2, T.CELLS[arch].seq_len)]
    _close_losses(got["losses"][:1], [want["loss"]])
    _close_grads(got["grads"], want["grads"])


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_train_step_equals_one_device(world, one_device, case):
    ranks = _ranks(world)
    shape, arch, accum, cell = case
    key = T.case_key(shape, arch, accum, cell)
    members = _members(shape, accum)
    lead = ranks[members[0]]["cases"][key]
    want = one_device[_oracle_key(case)]
    for r in members:
        got = ranks[r]["cases"][key]
        assert got["losses"] == lead["losses"]
        assert got["collectives"] == got["reckoned"] > 0
    assert len(lead["losses"]) == _steps(case)
    _close_losses(lead["losses"], want["losses"])
    _close_trees(lead["params"], want["params"], 1e-4)
    _close_trees(lead["m"], want["m"], 1e-4)
    if accum == 1:
        _close_grads(lead["grads"], want["grads"])


class _Mesh:
    """A shape-only mesh with one rank's coordinates."""

    def __init__(self, shape: tuple, coords: dict):
        self.shape = {"data": shape[0], "model": shape[1]}
        self.coords = coords


def _blocks(cfg, shape: tuple, coords: dict) -> dict:
    mesh = _Mesh(shape, coords)
    out = {}

    def walk(specs, shapes, prefix):
        for k in sorted(specs):
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(specs[k], dict):
                walk(specs[k], shapes[k], key)
            else:
                out[key] = tuple(hi - lo for lo, hi in (
                    block_range(n, e, mesh)
                    for n, e in zip(shapes[k], specs[k])))
    walk(param_shardings(cfg, train_rules(), mesh), param_shapes(cfg), "")
    return out


@pytest.mark.parametrize("case", [c for c in CASES if c[2] == 1],
                         ids=_case_id)
def test_each_rank_holds_its_2d_blocks(world, case):
    """Every leaf is the rank's block over "data" (its "fsdp" dim) and
    over "model" (heads, FFN, vocabulary; whole where tp does not divide
    it), and both moments take the parameters' blocks."""
    shape, arch, accum, cell = case
    cfg = T.config(arch)
    whole = _blocks(cfg, (1, 1), {"data": 0, "model": 0})
    ranks = _ranks(world)
    both = set()
    for r in _members(shape, accum):
        coords = ranks[r]["coords"][f"{shape[0]}{shape[1]}"]
        want = _blocks(cfg, shape, coords)
        got = ranks[r]["cases"][T.case_key(shape, arch, accum, cell)]
        assert got["shapes"]["params"] == want
        assert got["shapes"]["m"] == want and got["shapes"]["v"] == want
        both |= {k for k, b in want.items()
                 if sum(x != y for x, y in zip(b, whole[k])) == 2}
    if shape == (2, 2):          # the FFN and out-projection blocks are 2D
        assert "layers/attn/w_o" in both
    if arch == T.WHOLE:          # heads, FFN and vocabulary stay whole
        assert want == whole


def test_checkpoints_restore_across_meshes(world):
    """The (2, 2) checkpoint at step 3 onto (4, 1) and onto one device,
    and the (2, 1) checkpoint onto (2, 2): steps 4 and 5 equal the
    uninterrupted runs'."""
    ranks = _ranks(world)
    cell = T.CELLS[T.MAIN]
    full22 = ranks[0]["cases"][T.case_key((2, 2), T.MAIN, 1, cell)]
    full21 = ranks[0]["uninterrupted21"]
    for full in (full22, full21):
        assert len(full["losses"]) == T.STEPS + T.MORE
    cfg = T.config(T.MAIN)
    for res in ranks:
        _close_losses(res["resumed41"]["losses"], full22["losses"][T.STEPS:])
        _close_losses(res["resumed22"]["losses"], full21["losses"][T.STEPS:])
        for mesh, shape in (("41", (4, 1)), ("22", (2, 2))):
            blocks = _blocks(cfg, shape, res["coords"][mesh])
            assert res[f"restored{mesh}"]["params"] == blocks
            assert res[f"restored{mesh}"]["m"] == blocks
    _close_losses(ranks[0]["resumed1"]["losses"], full22["losses"][T.STEPS:])
    for key, full in (("resumed41", full22), ("resumed1", full22),
                      ("resumed22", full21)):
        _close_trees(ranks[0][key]["params"], full["params"], 1e-4)
        _close_trees(ranks[0][key]["m"], full["m"], 1e-4)


@pytest.mark.parametrize("arch", T.REFUSED)
def test_moe_ssm_hybrid_at_tp2_name_the_next_slice(arch):
    cfg = T.config(arch)
    mesh = _Mesh((1, 2), {"data": 0, "model": 0})
    with pytest.raises(ValueError, match="later slice.*next one") as err:
        build_step(cfg, T.CELLS[T.MAIN], mesh)
    assert "tp > 1" in str(err.value)
    with axis_rules(train_rules(), mesh):
        with pytest.raises(ValueError, match="later slice.*next one"):
            data_split(cfg)


@pytest.mark.parametrize("at", [0, 1], ids=["tp2", "tp4"])
def test_seq_gather_and_scatter_equal_cat_and_sum(world, at):
    """`seq_gather` is `torch.cat` of the ranks' blocks and its backward
    the ranks' upstream gradients summed, this rank's block kept;
    `seq_scatter` is this rank's block of the ranks' sum and its backward
    `torch.cat` of their upstream blocks; one collective each way."""
    ranks = _ranks(world)
    members = range(2) if at == 0 else range(4)
    for r in members:
        got = ranks[r]["collectives"][at]
        tp, me, n = got["tp"], got["rank"], T.COLL_SHAPE[1]
        assert (tp, me) == (2 * (at + 1), r)
        x = T.coll_tensor(0, tp)
        ups = [T.coll_tensor(100 + j, tp) for j in range(tp)]
        parts = [T.coll_tensor(200 + j, tp) for j in range(tp)]
        blocks = [T.coll_tensor(300 + j, tp).narrow(1, j * n, n)
                  for j in range(tp)]
        assert torch.equal(got["gathered"], torch.cat(
            [x.narrow(1, j * n, n) for j in range(tp)], dim=1))
        torch.testing.assert_close(got["gather_grad"],
                                   sum(ups).narrow(1, me * n, n))
        torch.testing.assert_close(got["scattered"],
                                   sum(parts).narrow(1, me * n, n))
        assert torch.equal(got["scatter_grad"], torch.cat(blocks, dim=1))
        assert got["count"] == 4


def test_rank_bodies_import_neither_jax_nor_repro():
    """The spawned ranks import `tests/_mesh_train_tp_ranks.py` (and
    `_mesh_train_ranks.py`) only."""
    for mod in (T, T1):
        tree = ast.parse(Path(mod.__file__).read_text())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.level == 0}
        assert not {n for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")}
