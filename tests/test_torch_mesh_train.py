"""The train cell over the data axis (ZeRO-3) against one device.

One gloo world of 4 CPU ranks, started once for this module
(`launch.mesh.spawn_world`: rendezvous through a file under tmp_path,
every rank and the world bounded in time), runs every case while the
parent runs the one-device steps and the reference's; the rank bodies
live in `tests/_mesh_train_ranks.py` (no jax):

  * `launch.steps.build_step`'s train step on (2, 1) and (4, 1) meshes of
    the dense, MoE, SSM, hybrid, audio and VLM smoke twins, accum 1 and
    2, rank r drawing the pipeline's shard r: every rank's loss, the
    first step's gathered gradients and the gathered parameters after 3
    steps equal the one-device step's on the global batch (every shard's
    microbatch i in shard order), and each step runs the collectives
    `collectives_per_train_step` reckons;
  * each rank holds exactly the rules' blocks of every parameter and of
    both AdamW moments;
  * a checkpoint saved over the (2, 1) mesh after 3 steps restores onto
    (4, 1) and onto one device, and two more steps equal the
    uninterrupted run's; a checkpoint the reference wrote restores onto
    (2, 1) and trains as the reference's `build_step` does;
  * a rank given fewer tokens than an MoE group raises.

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
import _mesh_train_ranks as T  # noqa: E402
from repro import models as jm  # noqa: E402
from repro import training as jt  # noqa: E402
from repro.configs import ShapeCell as JaxCell  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch.steps import build_step as jax_build_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.sharding import (block_range,  # noqa: E402
                                              train_rules)
from repro_torch.launch.mesh import spawn_world  # noqa: E402
from repro_torch.models.model import (param_shapes,  # noqa: E402
                                      param_shardings)

WORLD_TIMEOUT_S = 90
CASES = [(dp, arch, accum) for dp in (2, 4) for arch in T.ARCHES
         for accum in (1, 2)]


@pytest.fixture(scope="module")
def reference_params():
    jc = jax_config(T.MAIN[:-len("-smoke")]).reduced()
    return jc, jm.init_params(jc, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory, reference_params):
    """The checkpoint directory of the (2, 1) run, and one holding a
    checkpoint the reference wrote (its seed-0 qwen2 twin at step 0)."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    ref = tmp_path_factory.mktemp("ref_ckpt")
    _, jp = reference_params
    jt.CheckpointManager(str(ref)).save(
        0, {"params": jp, "opt": jt.init_adamw(jp)}, blocking=True)
    return str(ckpt), str(ref)


@pytest.fixture(scope="module")
def world(dirs, tmp_path_factory):
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(spawn_world, T.world, 4, device="cpu",
                      timeout_s=WORLD_TIMEOUT_S, args=dirs,
                      store_dir=tmp_path_factory.mktemp("world4"))
    yield fut
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def one_device(world, reference_params):
    """The port's one-device steps on each case's global batches, and the
    reference's `build_step` fn (jitted, a one-device Auto mesh) on the
    reference checkpoint's weights, run while the world runs (on one
    thread: the smoke twins' ops are too small to share)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {case: T.one_device(case[1], case[2], case[0])
               for case in CASES}
    finally:
        torch.set_num_threads(threads)
    jc, jp = reference_params
    cfg, cell = get_config(T.MAIN), T.CELLS[T.MAIN]
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    built = jax_build_step(jc, JaxCell(cell.name, cell.seq_len,
                                       cell.global_batch, "train"), mesh)
    fn, js, losses = jax.jit(built.fn), jt.init_adamw(jp), []
    for step in range(T.STEPS):
        batch = T.global_batch(cfg, cell, 1, step, 2)
        jp, js, loss = fn(jp, js, jax.tree.map(jnp.asarray, batch))
        losses.append(float(loss))
    out["reference"] = {"losses": losses, "params": _jax_flat(jp)}
    return out


def _jax_flat(tree) -> dict:
    return {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


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


@pytest.mark.parametrize("dp,arch,accum", CASES)
def test_train_step_equals_one_device(world, one_device, dp, arch, accum):
    ranks = _ranks(world)
    case = (dp, arch, accum)
    # (2, 1): accum 1 ran on ranks 0-1, accum 2 on ranks 2-3
    members = range(4) if dp == 4 else range(2 * (accum - 1),
                                             2 * (accum - 1) + 2)
    lead = ranks[members[0]]["cases"][case]
    want = one_device[case]
    for r in members:
        got = ranks[r]["cases"][case]
        assert got["losses"] == lead["losses"]
        assert got["collectives"] == got["reckoned"] > 0
    _close_losses(lead["losses"], want["losses"])
    _close_trees(lead["params"], want["params"], 1e-4)
    _close_trees(lead["m"], want["m"], 1e-4)
    if accum == 1:
        top = max(float(np.abs(g).max()) for g in want["grads"].values())
        _close_trees(lead["grads"], want["grads"], 1e-5 * top)


class _Mesh:
    """A shape-only mesh with one rank's coordinates."""

    def __init__(self, dp, coords):
        self.shape = {"data": dp, "model": 1}
        self.coords = coords


def _blocks(cfg, dp, coords) -> dict:
    mesh = _Mesh(dp, coords)
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


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("arch", T.ARCHES)
def test_each_rank_holds_its_blocks(world, dp, arch):
    """Every "fsdp" leaf is the rank's 1/dp block of that dim, the other
    leaves whole; both moments take the parameters' blocks."""
    cfg = get_config(arch)
    split = False
    for rank, res in enumerate(_ranks(world)):
        if dp == 2 and rank >= 2:
            continue
        coords = res["coords4"] if dp == 4 else res["coords2"]
        want = _blocks(cfg, dp, coords)
        shapes = res["cases"][(dp, arch, 1)]["shapes"]
        assert shapes["params"] == want
        assert shapes["m"] == want and shapes["v"] == want
        split |= any(s != f for s, f in zip(
            want.values(), _blocks(cfg, 1, {"data": 0, "model": 0}).values()))
    assert split


def test_elastic_restore_onto_4x1_and_one_device(world):
    """The (2, 1) checkpoint at step 3, restored onto (4, 1) and onto one
    device: steps 4 and 5 equal the uninterrupted run's."""
    ranks = _ranks(world)
    full = ranks[0]["uninterrupted"]
    assert len(full["losses"]) == T.RESUME_AT + T.RESUME_STEPS
    want = full["losses"][T.RESUME_AT:]
    for res in ranks:
        _close_losses(res["resumed4"]["losses"], want)
    cfg = get_config(T.MAIN)
    for rank, res in enumerate(ranks):
        blocks = _blocks(cfg, 4, res["coords4"])
        assert res["restored_shapes"]["params"] == blocks
        assert res["restored_shapes"]["m"] == blocks
    for key in ("resumed4", "resumed1"):
        got = ranks[0][key]
        _close_trees(got["params"], full["params"], 1e-4)
        _close_trees(got["m"], full["m"], 1e-4)
    _close_losses(ranks[0]["resumed1"]["losses"], want)


def test_reference_checkpoint_restores_onto_2x1(world, one_device):
    """A checkpoint the reference wrote, restored onto (2, 1): 3 steps
    equal the reference's `build_step` fn on one device."""
    ranks = _ranks(world)
    want = one_device["reference"]
    for res in ranks[2:]:
        _close_losses(res["from_reference"]["losses"], want["losses"])
    _close_trees(ranks[2]["from_reference"]["params"], want["params"], 1e-4)


def test_rank_smaller_than_a_moe_group_is_refused(world):
    msg = _ranks(world)[0]["small_moe"]
    assert "straddle" in msg and "128 tokens" in msg, msg


def test_rank_bodies_import_neither_jax_nor_repro():
    """The spawned ranks import `tests/_mesh_train_ranks.py` only."""
    tree = ast.parse(Path(T.__file__).read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert not {n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "repro")}
