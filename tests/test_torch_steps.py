"""The shape cells and their steps (`launch/specs.py`, `launch/steps.py`)
against the JAX package's.

* `SHAPES`, `applicable_shapes`, `skipped_shapes`, the analytic
  `param_count` and `microbatch_plan` for every configuration and its
  smoke twin;
* `input_specs` / `cache_specs`: the same shapes, dtypes and accum as the
  reference's `ShapeDtypeStruct`s for every family and cell, on ``meta``;
* `choose_rules` (at the reference's 16e9 bytes) and `_batch_logical`;
  `zero1_logical_axes`;
* the one-device `build_step` train step (3 steps: loss within 1e-5
  relative, parameters within 1e-4, moments within 1e-4 relative) and
  the prefill and decode steps (logits and caches within 1e-4) against
  the reference's `build_step` fn, jitted on a one-device Auto mesh;
* what raises, naming the later slice: a MoE model's train cell with
  tp > 1; at dp > 1 a MoE or VLM model with its weights over "data" and
  a paged cache under the long-context table (the dense train and serve
  cells build);
* qwen2-0.5b's rank share of weights and moments at (2, 1) (its tied
  embedding stays whole).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jm  # noqa: E402
from repro import training as jt  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import ShapeCell, get_config  # noqa: E402
from repro_torch.data import to_device  # noqa: E402
from repro_torch.distributed.sharding import train_rules  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import init_cache, params_from_jax  # noqa: E402
from repro_torch.models.model import (param_logical_axes,  # noqa: E402
                                      param_shapes, param_shardings)
from repro_torch.serving.engine import check_mesh  # noqa: E402
from repro_torch.training import init_adamw, zero1_logical_axes  # noqa: E402
from repro_torch.training.tree import flatten  # noqa: E402

ALL = [c.name for c in tconfigs.ASSIGNED + tconfigs.PAPER_MODELS]
ASSIGNED = [c.name for c in tconfigs.ASSIGNED]


def _pairs(name):
    """(port cfg, reference cfg) for the config and its smoke twin."""
    return ((get_config(name), jconfigs.get_config(name)),
            (get_config(name + "-smoke"),
             jconfigs.get_config(name + "-smoke")))


def test_shape_cells_equal_the_reference():
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES)
    for name, cell in tconfigs.SHAPES.items():
        assert dataclasses.astuple(cell) == dataclasses.astuple(
            jconfigs.SHAPES[name])
        assert cell.is_decode == jconfigs.SHAPES[name].is_decode
    assert tconfigs.arch_names() == jconfigs.arch_names()


@pytest.mark.parametrize("name", ALL)
def test_param_count_and_microbatch_plan_equal_the_reference(name):
    for cfg, jc in _pairs(name):
        assert cfg.param_count() == jc.param_count()
        assert cfg.has_subquadratic_path == jc.has_subquadratic_path
        assert tconfigs.applicable_shapes(cfg) == \
            jconfigs.applicable_shapes(jc)
        assert tconfigs.skipped_shapes(cfg) == jconfigs.skipped_shapes(jc)
        for cell_name, cell in tconfigs.SHAPES.items():
            for shards in (1, 2, 3, 4, 16, 64):
                assert tconfigs.microbatch_plan(cfg, cell, shards) == \
                    jconfigs.microbatch_plan(jc, jconfigs.SHAPES[cell_name],
                                             shards)


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return jnp.dtype(x.dtype).name


def _leaves(tree) -> dict:
    """{key: (shape, dtype)} of a spec tree of either package."""
    if isinstance(tree, dict) or hasattr(tree, "_fields"):
        items = (tree.items() if isinstance(tree, dict)
                 else zip(tree._fields, tree))
        out = {}
        for k, v in items:
            out.update({f"{k}/{kk}": vv for kk, vv in _leaves(v).items()})
        return out
    return {"": (tuple(tree.shape), _dtype(tree))}


@pytest.mark.parametrize("name", ASSIGNED)
def test_input_and_cache_specs_equal_the_reference(name):
    for cfg, jc in _pairs(name):
        for cell_name, cell in tconfigs.SHAPES.items():
            for shards in (16, 2):
                b, c, accum = tspecs.input_specs(cfg, cell, shards)
                jb, jcache, jaccum = jspecs.input_specs(
                    jc, jconfigs.SHAPES[cell_name], shards)
                assert accum == jaccum
                assert _leaves(b) == _leaves(jb), (cfg.name, cell_name)
                assert all(t.device.type == "meta"
                           for t in [*b.values()])
                if jcache is None:
                    assert c is None
                else:
                    assert _leaves(c) == _leaves(jcache), (cfg.name,
                                                           cell_name)
    # the decoders' cache specs are `init_cache`'s leaves
    cfg = get_config("zamba2-1.2b-smoke")
    got = _leaves(tspecs.cache_specs(cfg, 2, 64))
    assert got == _leaves(init_cache(cfg, 2, 64, "meta"))


class _Mesh:
    """A shape-only mesh (and the reference's view of one)."""

    def __init__(self, shape: dict, coords: dict | None = None):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.coords = coords or {k: 0 for k in shape}


MESHES = [{"data": 1, "model": 1}, {"data": 2, "model": 1},
          {"data": 16, "model": 16}, {"data": 1, "model": 4},
          {"pod": 2, "data": 16, "model": 16}]


@pytest.mark.parametrize("name", ALL)
def test_choose_rules_equals_the_reference(name):
    for cfg, jc in _pairs(name):
        for cell_name, cell in tconfigs.SHAPES.items():
            for shape in MESHES:
                got = tsteps.choose_rules(cfg, cell, _Mesh(shape),
                                          hbm_bytes=16e9)
                want = jsteps.choose_rules(jc, jconfigs.SHAPES[cell_name],
                                           _Mesh(shape))
                assert got == want, (cfg.name, cell_name, shape)
            for kind in ("train", "prefill", "decode"):
                c = ShapeCell("c", 64, 8, kind)
                assert tsteps._batch_logical(cfg, c) == \
                    jsteps._batch_logical(jc, c)


def test_choose_rules_sizes_the_threshold_for_the_card():
    """granite-8b's 16 GB of bf16 weights pass a v5e's 6 GB threshold
    but not an H100's 30 GB: it serves tensor-resident on the card;
    deepseek-67b's 134 GB do not fit either."""
    mesh = _Mesh({"data": 1, "model": 1})
    dec = tconfigs.SHAPES["decode_32k"]
    assert tsteps.WEIGHT_FSDP_SHARE * tsteps.HBM_BYTES == 30e9
    granite = get_config("granite-8b")
    assert tsteps.choose_rules(granite, dec, mesh, hbm_bytes=16e9)["fsdp"]
    assert tsteps.choose_rules(granite, dec, mesh)["fsdp"] is None
    assert tsteps.choose_rules(get_config("deepseek-67b"), dec,
                               mesh)["fsdp"] == "data"


@pytest.mark.parametrize("name", ASSIGNED)
def test_zero1_logical_axes_equal_the_reference(name):
    cfg, jc = _pairs(name)[0]
    got = zero1_logical_axes(param_logical_axes(cfg), param_shapes(cfg))
    want = jt.zero1_logical_axes(jm.param_logical_axes(jc),
                                 jm.param_shapes(jc))
    assert dict(flatten(got)) == {
        "/".join(str(getattr(p, "key", p)) for p in path): tuple(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, tuple))[0]}


def _one_device_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _jflat(tree) -> dict:
    return {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jspecs(tree) -> dict:
    """{key: spec tuple} of a tree of NamedShardings, padded to each
    leaf's rank as the port pads its specs."""
    out = {}
    for path, ns in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        out[key] = tuple(ns.spec)
    return out


def _tflat(tree) -> dict:
    return {k.replace(".", ""): v.detach().float().numpy()
            for k, v in flatten(tree)}


# family -> the train cell of its one-device parity case: the dense
# decoder (the reference's jitted step costs ~10 s of compile a family;
# `tests/test_torch_training.py` holds every family's `forward_train` and
# its gradients to the reference's, `tests/test_torch_mesh_train.py` every
# family's mesh step to this one)
TRAIN = {"qwen2-0.5b": ShapeCell("t", 32, 4, "train")}


@pytest.mark.parametrize("arch", list(TRAIN))
def test_one_device_train_step_equals_the_reference(arch):
    cfg, jc = _pairs(arch)[1]
    cell = TRAIN[arch]
    built = tsteps.build_step(cfg, cell)
    jbuilt = jsteps.build_step(jc, jconfigs.ShapeCell(*dataclasses.astuple(
        cell)), _one_device_mesh())
    assert built.accum == jbuilt.accum == 1 and built.kind == "train"
    assert _leaves(built.args[2]) == _leaves(jbuilt.args[2])
    # the params', moments' and batch's specs: the reference's shardings
    for got, want in ((built.in_shardings[0], jbuilt.in_shardings[0]),
                      (built.in_shardings[1].m, jbuilt.in_shardings[1].m),
                      (built.in_shardings[2], jbuilt.in_shardings[2])):
        assert dict(flatten(got)) == _jspecs(want)
    jp = jm.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu")
    js, ts = jt.init_adamw(jp), init_adamw(tp)
    fn = jax.jit(jbuilt.fn)
    for step in range(3):
        raw = tsteps.draw_train_batch(cfg, cell, step)
        jp, js, jloss = fn(jp, js, jax.tree.map(jnp.asarray, raw))
        tp, ts, tloss = built.fn(tp, ts, to_device(raw, "cpu"))
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert int(ts.step) == 3
    for got, want, tol in ((tp, jp, dict(rtol=0, atol=1e-4)),
                           (ts.m, js.m, dict(rtol=1e-4, atol=1e-7)),
                           (ts.v, js.v, dict(rtol=1e-4, atol=1e-9))):
        got, want = _tflat(got), _jflat(want)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                       **tol)


SERVE = ("qwen2-0.5b", "qwen2-vl-7b")


@pytest.mark.parametrize("arch", SERVE)
def test_one_device_prefill_and_decode_equal_the_reference(arch):
    """The prefill cell fills a 64-position cache with 32-token prompts;
    the decode cell's step then reads it (a VLM's with its position
    triple)."""
    cfg, jc = _pairs(arch)[1]
    mesh = _one_device_mesh()
    jp = jm.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu")
    pre, dec = ShapeCell("p", 32, 2, "prefill"), ShapeCell("d", 64, 2,
                                                          "decode")
    built = {c.kind: tsteps.build_step(cfg, c) for c in (pre, dec)}
    jbuilt = {c.kind: jsteps.build_step(jc, jconfigs.ShapeCell(
        *dataclasses.astuple(c)), mesh) for c in (pre, dec)}
    rng = np.random.default_rng(0)
    st = 32 - 32 // 4 if cfg.m_rope else 32
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, st),
                                    dtype=np.int32),
             "prompt_lens": np.full((2,), 32, np.int32)}
    if cfg.m_rope:
        batch["patch_embeds"] = rng.standard_normal(
            (2, 8, cfg.d_model)).astype(np.float32)
        batch["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.arange(32, dtype=np.int32)[None, None], (2, 3, 32)))
    jlog, jcache = jax.jit(jbuilt["prefill"].fn)(
        jp, jax.tree.map(jnp.asarray, batch), jm.init_cache(jc, 2, 64))
    tlog, tcache = built["prefill"].fn(tp, to_device(batch, "cpu"),
                                       init_cache(cfg, 2, 64, "cpu"))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    tok = rng.integers(0, cfg.vocab_size, (2, 1), dtype=np.int32)
    args = [jnp.asarray(tok)]
    targs = [torch.from_numpy(tok)]
    if cfg.m_rope:
        pos = np.full((2, 3, 1), 32, np.int32)
        args.append(jnp.asarray(pos))
        targs.append(torch.from_numpy(pos))
    jlog, jcache = jax.jit(jbuilt["decode"].fn)(jp, jcache, *args)
    tlog, tcache = built["decode"].fn(tp, tcache, *targs)
    assert tlog.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    key = "k" if "k" in tcache else "ssm"
    got = tcache[key] if key == "k" else tcache["ssm"].ssm
    want = jcache[key] if key == "k" else jcache["ssm"].ssm
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch,cell,shape,what", [
    ("qwen2-0.5b", "train_4k", {"data": 2, "model": 2}, "tp > 1"),
    ("qwen2-0.5b", "train_4k", {"data": 1, "model": 4}, "tp > 1"),
    ("deepseek-67b", "decode_32k", {"data": 2, "model": 1},
     "weight-stationary"),
    ("command-r-plus-104b", "prefill_32k", {"data": 2, "model": 1},
     "FSDP prefill"),
    ("mamba2-1.3b", "long_500k", {"data": 2, "model": 1}, "long-context"),
])
def test_later_slices_raise(arch, cell, shape, what):
    """The cells once refused here build now (meta stand-ins): the dense
    train cell with tp > 1, and at dp > 1 the 2D weight-stationary
    decode, the FSDP prefill and `long_500k`.  What still raises under
    their tables names the later slice: a MoE model's train cell with
    tp > 1, a MoE or VLM model with its weights over "data", a paged
    cache under the long-context table."""
    sc = tconfigs.SHAPES[cell]
    built = tsteps.build_step(get_config(arch), sc, _Mesh(shape))
    assert built.kind == sc.kind
    if what == "long-context":
        with pytest.raises(ValueError, match="later slice") as err:
            check_mesh(shape, built.rules, "ssm", "paged")
    else:
        other = ("olmoe-1b-7b" if cell in ("decode_32k", "train_4k")
                 else "qwen2-vl-7b")
        with pytest.raises(ValueError, match="later slice") as err:
            tsteps.build_step(get_config(other), sc, _Mesh(shape),
                              hbm_bytes=1.0)
    assert what in str(err.value)


def test_serve_cells_build_where_the_rules_are_plain():
    """At dp = 1 and under plain serve rules the serve cells build (meta
    stand-ins only): prefill and decode of each assigned decoder."""
    for name in ASSIGNED:
        cfg = get_config(name)
        for cell in tconfigs.applicable_shapes(cfg):
            if tconfigs.SHAPES[cell].kind == "train" or not cfg.decoder:
                continue
            built = tsteps.build_step(cfg, tconfigs.SHAPES[cell],
                                      _Mesh({"data": 1, "model": 4}))
            assert built.kind == tconfigs.SHAPES[cell].kind
            assert all(t.device.type == "meta"
                       for _, t in flatten(built.args[0]))


def test_qwen2_rank_share_at_2x1():
    """Under train_rules at tp = 1 qwen2-0.5b's tied embedding (151936 x
    896) carries no "fsdp" label: at 12 layers and dp = 2 a rank holds
    ~0.72 of the weights and moments, not 0.5."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), num_layers=12)
    whole = param_shapes(cfg)
    specs = param_shardings(cfg, train_rules(),
                            _Mesh({"data": 2, "model": 1}))
    assert "data" not in specs["embed"]["w"]
    full = block = 0
    for (key, shape), (_, spec) in zip(flatten(whole), flatten(specs)):
        n = int(np.prod(shape))
        full += n
        block += n // 2 if "data" in spec else n
    assert 0.70 < block / full < 0.74
