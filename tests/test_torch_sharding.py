"""The port's rule tables and spec resolution against
`repro.distributed.sharding` (pure logic, no processes).

The rule tables are compared key for key; `logical_to_spec`,
`filter_spec_for_shape` (divisibility drop, first dim wins, tuple axes)
and `fc_tensor_axis` run `tests/test_sharding.py`'s cases and its
properties on both packages with a shape-only mesh; and the per-leaf
param, cache and paged-cache specs of every assigned config at full width
equal the reference's resolved specs, as tuples, under the meshes (1, 2),
(1, 4), (1, 8) and (2, 4) and the serve (seq- and head-split) and train
rules.
"""
import sys
from pathlib import Path

import jax
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _propcompat import given, settings, st  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ASSIGNED  # noqa: E402
from repro.distributed import sharding as ref  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402


class FakeMesh:
    """Shape-only stand-in for a mesh (divisibility checks); coords for
    the port's block cuts."""
    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.coords = {a: 0 for a in shape}


MESH = FakeMesh(data=16, model=16)
POD = FakeMesh(pod=2, data=16, model=16)
MESHES = [(1, 2), (1, 4), (1, 8), (2, 4)]
RULES = {"serve": lambda: {"attn_pim": False},
         "serve_attn_pim": lambda: {"attn_pim": True}}


def _both(spec, shape, mesh):
    got = shd.filter_spec_for_shape(tuple(spec), shape, mesh)
    want = tuple(ref.filter_spec_for_shape(P(*spec), shape, mesh))
    assert got == want
    return got


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("long_context", [False, True])
@pytest.mark.parametrize("attn_pim", [False, True])
def test_serve_rules_equal_the_reference(multi_pod, long_context, attn_pim):
    assert shd.serve_rules(multi_pod, long_context, attn_pim) == \
        ref.serve_rules(multi_pod, long_context, attn_pim)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
def test_train_rules_equal_the_reference(multi_pod, fsdp):
    assert shd.train_rules(multi_pod, fsdp) == ref.train_rules(multi_pod,
                                                               fsdp)


def test_divisible_kept():
    assert _both(("data", "model"), (32, 64), MESH) == ("data", "model")


def test_indivisible_dropped():
    assert _both((None, "model"), (8, 14), MESH) == (None, None)


def test_duplicate_axis_first_wins():
    assert _both(("data", "model", "model"), (32, 64, 128), MESH) == (
        "data", "model", None)


def test_tuple_axes():
    assert _both((("pod", "data"), "model"), (64, 32), POD) == (
        ("pod", "data"), "model")


def test_tuple_axes_conflict():
    assert _both((("pod", "data"), "data"), (64, 32), POD) == (
        ("pod", "data"), None)


@given(st.lists(st.integers(1, 512), min_size=1, max_size=4))
@settings(max_examples=100, deadline=None)
def test_property_result_always_divides(shape):
    spec = _both(["model"] * len(shape), tuple(shape), MESH)
    for dim, entry in zip(shape, spec):
        if entry is not None:
            assert dim % MESH.shape[entry] == 0


@given(st.lists(st.sampled_from(["data", "model", None]), min_size=1,
                max_size=5))
@settings(max_examples=100, deadline=None)
def test_property_no_duplicate_axes(entries):
    spec = _both(entries, tuple([256] * len(entries)), MESH)
    used = [e for e in spec if e is not None]
    assert len(used) == len(set(used))


def test_rules_resolve_and_noop_outside_context():
    assert shd.logical_to_spec(("batch", "seq")) == (None, None)
    rules = {"batch": "data", "seq": "model"}
    with shd.axis_rules(rules):
        got = shd.logical_to_spec(("batch", "seq", None))
    with ref.axis_rules(rules):
        want = tuple(ref.logical_to_spec(("batch", "seq", None)))
    assert got == want == ("data", "model", None)
    assert shd.current_rules() is None and shd.current_mesh() is None


@pytest.mark.parametrize("bank", ["ffn", "heads", "kv_heads", "vocab"])
@pytest.mark.parametrize("attn_pim", [False, True])
@pytest.mark.parametrize("tp", [1, 2])
def test_fc_tensor_axis_equals_the_reference(bank, attn_pim, tp):
    mesh = FakeMesh(data=1, model=tp)
    rules = shd.serve_rules(attn_pim=attn_pim)
    assert shd.fc_tensor_axis(bank) == ref.fc_tensor_axis(bank) == (
        None, None)
    with shd.axis_rules(rules, mesh):
        got = shd.fc_tensor_axis(bank)
    with ref.axis_rules(rules, mesh):
        want = ref.fc_tensor_axis(bank)
    assert got[1] == want[1] and got[0] is mesh and want[0] is mesh


def test_local_block_cuts_each_rank():
    t = torch.arange(4 * 6).reshape(4, 6)
    mesh = FakeMesh(data=1, model=2)
    mesh.coords = {"data": 0, "model": 1}
    assert torch.equal(shd.local_block(t, (None, "model"), mesh), t[:, 3:])
    assert torch.equal(shd.local_block(t, ("model", None), mesh), t[2:])
    assert shd.local_block(t, (None, None), mesh) is t


def _leaves(tree, path=()):
    """{path: leaf} of a tree of dicts and NamedTuples whose leaves are
    spec tuples (tuples that are not NamedTuples)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (k,)))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_leaves(v, path + (k,)))
        return out
    return {path: tree}


def _ref_specs(axes, shapes, rules, mesh) -> dict:
    axes = _leaves(axes)
    shapes = {p: s.shape for p, s in _leaves(jax.tree.map(
        lambda x: x, shapes, is_leaf=lambda x: hasattr(x, "shape"))).items()}
    out = {}
    for path, ax in axes.items():
        with ref.axis_rules(rules, mesh):
            spec = ref.logical_to_spec(ax)
        out[path] = tuple(ref.filter_spec_for_shape(spec, shapes[path],
                                                    mesh))
    return out


@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=[f"{d}x{t}" for d, t in MESHES])
@pytest.mark.parametrize("jcfg", ASSIGNED, ids=lambda c: c.name)
def test_per_leaf_specs_equal_the_reference(jcfg, mesh_shape):
    dp, tp = mesh_shape
    mesh = FakeMesh(data=dp, model=tp)
    cfg = get_config(jcfg.name)
    tables = [shd.serve_rules(), shd.serve_rules(attn_pim=True),
              shd.train_rules()]
    for rules in tables:
        got = _leaves(port_model.param_shardings(cfg, rules, mesh))
        want = _ref_specs(ref_model.param_logical_axes(jcfg),
                          ref_model.param_shapes(jcfg), rules, mesh)
        assert got == want
        if not jcfg.has_decode_step:
            continue
        got = _leaves(port_model.cache_shardings(cfg, 8, 256, rules, mesh))
        want = _ref_specs(
            ref_model.cache_logical_axes(jcfg),
            jax.eval_shape(lambda: ref_model.init_cache(jcfg, 8, 256)),
            rules, mesh)
        assert got == want
        if jcfg.family not in ("dense", "moe", "vlm"):
            continue
        got = _leaves(port_model.paged_cache_shardings(cfg, 8, 129, 16, 64,
                                                       rules, mesh))
        want = _ref_specs(
            ref_model.paged_cache_logical_axes(jcfg),
            jax.eval_shape(lambda: ref_model.init_paged_cache(
                jcfg, 8, 129, 16, 64)), rules, mesh)
        assert got == want


def test_serve_rules_split_what_the_slice_expects():
    """qwen2-0.5b at (1, 2): heads, FFN and vocabulary split; the slab by
    sequence under the default rules and by KV head under attn_pim."""
    cfg = get_config("qwen2-0.5b")
    mesh = FakeMesh(data=1, model=2)
    p = port_model.param_shardings(cfg, shd.serve_rules(), mesh)
    assert p["layers"]["attn"]["w_q"] == (None, None, "model", None)
    assert p["layers"]["attn"]["w_k"] == (None, None, None, None)
    assert p["layers"]["mlp"]["w_down"] == (None, "model", None)
    assert p["embed"]["w"] == ("model", None)
    c = port_model.cache_shardings(cfg, 8, 256, shd.serve_rules(), mesh)
    assert c["k"] == (None, "data", "model", None, None)
    c = port_model.cache_shardings(cfg, 8, 256,
                                   shd.serve_rules(attn_pim=True), mesh)
    assert c["k"] == (None, "data", None, "model", None)
