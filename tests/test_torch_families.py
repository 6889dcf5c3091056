"""The port's other decoder families against the JAX package's.

The smoke twins (f32, 2 layers, d=128) of granite-8b (dense, rope_theta
1e7), command-r-plus-104b (layernorm), deepseek-67b (untied head),
granite-moe-1b-a400m and olmoe-1b-7b (MoE) and qwen2-vl-7b (the VLM
backbone: M-RoPE, QKV biases, untied head), with the reference's weights
through `params_from_jax` (norm weights and biases perturbed, so that
their multiplies are exercised) and inputs from seeded numpy.  Logits and
caches within 1e-4 abs + 1e-4 rel, greedy tokens identical:

* `layernorm`, `norm` and `apply_m_rope` (distinct (t, h, w) triples), in
  f32 and at bf16's rounding points;
* `prefill`, `prefill_to_slots`, `decode_step` (t = 1 and 3, under (pu,
  xla) and (pim, pim)), `chunk_logits`, `mixed_step` and
  `prefill_to_pages` with a paged `decode_step`, per family; qwen2-vl with
  ``patch_embeds`` too;
* command-r-plus through both engines, dense and paged: the same streams
  and per-iteration FC variants (the MoE engines: `test_torch_moe.py`);
* qwen2-vl against an oracle without the reference's M-RoPE prefill fault
  (ROADMAP queue 3): the reference's `prefill` with the broadcast position
  triple, then greedy `decode_step`.  The port's ``run()`` and ``serve()``
  equal it, dense and paged.  The reference's tokens-only `prefill`
  differs from its triple `prefill`: a strict xfail records that;
* the registry resolves all ten assigned architectures and their twins as
  the reference does; hubert's cache and decode steps are refused by the
  model, and hubert by the engine and the launcher.

The reference's side of each model comparison runs eagerly: one call per
case at two layers costs less than a jit compile.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import ASSIGNED as JAX_ASSIGNED  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.serving import PapiEngine as JaxEngine  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.serving import PapiEngine, ServeRequest  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHES = ["granite-8b", "command-r-plus-104b", "deepseek-67b",
          "granite-moe-1b-a400m", "olmoe-1b-7b", "qwen2-vl-7b"]
SLOTS, CAP, P, PAGE, BLOCKS = 4, 48, 8, 4, 8
ENGINE = dict(max_slots=4, cache_capacity=64, prefill_len=8, alpha=6.0,
              eos_token=1)
# prompts shorter than, equal to and longer than the 8-token window
REQS = [(i, np.random.default_rng(i).integers(3, 256, size=n).tolist(),
         2 + 3 * i) for i, n in enumerate([3, 8, 20, 5, 31, 2, 12, 40])]
VARIANTS = [("pu", "xla"), ("pim", "pim")]


def _perturb(jp, seed=0):
    """Norm weights 1 + 0.1 N(0, 1) and biases 0.1 N(0, 1), in place of the
    reference's ones and zeros."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=""):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = walk(val, key)
            elif key.startswith("norm") or path == "final_norm":
                out[key] = jnp.asarray(1 + 0.1 * rng.standard_normal(
                    val.shape), val.dtype)
            elif key.startswith("b_"):
                out[key] = jnp.asarray(0.1 * rng.standard_normal(val.shape),
                                       val.dtype)
            else:
                out[key] = val
        return out
    return walk(jp)


_MODELS: dict = {}


def _models(name):
    """(jcfg, jax params, cfg, torch params) of a smoke twin, built once."""
    if name not in _MODELS:
        jcfg, cfg = jax_config(name).reduced(), get_config(name + "-smoke")
        init = jax.jit(jm.init_params, static_argnums=0)
        jp = _perturb(init(jcfg, jax.random.PRNGKey(0)))
        tp = tm.params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu")
        _MODELS[name] = (jcfg, jp, cfg, tp)
    return _MODELS[name]


def _triple(positions):
    """[b, s] positions -> the broadcast [b, 3, s] M-RoPE triple."""
    b, s = positions.shape
    return np.broadcast_to(positions[:, None, :], (b, 3, s)).astype(np.int32)


def _batches(cfg, toks, lens):
    """(reference batch, port batch): the reference's carries the position
    triple for an M-RoPE model (its tokens-only prefill is at fault)."""
    jb = {"tokens": jnp.asarray(toks), "prompt_lens": jnp.asarray(lens)}
    if cfg.m_rope:
        jb["positions"] = jnp.asarray(_triple(np.broadcast_to(
            np.arange(toks.shape[1]), toks.shape)))
    return jb, {"tokens": torch.from_numpy(toks),
                "prompt_lens": torch.from_numpy(lens)}


def _prompts(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, cfg.vocab_size, size=(3, P)).astype(np.int32)
    return toks, np.array([P, 5, 2], np.int32), np.array([1, -1, 0, 2],
                                                         np.int32)


_ADMITTED: dict = {}


def _admitted(name):
    """Both packages' dense caches after one batched admission of three
    ragged prompts (slot 1 untouched), built once; tests clone them."""
    if name not in _ADMITTED:
        jcfg, jp, cfg, tp = _models(name)
        toks, lens, src = _prompts(cfg)
        jb, tb = _batches(cfg, toks, lens)
        jfirst, jc = jm.prefill_to_slots(jcfg, jp, jb,
                                         jm.init_cache(jcfg, SLOTS, CAP),
                                         jnp.asarray(src))
        tfirst, tc = tm.prefill_to_slots(cfg, tp, tb,
                                         tm.init_cache(cfg, SLOTS, CAP,
                                                       "cpu"),
                                         torch.from_numpy(src))
        _ADMITTED[name] = (np.asarray(jfirst), jc, tfirst.numpy(), tc)
    return _ADMITTED[name]


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _assert_cache_close(tc, jc, keys=("k", "v")):
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in keys:
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)


def _assert_logits_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))


# ---------------------------------------------------------------- layers
def test_layernorm_and_norm_match_reference():
    rng = np.random.default_rng(0)
    x = (3 + 2 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = jl.layernorm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = tl.layernorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for kind in ("rmsnorm", "layernorm"):
        np.testing.assert_allclose(
            tl.norm(torch.from_numpy(x), torch.from_numpy(w), kind,
                    1e-6).numpy(),
            np.asarray(jl.norm(jnp.asarray(x), jnp.asarray(w), kind, 1e-6)),
            **TOL)


@pytest.mark.parametrize("sections,hd", [((16, 24, 24), 128),
                                         ((8, 12, 12), 32),
                                         ((4, 6, 6), 32)])
def test_apply_m_rope_matches_reference(sections, hd):
    """Distinct (t, h, w) streams; (8, 12, 12) at hd 32 is the smoke
    twin's, whose sections overrun hd/2 = 16 slots and are cut, and
    (4, 6, 6) leaves slots that the last section fills."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 3000, size=(2, 3, 7)).astype(np.int32)
    want = jl.apply_m_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = tl.apply_m_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                          sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # one index in all three streams is plain RoPE
    same = _triple(pos[:, 0])
    np.testing.assert_allclose(
        tl.apply_m_rope(torch.from_numpy(x), torch.from_numpy(same), 1e6,
                        sections).numpy(),
        tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[:, 0]),
                      1e6).numpy(), **TOL)


def test_apply_m_rope_refuses_positions_without_three_streams():
    x = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="M-RoPE takes positions"):
        tl.apply_m_rope(x, torch.arange(4)[None, :], 1e6, (8, 12, 12))


@pytest.mark.parametrize("fn", ["layernorm", "apply_m_rope"])
def test_bf16_rounding_points_match(fn):
    """layernorm normalizes in f32 and casts before the scale; M-RoPE
    rotates f32 halves: at most one bf16 ulp apart, equal almost
    everywhere."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 4, 32)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)
    if fn == "layernorm":
        w = rng.standard_normal(32).astype(np.float32)
        want = jl.layernorm(jx, jnp.asarray(w, jnp.bfloat16))
        got = tl.layernorm(tx, torch.from_numpy(w).to(torch.bfloat16))
    else:
        pos = rng.integers(0, 2000, size=(2, 3, 3)).astype(np.int32)
        want = jl.apply_m_rope(jx, jnp.asarray(pos), 1e6, (4, 6, 6))
        got = tl.apply_m_rope(tx, torch.from_numpy(pos), 1e6, (4, 6, 6))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)
    same = (got.float().numpy() == np.asarray(want, np.float32)).mean()
    assert same > 0.9, same


# --------------------------------------------------------------- configs
def test_registry_resolves_every_assigned_arch_as_the_reference():
    assert [c.name for c in ASSIGNED] == [c.name for c in JAX_ASSIGNED]
    for ref in JAX_ASSIGNED:
        for name in (ref.name, ref.name + "-smoke"):
            want, got = jax_config(name), get_config(name)
            for f in dataclasses.fields(got):
                w, g = getattr(want, f.name), getattr(got, f.name)
                if dataclasses.is_dataclass(w):
                    w, g = dataclasses.asdict(w), dataclasses.asdict(g)
                assert g == w, (name, f.name)


def test_hubert_is_refused_by_model_engine_and_launcher():
    """The encoder has parameters (it trains: tests/test_torch_training.py)
    but no cache and no decode step."""
    cfg = get_config("hubert-xlarge-smoke")
    tm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="encoder-only"):
        tm.init_cache(cfg, 2, 16, "cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        tm.init_paged_cache(cfg, 2, 8, 4, None, "cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        PapiEngine(cfg, {}, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        serve_cli.main(["--arch", "hubert-xlarge-smoke", "--device", "cpu"])


@pytest.mark.parametrize("name", ARCHES)
def test_params_carry_every_reference_leaf(name):
    """The weight bridge carries the MoE leaves, the untied head and the
    biases; the port's own init gives the same tree."""
    jcfg, jp, cfg, tp = _models(name)
    flat_j = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {}

    def walk(tree, path):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, path + f"['{key}']")
            else:
                flat_t[path + f"['{key}']"] = val
    walk(tp, "")
    assert flat_t.keys() == flat_j.keys()
    for key, val in flat_j.items():
        np.testing.assert_array_equal(flat_t[key].numpy(), val)
    own = tm.init_params(cfg, torch.Generator().manual_seed(0))
    assert jax.tree.map(np.shape, own) == jax.tree.map(np.shape, jp)
    assert ("lm_head" in tp) == (not cfg.tie_embeddings)
    assert ("moe" in tp["layers"]) == (cfg.moe is not None)


# ---------------------------------------------------------- model steps
@pytest.mark.parametrize("name", ARCHES)
def test_prefill_matches(name):
    """The port's tokens-only prefill against the reference's (with the
    position triple for qwen2-vl): last logits and the KV."""
    jcfg, jp, cfg, tp = _models(name)
    toks, lens, _ = _prompts(cfg, seed=2)
    jb, tb = _batches(cfg, toks, lens)
    jlog, jc = jm.prefill(jcfg, jp, jb, jm.init_cache(jcfg, 3, P))
    tlog, tc = tm.prefill(cfg, tp, tb, tm.init_cache(cfg, 3, P, "cpu"))
    _assert_logits_close(tlog, jlog)
    _assert_cache_close(tc, jc)


@pytest.mark.parametrize("name", ARCHES)
def test_prefill_to_slots_first_tokens_and_cache(name):
    jfirst, jc, tfirst, tc = _admitted(name)
    np.testing.assert_array_equal(tfirst, jfirst)
    _assert_cache_close(tc, jc)


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("fc,attn", VARIANTS)
@pytest.mark.parametrize("name", ARCHES)
def test_decode_step_matches(name, fc, attn, t):
    jcfg, jp, cfg, tp = _models(name)
    _, jc, _, tc = _admitted(name)
    step = np.random.default_rng(3).integers(
        3, cfg.vocab_size, size=(SLOTS, t)).astype(np.int32)
    jlog, jc2 = jm.decode_step(jcfg, jp, jc, jnp.asarray(step))
    with tm.fc_variant(fc), tm.attn_impl(attn):
        tlog, tc2 = tm.decode_step(cfg, tp, _clone(tc),
                                   torch.from_numpy(step))
    _assert_logits_close(tlog, jlog)
    _assert_cache_close(tc2, jc2)


@pytest.mark.parametrize("name", ARCHES)
def test_chunk_logits_and_mixed_step_match(name):
    """A chunk wave (ragged chunk lengths, a slot not chunking) and a
    mixed wave (a pinned prefill row, decode rows of length 1)."""
    jcfg, jp, cfg, tp = _models(name)
    _, jc, _, tc = _admitted(name)
    rng = np.random.default_rng(4)
    toks = rng.integers(3, cfg.vocab_size, size=(SLOTS, P)).astype(np.int32)
    clens = np.array([P, 0, 3, 5], np.int32)
    jlog, jc2 = jm.chunk_logits(jcfg, jp, jc, jnp.asarray(toks),
                                jnp.asarray(clens))
    with tm.attn_impl("pim"):
        tlog, tc2 = tm.chunk_logits(cfg, tp, _clone(tc),
                                    torch.from_numpy(toks),
                                    torch.from_numpy(clens))
    _assert_logits_close(tlog, jlog)
    _assert_cache_close(tc2, jc2)

    mlens = np.array([1, 4, 1, 1], np.int32)
    pin = np.array([False, True, False, False])
    pin_pos = np.array([0, 6, 0, 0], np.int32)
    jlog, jc3 = jm.mixed_step(jcfg, jp, jc, jnp.asarray(toks),
                              jnp.asarray(mlens), jnp.asarray(pin),
                              jnp.asarray(pin_pos))
    with tm.fc_variant("pim"), tm.attn_impl("pim"):
        tlog, tc3 = tm.mixed_step(cfg, tp, _clone(tc),
                                  torch.from_numpy(toks),
                                  torch.from_numpy(mlens),
                                  torch.from_numpy(pin),
                                  torch.from_numpy(pin_pos))
    _assert_logits_close(tlog, jlog)
    _assert_cache_close(tc3, jc3)


@pytest.mark.parametrize("name", ARCHES)
def test_prefill_to_pages_and_paged_decode_match(name):
    """Admission onto shuffled pages, then a paged decode step (t = 2)
    through the paged Attn-PIM path; every page but the garbage page 0."""
    jcfg, jp, cfg, tp = _models(name)
    toks, lens, src = _prompts(cfg)
    rng = np.random.default_rng(5)
    num_pages = SLOTS * BLOCKS + 1
    tables = (rng.permutation(num_pages - 1) + 1).reshape(
        SLOTS, BLOCKS).astype(np.int32)
    jc = jm.init_paged_cache(jcfg, SLOTS, num_pages, PAGE, BLOCKS)
    jc["block_tables"] = jnp.asarray(tables)
    tc = tm.init_paged_cache(cfg, SLOTS, num_pages, PAGE, BLOCKS, "cpu")
    tc["block_tables"] = torch.from_numpy(tables)
    jb, tb = _batches(cfg, toks, lens)
    jfirst, jc = jm.prefill_to_pages(jcfg, jp, jb, jc, jnp.asarray(src))
    tfirst, tc = tm.prefill_to_pages(cfg, tp, tb, tc, torch.from_numpy(src))
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    step = rng.integers(3, cfg.vocab_size, size=(SLOTS, 2)).astype(np.int32)
    jlog, jc = jm.decode_step(jcfg, jp, jc, jnp.asarray(step))
    with tm.fc_variant("pim"), tm.attn_impl("pim"):
        tlog, tc = tm.decode_step(cfg, tp, tc, torch.from_numpy(step))
    _assert_logits_close(tlog, jlog)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key][:, 1:].numpy(),
                                   np.asarray(jc[key])[:, 1:], **TOL)


def test_vlm_prefill_with_patch_embeds_matches():
    """qwen2-vl: 6 patch embeddings on a 2 x 3 grid at t = 0 ahead of 5
    text tokens, each stream with its own positions."""
    jcfg, jp, cfg, tp = _models("qwen2-vl-7b")
    rng = np.random.default_rng(6)
    b, n_patch, n_text = 2, 6, 5
    patches = rng.standard_normal((b, n_patch, cfg.d_model)).astype(
        np.float32)
    toks = rng.integers(3, cfg.vocab_size, size=(b, n_text)).astype(np.int32)
    grid = np.stack([np.zeros(n_patch), np.arange(n_patch) // 3,
                     np.arange(n_patch) % 3])                      # t, h, w
    text = np.broadcast_to(3 + np.arange(n_text), (3, n_text))
    pos = np.broadcast_to(np.concatenate([grid, text], axis=1),
                          (b, 3, n_patch + n_text)).astype(np.int32)
    jlog, jc = jm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks),
                                      "patch_embeds": jnp.asarray(patches),
                                      "positions": jnp.asarray(pos)},
                          jm.init_cache(jcfg, b, n_patch + n_text))
    tlog, tc = tm.prefill(cfg, tp, {"tokens": torch.from_numpy(toks),
                                    "patch_embeds": torch.from_numpy(patches),
                                    "positions": torch.from_numpy(pos)},
                          tm.init_cache(cfg, b, n_patch + n_text, "cpu"))
    _assert_logits_close(tlog, jlog)
    _assert_cache_close(tc, jc)


# ---------------------------------------------------------------- engines
def _streams(results):
    return {r.req_id: (list(r.tokens), r.finished_reason) for r in results}


def _assert_drained(eng):
    if eng.kv is not None:
        eng.kv.alloc.check()
        assert eng.kv.alloc.mapped_count == 0
        assert eng.kv.alloc.free_count == eng.kv.alloc.num_pages


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_layernorm_engine_matches_reference_engine(layout):
    """command-r-plus (layernorm, GQA 2:1 at the smoke size) through both
    engines at alpha 4 with Attn-PIM: the same streams and the same FC
    variant every iteration, both variants run."""
    jcfg, jp, cfg, tp = _models("command-r-plus-104b")
    kw = dict(max_slots=8, alpha=4.0, attn_pim=True, kv_layout=layout)
    if layout == "paged":
        kw["page_size"] = 8
    ref = JaxEngine(jcfg, jp, **{**ENGINE, **kw})
    eng = PapiEngine(cfg, tp, device="cpu", **{**ENGINE, **kw})
    for i, prompt, budget in REQS:
        ref.submit(JaxRequest(i, prompt, budget))
        eng.submit(ServeRequest(i, prompt, budget))
    want = _streams(ref.run(max_iterations=300))
    assert _streams(eng.run(max_iterations=300)) == want
    assert [s.fc_variant for s in eng.stats] == [
        s.fc_variant for s in ref.stats]
    assert {"pu", "pim"} <= {s.fc_variant for s in eng.stats}
    _assert_drained(eng)


@pytest.fixture(scope="module")
def vlm_oracle():
    """Per request of REQS: the reference model's prefill of the whole
    prompt with the broadcast triple, then greedy decode_step to the
    budget (eos 1 ends a stream, as in the engine)."""
    jcfg, jp, _, _ = _models("qwen2-vl-7b")
    prefill = jax.jit(jm.prefill, static_argnums=0)
    step = jax.jit(jm.decode_step, static_argnums=0)
    out = {}
    for i, prompt, budget in REQS:
        n = len(prompt)
        toks = np.asarray(prompt, np.int32)[None, :]
        logits, cache = prefill(
            jcfg, jp, {"tokens": jnp.asarray(toks),
                       "prompt_lens": jnp.asarray([n], jnp.int32),
                       "positions": jnp.asarray(_triple(np.arange(n)[None]))},
            jm.init_cache(jcfg, 1, 64))
        stream = [int(np.argmax(np.asarray(logits)[0]))]
        while len(stream) < budget and stream[-1] != ENGINE["eos_token"]:
            logits, cache = step(jcfg, jp, cache,
                                 jnp.asarray([[stream[-1]]], jnp.int32))
            stream.append(int(np.argmax(np.asarray(logits)[0, -1])))
        out[i] = stream
    return out


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_vlm_engine_run_and_serve_equal_the_oracle(vlm_oracle, layout):
    """qwen2-vl's streams through the port's offline run() and its serve()
    (one arrival an iteration) equal the fault-free oracle's."""
    _, _, cfg, tp = _models("qwen2-vl-7b")
    kw = dict(max_slots=4, alpha=4.0, attn_pim=True, kv_layout=layout)
    if layout == "paged":
        kw["page_size"] = 8
    eng = PapiEngine(cfg, tp, device="cpu", **{**ENGINE, **kw})
    for i, prompt, budget in REQS:
        eng.submit(ServeRequest(i, prompt, budget))
    run = {r.req_id: list(r.tokens) for r in eng.run(max_iterations=300)}
    _assert_drained(eng)
    eng = PapiEngine(cfg, tp, device="cpu", **{**ENGINE, **kw})
    served = {ev.req_id: list(ev.result.tokens)
              for ev in eng.serve([[ServeRequest(i, p, b)]
                                   for i, p, b in REQS]) if ev.finished}
    _assert_drained(eng)
    assert run == served == vlm_oracle


@pytest.mark.xfail(strict=True, reason=(
    "the reference's tokens-only prefill gives apply_m_rope [1, s] "
    "positions; jnp.take fills the height and width rows with INT_MIN "
    "(ROADMAP queue 3)"))
def test_reference_tokens_only_prefill_equals_its_triple_prefill():
    jcfg, jp, cfg, _ = _models("qwen2-vl-7b")
    toks, lens, _ = _prompts(cfg, seed=7)
    jb, _ = _batches(cfg, toks, lens)
    want, _ = jm.prefill(jcfg, jp, jb, jm.init_cache(jcfg, 3, P))
    got, _ = jm.prefill(jcfg, jp, {"tokens": jb["tokens"],
                                   "prompt_lens": jb["prompt_lens"]},
                        jm.init_cache(jcfg, 3, P))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ["granite-8b-smoke", "qwen2-vl-7b-smoke"])
def test_launcher_serves_new_archs_on_cpu(arch, capsys):
    serve_cli.main(["--arch", arch, "--device", "cpu", "--requests", "4",
                    "--capacity", "128", "--prefill-len", "16",
                    "--max-prompt", "40", "--attn-pim", "--kv", "paged"])
    out = capsys.readouterr().out
    assert "completed 4 requests" in out
    assert "kv pages: watermark" in out
