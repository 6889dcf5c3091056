"""The port's dense model against `repro.models` on the same weights.

The JAX package's parameters go through `params_from_jax`; inputs are
numpy arrays from a fixed seed.  Reduced qwen2 (f32, 2 layers, d=128):
logits within 1e-4 and greedy argmax identical, under both FC variants
(pu / pim) and both decode-attention paths (xla / pim).  JAX's Pallas
kernels run in interpret mode on the CPU; the port's wrappers take their
plain PyTorch versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.layers import attn_impl as jax_attn_impl  # noqa: E402
from repro.models.linear import fc_variant as jax_fc_variant  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
SLOTS, CAP, P = 4, 48, 8


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("qwen2-0.5b").reduced()
    cfg = get_config("qwen2-0.5b-smoke")
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    # non-zero biases, so the bias path is exercised too
    rng = np.random.default_rng(0)
    jp["layers"]["attn"] = dict(jp["layers"]["attn"])
    for key in ("b_q", "b_k", "b_v"):
        shape = jp["layers"]["attn"][key].shape
        jp["layers"]["attn"][key] = jnp.asarray(
            0.1 * rng.standard_normal(shape), jnp.float32)
    tp = tm.params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, cfg, tp


@pytest.fixture(scope="module")
def prefilled(models):
    """Both caches after one batched admission of three ragged prompts
    (slot 1 stays untouched).  The port's cache is written in place, so
    tests take `_clone`s of it."""
    jcfg, jp, cfg, tp = models
    rng = np.random.default_rng(1)
    toks = rng.integers(3, cfg.vocab_size, size=(3, P)).astype(np.int32)
    lens = np.array([P, 5, 2], np.int32)
    src = np.array([1, -1, 0, 2], np.int32)
    jfirst, jc = jm.prefill_to_slots(
        jcfg, jp, {"tokens": jnp.asarray(toks), "prompt_lens":
                   jnp.asarray(lens)},
        jm.init_cache(jcfg, SLOTS, CAP), jnp.asarray(src))
    tfirst, tc = tm.prefill_to_slots(
        cfg, tp, {"tokens": torch.from_numpy(toks), "prompt_lens":
                  torch.from_numpy(lens)},
        tm.init_cache(cfg, SLOTS, CAP, "cpu"), torch.from_numpy(src))
    return np.asarray(jfirst), jc, tfirst.numpy(), tc


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def test_prefill_to_slots_first_tokens_and_cache(prefilled):
    jfirst, jc, tfirst, tc = prefilled
    np.testing.assert_array_equal(tfirst, jfirst)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), **TOL)


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("attn", ["xla", "pim"])
@pytest.mark.parametrize("fc", ["pu", "pim"])
def test_decode_step_logits_match(models, prefilled, fc, attn, t):
    jcfg, jp, cfg, tp = models
    _, jc, _, tc = prefilled
    tc = _clone(tc)
    step = np.random.default_rng(2).integers(
        3, cfg.vocab_size, size=(SLOTS, t)).astype(np.int32)
    with jax_fc_variant(fc, interpret=True), jax_attn_impl(attn):
        jl, jc2 = jm.decode_step(jcfg, jp, jc, jnp.asarray(step))
    with tm.fc_variant(fc), tm.attn_impl(attn):
        tl_, tc2 = tm.decode_step(cfg, tp, tc, torch.from_numpy(step))
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tl_.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
    np.testing.assert_array_equal(tc2["pos"].numpy(), np.asarray(jc2["pos"]))
    np.testing.assert_allclose(tc2["k"].numpy(), np.asarray(jc2["k"]), **TOL)


@pytest.mark.parametrize("attn", ["xla", "pim"])
def test_chunk_logits_and_prefill_chunk_match(models, prefilled, attn):
    """A chunk wave: ragged chunk lengths, one slot not chunking (0), KV
    writes masked per slot, positions advanced by the chunk lengths."""
    jcfg, jp, cfg, tp = models
    _, jc, _, tc = prefilled
    tc, tc3 = _clone(tc), _clone(tc)
    rng = np.random.default_rng(3)
    toks = rng.integers(3, cfg.vocab_size, size=(SLOTS, P)).astype(np.int32)
    clens = np.array([P, 0, 3, 5], np.int32)
    with jax_attn_impl(attn):
        jl, jc2 = jm.chunk_logits(jcfg, jp, jc, jnp.asarray(toks),
                                  jnp.asarray(clens))
        jn, _ = jm.prefill_chunk(jcfg, jp, jc, jnp.asarray(toks),
                                 jnp.asarray(clens))
    with tm.attn_impl(attn):
        tl_, tc2 = tm.chunk_logits(cfg, tp, tc, torch.from_numpy(toks),
                                   torch.from_numpy(clens))
    with tm.attn_impl(attn):
        tn, _ = tm.prefill_chunk(cfg, tp, tc3, torch.from_numpy(toks),
                                 torch.from_numpy(clens))
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tc2["pos"].numpy(), np.asarray(jc2["pos"]))
    np.testing.assert_allclose(tc2["k"].numpy(), np.asarray(jc2["k"]), **TOL)
    np.testing.assert_allclose(tc2["v"].numpy(), np.asarray(jc2["v"]), **TOL)


def test_write_kv_clamps_and_masked_write_drops():
    """`_write_kv` clamps a start that would overflow (the reference's
    dynamic_update_slice); `_write_kv_masked` drops rows past valid_lens
    and past the capacity."""
    from repro.models.model import _write_kv as j_write
    from repro.models.model import _write_kv_masked as j_write_masked
    from repro_torch.models.model import _write_kv, _write_kv_masked
    rng = np.random.default_rng(4)
    cache = rng.standard_normal((3, 10, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 4, 2, 4)).astype(np.float32)
    pos = np.array([0, 8, 5], np.int32)
    valid = np.array([4, 4, 1], np.int32)     # slot 1: rows 10, 11 > cap
    jk, _ = j_write(jnp.asarray(cache), jnp.asarray(cache), jnp.asarray(new),
                    jnp.asarray(new), jnp.asarray(pos))
    tk, _ = _write_kv(torch.from_numpy(cache.copy()),
                      torch.from_numpy(cache.copy()), torch.from_numpy(new),
                      torch.from_numpy(new), torch.from_numpy(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    jk, _ = j_write_masked(jnp.asarray(cache), jnp.asarray(cache),
                           jnp.asarray(new), jnp.asarray(new),
                           jnp.asarray(pos), jnp.asarray(valid))
    tk, _ = _write_kv_masked(torch.from_numpy(cache.copy()),
                             torch.from_numpy(cache.copy()),
                             torch.from_numpy(new), torch.from_numpy(new),
                             torch.from_numpy(pos), torch.from_numpy(valid))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("fn", ["rmsnorm", "apply_rope", "swiglu"])
def test_bf16_rounding_points_match(fn):
    """In bf16 the rounding points decide whether tokens match: rmsnorm's
    rsqrt cast, swiglu's f32 silu, RoPE's f32 halves."""
    from repro.models import layers as jl
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    if fn == "rmsnorm":
        w = rng.standard_normal(16).astype(np.float32)
        want = jl.rmsnorm(jx, jnp.asarray(w, jnp.bfloat16))
        got = tl.rmsnorm(tx, torch.from_numpy(w).to(torch.bfloat16))
    elif fn == "apply_rope":
        pos = np.array([[0, 7, 300], [5, 6, 1000]], np.int32)
        want = jl.apply_rope(jx, jnp.asarray(pos), 1e6)
        got = tl.apply_rope(tx, torch.from_numpy(pos), 1e6)
    else:
        p = {k: rng.standard_normal(s).astype(np.float32) * 0.25
             for k, s in (("w_gate", (16, 32)), ("w_up", (16, 32)),
                          ("w_down", (32, 16)))}
        want = jl.swiglu_mlp(jx, {k: jnp.asarray(v, jnp.bfloat16)
                                  for k, v in p.items()})
        got = tl.swiglu_mlp(tx, {k: torch.from_numpy(v).to(torch.bfloat16)
                                 for k, v in p.items()})
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)
    # at most one bf16 ulp apart anywhere, and equal almost everywhere
    same = (got.float().numpy() == np.asarray(want, np.float32)).mean()
    assert same > 0.9, same


@pytest.mark.parametrize("name", ["qwen2-0.5b", "qwen2-0.5b-smoke"])
def test_config_copy_matches_reference(name):
    """The port's own ModelConfig copy agrees with the reference on every
    field it keeps, and on the derived head dim and GQA group."""
    import dataclasses
    want, got = jax_config(name), get_config(name)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.resolved_head_dim == want.resolved_head_dim
    assert got.group_size == want.group_size


def test_flash_attention_blockwise_matches_reference():
    """The blockwise online-softmax prefill path (taken when the sequence
    divides the blocks) against the reference's, with small blocks."""
    from repro.models import layers as jl
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 32)).astype(np.float32)
    want = jl.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, q_block=8, kv_block=4)
    got = tl.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True, q_block=8,
                             kv_block=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dense = tl.dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)
