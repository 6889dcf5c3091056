"""The port's SSM path against `repro.models.ssm` and `repro.models.model`.

Inputs are numpy arrays from fixed seeds; weights go through
`params_from_jax`.  The port's `ssd_scan` plain version is held against
the Pallas `ssd_scan` in interpret mode, the sequential oracle
`ref.ssd_scan_ref` and the model's `_ssd_chunked` (y and the final
state, with and without an initial state) at the shapes of
tests/test_kernels.py, 1e-4 in f32.  The Mamba2 pieces (`_causal_conv`,
`_ssd_recurrent`, `mamba2_block`) and whole prefill + decode runs of the
mamba2-1.3b and zamba2-1.2b smoke twins (f32) are held to 1e-4 too.  A
ragged batch's oracle is the reference run on each prompt alone
(`_ssm_oracle.prompt_alone`): the port's prefill stops each row's SSM
state at its prompt's end, the reference's takes in the padding.  The
CUDA kernel's own cases are in tests/test_torch_kernels.py (``gpu``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.layers import attn_impl as jax_attn_impl  # noqa: E402
from repro.models.linear import fc_variant as jax_fc_variant  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from _ssm_oracle import prompt_alone, stack_rows  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHES = ("mamba2-1.3b", "zamba2-1.2b")
# (b, nh, l, hp, n, chunk) of tests/test_kernels.py's ssd_scan sweep
SHAPES = [(2, 2, 128, 32, 16, 32), (1, 4, 256, 64, 64, 64),
          (2, 1, 64, 64, 128, 64), (1, 2, 96, 32, 16, 32)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scan_inputs(seed, b, nh, l, hp, n):
    """x [b, l, nh, hp], dt [b, l, nh] (post-softplus), A [nh] in [-7.4, -1]
    (the realistic decays of tests/test_kernels.py), B/C [b, l, n], and an
    initial state [b, nh, hp, n]."""
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((b, l, nh, hp))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, nh)) - 1.0)).astype(
        np.float32)
    A = -np.exp(rng.uniform(0.0, 2.0, nh)).astype(np.float32)
    B = (0.5 * rng.standard_normal((b, l, n))).astype(np.float32)
    C = (0.5 * rng.standard_normal((b, l, n))).astype(np.float32)
    s0 = (0.5 * rng.standard_normal((b, nh, hp, n))).astype(np.float32)
    return x, dt, A, B, C, s0


_jax_chunked = jax.jit(jssm._ssd_chunked, static_argnums=5)


def _kernel_layout(x, dt, A):
    dtx = np.moveaxis(dt[..., None] * x, 1, 2).copy()       # [b, nh, l, hp]
    lt = np.moveaxis(dt * A[None, None, :], 1, 2).copy()   # [b, nh, l]
    return dtx, lt


# ---------------------------------------------------------------------------
# ssd_scan's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,nh,l,hp,n,chunk", SHAPES)
def test_ssd_scan_ref_matches_pallas_and_oracle(b, nh, l, hp, n, chunk):
    x, dt, A, B, C, _ = _scan_inputs(l + n, b, nh, l, hp, n)
    dtx, lt = _kernel_layout(x, dt, A)
    y, _ = ssd_mod.ssd_scan_ref(_t(dtx), _t(lt), _t(B), _t(C), chunk=chunk)
    pallas = jax_ssd_scan(jnp.asarray(dtx), jnp.asarray(lt), jnp.asarray(B),
                          jnp.asarray(C), chunk=chunk, interpret=True)
    oracle = jref.ssd_scan_ref(jnp.asarray(dtx), jnp.asarray(lt),
                               jnp.asarray(B), jnp.asarray(C))
    np.testing.assert_allclose(y.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("b,nh,l,hp,n,chunk", SHAPES)
def test_ssd_scan_ref_matches_model_chunked(b, nh, l, hp, n, chunk, init):
    """y and the final state against the JAX model's `_ssd_chunked`."""
    x, dt, A, B, C, s0 = _scan_inputs(7 * l + n, b, nh, l, hp, n)
    dtx, lt = _kernel_layout(x, dt, A)
    y, state = ssd_mod.ssd_scan_ref(_t(dtx), _t(lt), _t(B), _t(C),
                                    chunk=chunk,
                                    init_state=_t(s0) if init else None)
    jy, jstate = _jax_chunked(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(B),
        jnp.asarray(C), chunk, jnp.asarray(s0) if init else None)
    np.testing.assert_allclose(y.permute(0, 2, 1, 3).numpy(), np.asarray(jy),
                               **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **TOL)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_model_chunked_matches_reference(impl):
    """The port's `_ssd_chunked` (either `ssd_impl`) equals the JAX one."""
    b, nh, l, hp, n, chunk = 2, 2, 128, 32, 16, 32
    x, dt, A, B, C, s0 = _scan_inputs(3, b, nh, l, hp, n)
    with tm.ssd_impl(impl):
        y, state = tssm._ssd_chunked(_t(x), _t(dt), _t(A), _t(B), _t(C),
                                     chunk, _t(s0))
    jy, jstate = _jax_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk,
                              jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **TOL)


def test_ssd_scan_cpu_tensor_takes_plain_version_without_launch():
    x, dt, A, B, C, s0 = _scan_inputs(4, 1, 2, 64, 32, 16)
    dtx, lt = _kernel_layout(x, dt, A)
    args = (_t(dtx), _t(lt), _t(B), _t(C))
    before = ssd_mod.LAUNCHES
    y, state = ssd_mod.ssd_scan(*args, chunk=32, init_state=_t(s0),
                                out_dtype=torch.bfloat16)
    want_y, want_state = ssd_mod.ssd_scan_ref(*args, chunk=32,
                                              init_state=_t(s0),
                                              out_dtype=torch.bfloat16)
    assert ssd_mod.LAUNCHES == before
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    assert torch.equal(y, want_y) and torch.equal(state, want_state)


def test_ssd_scan_rejects_bad_inputs():
    x, dt, A, B, C, s0 = _scan_inputs(5, 1, 2, 64, 32, 16)
    dtx, lt = _kernel_layout(x, dt, A)
    dtx, lt, B, C = _t(dtx), _t(lt), _t(B), _t(C)
    with pytest.raises(ValueError):
        ssd_mod.ssd_scan(dtx, lt[:, :, :32], B, C)             # shapes
    with pytest.raises(ValueError):
        ssd_mod.ssd_scan(dtx, lt, B, C, init_state=_t(s0)[:, :1])
    with pytest.raises(TypeError):
        ssd_mod.ssd_scan(dtx, lt.double(), B, C)                # lt not f32
    with pytest.raises(TypeError):
        ssd_mod.ssd_scan(dtx, lt, B, C.to(torch.bfloat16))      # B != C
    with pytest.raises(ValueError, match="not divisible"):
        ssd_mod.ssd_scan(dtx, lt, B, C, chunk=48)               # 64 % 48


# ---------------------------------------------------------------------------
# Mamba2 pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32)
    y, new = tssm._causal_conv(_t(x), _t(w), _t(st) if with_state else None)
    jy, jnew = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(st) if with_state else None)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_stops_at_lens_like_the_prompt_alone(with_state):
    """Rows of 1, 2 and 3 valid inputs (K - 1 = 3) and a full one in a
    9-row window: each row's new history is the reference's on its valid
    rows alone, so a row shorter than K - 1 keeps the tail of its history
    (zeros without one); the valid output rows are the window's."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    st = rng.standard_normal((4, 3, 24)).astype(np.float32)
    lens = [1, 2, 3, 9]
    y, new = tssm._causal_conv(_t(x), _t(w), _t(st) if with_state else None,
                               lens=torch.tensor(lens, dtype=torch.int32))
    for r, n in enumerate(lens):
        jy, jnew = jssm._causal_conv(
            jnp.asarray(x[r:r + 1, :n]), jnp.asarray(w),
            jnp.asarray(st[r:r + 1]) if with_state else None)
        np.testing.assert_allclose(y[r:r + 1, :n].numpy(), np.asarray(jy),
                                   **TOL)
        np.testing.assert_allclose(new[r:r + 1].numpy(), np.asarray(jnew),
                                   **TOL)


@pytest.mark.parametrize("t", [1, 3])
def test_ssd_recurrent_matches_reference(t):
    x, dt, A, B, C, s0 = _scan_inputs(8 + t, 2, 2, t, 32, 16)
    state, out = _t(s0).clone(), torch.empty(s0.shape)
    y, got = tssm._ssd_recurrent(_t(x), _t(dt), _t(A), _t(B), _t(C), state,
                                 out)
    jy, jstate = jssm._ssd_recurrent(*map(jnp.asarray, (x, dt, A, B, C, s0)))
    assert got is out                         # written to `out`
    assert torch.equal(state, _t(s0))         # the state read is kept
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jstate), **TOL)


@pytest.fixture(scope="module")
def models():
    """{arch: (jcfg, jax params, cfg, port params)} of the smoke twins."""
    out = {}
    for arch in ARCHES:
        jcfg = jax_config(arch).reduced()
        cfg = get_config(arch + "-smoke")
        jp = jax.jit(jm.init_params, static_argnums=0)(
            jcfg, jax.random.PRNGKey(0))
        tp = tm.params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu")
        out[arch] = (jcfg, jp, cfg, tp)
    return out


@pytest.mark.parametrize("decode", [False, True])
def test_mamba2_block_matches_reference(models, decode):
    jcfg, jp, cfg, tp = models["mamba2-1.3b"]
    lp = {k: v[0] for k, v in tp["layers"]["ssm"].items()}
    jlp = {k: v[0] for k, v in jp["layers"]["ssm"].items()}
    rng = np.random.default_rng(9)
    b, l = 2, (1 if decode else 64)
    u = rng.standard_normal((b, l, cfg.d_model)).astype(np.float32)
    one = tssm.init_state(b, cfg.d_model, cfg.ssm, torch.float32, "cpu")
    st = [rng.standard_normal(tuple(x.shape)).astype(np.float32)
          for x in one]
    state = tssm.SSMState(*(_t(a).clone() for a in st))
    new = tssm.SSMState(*map(torch.empty_like, state)) if decode else None
    out, got = tssm.mamba2_block(_t(u), lp, cfg.ssm, cfg.d_model,
                                 state=state, decode=decode, out=new)
    jout, jstate = jax.jit(jssm.mamba2_block, static_argnums=(2, 3),
                           static_argnames="decode")(
        jnp.asarray(u), jlp, jcfg.ssm, jcfg.d_model,
        state=jssm.SSMState(*map(jnp.asarray, st)), decode=decode)
    # the prefill writes the state in place; the decode step writes
    # `out` and keeps the state it read
    assert got is (new if decode else state)
    if decode:
        assert all(torch.equal(x, _t(a)) for x, a in zip(state, st))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for mine, ref in zip(got, jstate):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

def test_smoke_twins_match_reference_configs():
    for arch in ARCHES:
        ref, mine = jax_config(arch).reduced(), get_config(arch + "-smoke")
        for f in dataclasses.fields(mine):
            a, b = getattr(mine, f.name), getattr(ref, f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
        assert (mine.num_attention_applications()
                == ref.num_attention_applications())
        assert mine.is_attention_free == ref.is_attention_free


@pytest.mark.parametrize("arch", ARCHES)
def test_model_spec_matches_reference(arch):
    from repro.models.model import model_spec as jax_model_spec
    ref = jax.tree.map(lambda ps: ps.shape, jax_model_spec(jax_config(arch)),
                       is_leaf=lambda x: hasattr(x, "logical"))
    mine = jax.tree.map(lambda ps: ps.shape, tm.model_spec(get_config(arch)),
                        is_leaf=lambda x: isinstance(x, tm.model.PSpec))
    assert mine == ref


@pytest.mark.parametrize("arch", ARCHES)
def test_bridge_keeps_a_log_and_dt_bias_f32_in_bf16(arch):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch + "-smoke"), dtype="bfloat16")
    jp = jax.jit(jm.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(1))
    tp = tm.params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu")
    own = tm.init_params(cfg, torch.Generator().manual_seed(1))
    for params in (tp, own):
        ssm = params["layers"]["ssm"]
        assert ssm["A_log"].dtype == ssm["dt_bias"].dtype == torch.float32
        assert ssm["w_x"].dtype == ssm["D"].dtype == torch.bfloat16
        assert params["embed"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["layers"]["ssm"]["A_log"].numpy(),
                                  np.asarray(jp["layers"]["ssm"]["A_log"]))
    # the init laws: A = -exp(A_log) in [-a_max, -a_min], dt in [1e-3, 0.1]
    a = -torch.exp(own["layers"]["ssm"]["A_log"])
    assert bool(((a >= -cfg.ssm.a_max) & (a <= -cfg.ssm.a_min)).all())
    dt = torch.nn.functional.softplus(own["layers"]["ssm"]["dt_bias"])
    assert bool(((dt > 0.99e-3) & (dt < 0.101)).all())


@pytest.mark.parametrize("arch,fc,attn", [
    ("mamba2-1.3b", "pu", "xla"), ("zamba2-1.2b", "pu", "xla"),
    ("zamba2-1.2b", "pim", "pim")])
def test_prefill_and_decode_match_reference(models, arch, fc, attn):
    """prefill of three ragged prompts in one window + 3 decode steps:
    logits within 1e-4 of the reference run on each prompt alone and
    greedy tokens equal (zamba2 also through the FC-PIM and Attn-PIM
    kernels' plain versions)."""
    jcfg, jp, cfg, tp = models[arch]
    rng = np.random.default_rng(10)
    n, P, cap = 3, 64, 96
    toks = rng.integers(3, cfg.vocab_size, size=(n, P)).astype(np.int32)
    lens = np.array([P, 40, 7], np.int32)
    alone = [prompt_alone(jcfg, jp, toks[r, :lens[r]].tolist(), cap)
             for r in range(n)]
    jl = jnp.stack([a[0] for a in alone])
    jc = stack_rows([a[1] for a in alone])
    # the FC / attention contexts are read while tracing: one program here
    with jax_fc_variant(fc), jax_attn_impl(attn):
        jdecode = jax.jit(jm.decode_step, static_argnums=0)
    tl, tc = tm.prefill(cfg, tp, {"tokens": _t(toks),
                                  "prompt_lens": _t(lens)},
                        tm.init_cache(cfg, n, cap, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    for _ in range(3):
        with jax_fc_variant(fc), jax_attn_impl(attn):
            jl, jc = jdecode(jcfg, jp, jc, jnp.asarray(tok))
        with tm.fc_variant(fc), tm.attn_impl(attn):
            tl, tc = tm.decode_step(cfg, tp, tc, _t(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert np.array_equal(tl.numpy().argmax(-1),
                              np.asarray(jl).argmax(-1))
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    for mine, ref in zip(tc["ssm"], jc["ssm"]):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("arch", ARCHES)
def test_decode_step_keeps_the_state_it_read(models, arch):
    """A decode step writes its new SSM state into fresh tensors, as it
    replaces ``pos``: the entries a caller kept still hold the pre-step
    state, and a re-run from them gives the same logits and state."""
    _, _, cfg, tp = models[arch]
    rng = np.random.default_rng(12)
    toks = rng.integers(3, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    _, cache = tm.prefill(cfg, tp, {"tokens": _t(toks),
                                    "prompt_lens": _t(np.array([16, 9],
                                                               np.int32))},
                          tm.init_cache(cfg, 2, 32, "cpu"))
    pre = dict(cache)
    kept = [x.clone() for x in pre["ssm"]]
    tok = _t(np.array([[5], [7]], np.int32))
    logits, cache = tm.decode_step(cfg, tp, cache, tok)
    assert cache["ssm"] is not pre["ssm"]
    assert all(torch.equal(x, y) for x, y in zip(pre["ssm"], kept))
    assert not torch.equal(cache["ssm"].ssm, pre["ssm"].ssm)
    again, redo = tm.decode_step(cfg, tp, dict(pre), tok)
    assert torch.equal(again, logits)
    assert all(torch.equal(x, y) for x, y in zip(redo["ssm"], cache["ssm"]))


@pytest.mark.parametrize("arch", ARCHES)
def test_prefill_to_slots_merges_ssm_state_like_reference(models, arch):
    """Three ragged prompts admitted into slots 2, 0 and 3 of a live
    cache: each admitted slot holds the reference's state on its prompt
    alone (and, zamba2, its prompt's KV), slot 1 is untouched."""
    jcfg, jp, cfg, tp = models[arch]
    rng = np.random.default_rng(11)
    slots, P, cap = 4, 32, 48
    toks = rng.integers(3, cfg.vocab_size, size=(3, P)).astype(np.int32)
    lens = np.array([P, 5, 2], np.int32)
    src = np.array([1, -1, 0, 2], np.int32)
    alone = [prompt_alone(jcfg, jp, toks[r, :lens[r]].tolist(), cap)
             for r in range(3)]
    # a live cache: slot 1 (untouched) must keep its state
    tc = tm.init_cache(cfg, slots, cap, "cpu")
    for x in tc["ssm"]:
        x.add_(0.25)
    tfirst, tc = tm.prefill_to_slots(
        cfg, tp, {"tokens": _t(toks), "prompt_lens": _t(lens)}, tc, _t(src))
    assert tfirst.tolist() == [
        -1 if r < 0 else int(np.argmax(np.asarray(alone[r][0])))
        for r in src]
    assert tc["pos"].tolist() == [0 if r < 0 else int(lens[r]) for r in src]
    for s, r in enumerate(src):
        if r < 0:
            continue
        jc = alone[r][1]
        for mine, ref in zip(tc["ssm"], jc["ssm"]):
            np.testing.assert_allclose(mine[:, s].numpy(),
                                       np.asarray(ref[:, 0]), **TOL)
        if "k" in tc:
            n = int(lens[r])
            for key in ("k", "v"):
                np.testing.assert_allclose(
                    tc[key][:, s, :n].numpy(), np.asarray(jc[key][:, 0, :n]),
                    **TOL)
    assert bool((tc["ssm"].ssm[:, 1] == 0.25).all())
    if "k" in tc:
        assert tc["k"].shape[0] == cfg.num_attention_applications()


@pytest.mark.parametrize("arch", ARCHES)
def test_stateful_families_refuse_pages_and_chunk_waves(models, arch):
    _, _, cfg, tp = models[arch]
    with pytest.raises(ValueError, match="no sequence dim to page"):
        tm.init_paged_cache(cfg, 2, 9, 16, None, "cpu")
    cache = tm.init_cache(cfg, 2, 32, "cpu")
    with pytest.raises(ValueError, match="chunked prefill"):
        tm.chunk_logits(cfg, tp, cache, torch.zeros((2, 8), dtype=torch.int32),
                        torch.full((2,), 8, dtype=torch.int32))
