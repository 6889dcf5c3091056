"""The port's paged KV layout against the JAX package's.

Reduced qwen2 (f32, 2 layers, d=128) with the reference's weights through
`params_from_jax`, inputs from seeded numpy:
  * the paged attention's plain version against the Pallas paged kernel in
    interpret mode (rtol/atol 2e-5), bit-equal to the dense plain version
    on the same contents, blind to table entries past each length;
  * `init_paged_cache`, `prefill_to_pages`, a paged `decode_step` and a
    paged `chunk_logits` against the reference (1e-4) under (pu, xla) and
    (pim, pim);
  * `PapiEngine(kv_layout="paged")`: token streams and per-iteration pool
    counters identical to the reference engine's, with `attn_pim` off and
    on; streams identical to the port's dense engine; a request no dense
    slot holds completes; an over-subscribed pool defers and finishes
    everyone; the pool drains after every run; one host transfer per
    steady iteration; the launcher's ``--kv paged``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as pallas_paged  # noqa: E402
from repro.models.layers import attn_impl as jax_attn_impl  # noqa: E402
from repro.models.linear import fc_variant as jax_fc_variant  # noqa: E402
from repro.serving import PapiEngine as JaxEngine  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as attn_mod  # noqa: E402
from repro_torch.kernels import paged_decode_attention as paged_mod  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.serving import PapiEngine, ServeRequest  # noqa: E402

KTOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
SLOTS, P, PAGE, BLOCKS = 4, 8, 4, 6
ENGINE = dict(max_slots=4, cache_capacity=64, prefill_len=8, alpha=6.0,
              eos_token=1)
# prompts shorter than, equal to and longer than the 8-token window, and
# budgets that every dense 64-token slot holds too
REQS = [(i, np.random.default_rng(i).integers(3, 256, size=n).tolist(),
         2 + 3 * i) for i, n in enumerate([3, 8, 20, 5, 31, 2, 12, 40])]


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("qwen2-0.5b").reduced()
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("qwen2-0.5b-smoke")
    tp = tm.params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, cfg, tp


# ---------------------------------------------------------------------------
# the paged attention's plain version
# ---------------------------------------------------------------------------

def _paged_inputs(seed, t, b=3, nkv=2, g=4, hd=32, page=8, nblk=8):
    """Seeded q, a shuffled page pool (page 0 = garbage), ragged lens and
    tables mapping each request's blocks to distinct pages."""
    rng = np.random.default_rng(seed)
    num_pages = b * nblk + 1
    q = rng.standard_normal((b, nkv, t * g, hd)).astype(np.float32)
    kp = rng.standard_normal((num_pages, page, nkv, hd)).astype(np.float32)
    vp = rng.standard_normal((num_pages, page, nkv, hd)).astype(np.float32)
    tables = (rng.permutation(num_pages - 1)[:b * nblk] + 1).reshape(
        b, nblk).astype(np.int32)
    lens = np.array([t, page + 1, nblk * page][:b], np.int32)
    return q, kp, vp, lens, tables


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("t", [1, 3])
def test_paged_ref_matches_pallas(t):
    q, kp, vp, lens, tables = _paged_inputs(t, t)
    want = np.asarray(pallas_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens),
        jnp.asarray(tables), interpret=True, q_rows=t))
    got = paged_mod.paged_decode_attention_ref(*_torch(q, kp, vp, lens,
                                                       tables), t)
    np.testing.assert_allclose(got.numpy(), want, **KTOL)


@pytest.mark.parametrize("t", [1, 3])
def test_paged_ref_bit_equal_to_dense_ref(t):
    """The same contents laid out as a dense slab give the same bits."""
    q, kp, vp, lens, tables = _paged_inputs(10 + t, t)
    b, nblk = tables.shape
    k_dense = kp[tables].reshape(b, nblk * kp.shape[1], *kp.shape[2:])
    v_dense = vp[tables].reshape(b, nblk * vp.shape[1], *vp.shape[2:])
    got = paged_mod.paged_decode_attention_ref(*_torch(q, kp, vp, lens,
                                                       tables), t)
    want = attn_mod.decode_attention_ref(*_torch(q, k_dense, v_dense, lens), t)
    assert torch.equal(got, want)


@pytest.mark.parametrize("t", [1, 3])
def test_paged_ref_ignores_table_entries_past_each_length(t):
    q, kp, vp, lens, tables = _paged_inputs(20 + t, t)
    page = kp.shape[1]
    scrubbed = tables.copy()
    for i, n in enumerate(lens):
        scrubbed[i, -(-int(n) // page):] = 0      # the garbage page
    base = paged_mod.paged_decode_attention_ref(*_torch(q, kp, vp, lens,
                                                        tables), t)
    got = paged_mod.paged_decode_attention_ref(*_torch(q, kp, vp, lens,
                                                       scrubbed), t)
    assert torch.equal(got, base)


def test_paged_cpu_tensor_launches_nothing_and_zero_length_gives_zeros():
    q, kp, vp, lens, tables = _paged_inputs(30, 1)
    lens[0] = 0
    args = _torch(q, kp, vp, lens, tables)
    before = paged_mod.LAUNCHES
    out = paged_mod.paged_decode_attention(*args)
    assert paged_mod.LAUNCHES == before
    assert torch.equal(out, paged_mod.paged_decode_attention_ref(*args))
    assert bool((out[0] == 0).all()) and bool(torch.isfinite(out).all())


def test_paged_wrapper_rejects_bad_inputs():
    q, kp, vp, lens, tables = _torch(*_paged_inputs(31, 1))
    with pytest.raises(ValueError, match="tables"):
        paged_mod.paged_decode_attention(q, kp, vp, lens, tables[:2])
    with pytest.raises(ValueError, match="q_rows"):
        paged_mod.paged_decode_attention(q, kp, vp, lens, tables, q_rows=3)
    with pytest.raises(TypeError):
        paged_mod.paged_decode_attention(q.double(), kp, vp, lens, tables)


# ---------------------------------------------------------------------------
# the paged model entry points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def paged(models):
    """Both paged caches after one batched admission of three ragged
    prompts into slots 0, 2, 3 (slot 1 untouched); every slot's table row
    is mapped to shuffled pages, so no read reaches the garbage page."""
    jcfg, jp, cfg, tp = models
    rng = np.random.default_rng(1)
    toks = rng.integers(3, cfg.vocab_size, size=(3, P)).astype(np.int32)
    lens = np.array([P, 5, 2], np.int32)
    src = np.array([1, -1, 0, 2], np.int32)
    num_pages = SLOTS * BLOCKS + 1
    tables = (rng.permutation(num_pages - 1) + 1).reshape(
        SLOTS, BLOCKS).astype(np.int32)
    jc = jm.init_paged_cache(jcfg, SLOTS, num_pages, PAGE, BLOCKS)
    jc["block_tables"] = jnp.asarray(tables)
    tc = tm.init_paged_cache(cfg, SLOTS, num_pages, PAGE, BLOCKS, "cpu")
    tc["block_tables"] = torch.from_numpy(tables)
    batch = {"tokens": toks, "prompt_lens": lens}
    jfirst, jc = jm.prefill_to_pages(
        jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()}, jc,
        jnp.asarray(src))
    tfirst, tc = tm.prefill_to_pages(
        cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tc,
        torch.from_numpy(src))
    return np.asarray(jfirst), jc, tfirst.numpy(), tc


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _assert_pages_close(tc, jc):
    """K/V of every page but the garbage page 0 (which collects the masked
    rows' writes in an undefined order)."""
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key][:, 1:].numpy(),
                                   np.asarray(jc[key])[:, 1:], **TOL)


def test_init_paged_cache_shapes(models):
    jcfg, _, cfg, _ = models
    got = tm.init_paged_cache(cfg, SLOTS, 25, PAGE, None, "cpu")
    want = jm.init_paged_cache(jcfg, SLOTS, 25, PAGE)
    assert set(got) == set(want) == {"pos", "k", "v", "block_tables"}
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert not got[key].any()
    assert got["block_tables"].dtype == got["pos"].dtype == torch.int32
    assert got["k"].shape == (cfg.num_layers, 25, PAGE, cfg.num_kv_heads,
                              cfg.resolved_head_dim)


def test_prefill_to_pages_first_tokens_and_pages(paged):
    jfirst, jc, tfirst, tc = paged
    np.testing.assert_array_equal(tfirst, jfirst)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    _assert_pages_close(tc, jc)
    assert tc["k"][:, 1:].abs().sum() > 0


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("fc,attn", [("pu", "xla"), ("pim", "pim")])
def test_paged_decode_step_matches(models, paged, fc, attn, t):
    jcfg, jp, cfg, tp = models
    _, jc, _, tc = paged
    tc = _clone(tc)
    step = np.random.default_rng(2 + t).integers(
        3, cfg.vocab_size, size=(SLOTS, t)).astype(np.int32)
    with jax_fc_variant(fc, interpret=True), jax_attn_impl(attn):
        jl, jc2 = jm.decode_step(jcfg, jp, jc, jnp.asarray(step))
    with tm.fc_variant(fc), tm.attn_impl(attn):
        tl_, tc2 = tm.decode_step(cfg, tp, tc, torch.from_numpy(step))
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tl_.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
    np.testing.assert_array_equal(tc2["pos"].numpy(), np.asarray(jc2["pos"]))
    _assert_pages_close(tc2, jc2)


@pytest.mark.parametrize("fc,attn", [("pu", "xla"), ("pim", "pim")])
def test_paged_chunk_logits_matches(models, paged, fc, attn):
    """A chunk wave over pages: ragged chunk lengths, slot 1 not chunking
    (its rows go to the garbage page), positions advanced per slot."""
    jcfg, jp, cfg, tp = models
    _, jc, _, tc = paged
    tc = _clone(tc)
    rng = np.random.default_rng(3)
    toks = rng.integers(3, cfg.vocab_size, size=(SLOTS, P)).astype(np.int32)
    clens = np.array([P, 0, 3, 5], np.int32)
    with jax_fc_variant(fc, interpret=True), jax_attn_impl(attn):
        jl, jc2 = jm.chunk_logits(jcfg, jp, jc, jnp.asarray(toks),
                                  jnp.asarray(clens))
    with tm.fc_variant(fc), tm.attn_impl(attn):
        tl_, tc2 = tm.chunk_logits(cfg, tp, tc, torch.from_numpy(toks),
                                   torch.from_numpy(clens))
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tc2["pos"].numpy(), np.asarray(jc2["pos"]))
    _assert_pages_close(tc2, jc2)


def test_paged_rows_clamp_to_the_table_width():
    from repro.models.model import _paged_rows as j_rows
    from repro_torch.models.model import _paged_rows
    tables = np.arange(1, 7, dtype=np.int32).reshape(2, 3)
    pos = np.array([0, 10], np.int32)              # slot 1 runs off block 2
    jp_, jr = j_rows(jnp.asarray(pos), 4, jnp.asarray(tables), 4)
    tp_, tr = _paged_rows(torch.from_numpy(pos), 4, torch.from_numpy(tables),
                          4)
    np.testing.assert_array_equal(tp_.numpy(), np.asarray(jp_))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


# ---------------------------------------------------------------------------
# the paged engine
# ---------------------------------------------------------------------------

def _streams(results):
    return {r.req_id: (r.tokens, r.finished_reason) for r in results}


def _pool(stats):
    return [(s.kv_pages_used, s.kv_pages_free, s.kv_page_watermark,
             s.kv_fragmentation) for s in stats]


def _assert_drained(eng):
    eng.kv.alloc.check()
    assert eng.kv.alloc.mapped_count == 0
    assert eng.kv.alloc.reserved_unmapped == 0
    assert eng.kv.alloc.free_count == eng.kv.alloc.num_pages
    assert (eng.kv.tables.host == 0).all()


def _port(cfg, params, reqs, **kw):
    eng = PapiEngine(cfg, params, device="cpu", **{**ENGINE, **kw})
    for i, prompt, budget in reqs:
        eng.submit(ServeRequest(i, prompt, budget))
    return _streams(eng.run(max_iterations=500)), eng


@pytest.fixture(scope="module")
def runs(models):
    """For attn_pim off and on: the reference's paged engine, the port's
    paged engine and the port's dense engine on the same requests."""
    jcfg, jp, cfg, tp = models
    out = {}
    for attn_pim in (False, True):
        kw = dict(attn_pim=attn_pim)
        ref = JaxEngine(jcfg, jp, kv_layout="paged", page_size=8,
                        **{**ENGINE, **kw})
        for i, prompt, budget in REQS:
            ref.submit(JaxRequest(i, prompt, budget))
        want = _streams(ref.run(max_iterations=500))
        got, eng = _port(cfg, tp, REQS, kv_layout="paged", page_size=8, **kw)
        dense, dense_eng = _port(cfg, tp, REQS, **kw)
        out[attn_pim] = dict(want=want, ref=ref, got=got, eng=eng,
                             dense=dense, dense_eng=dense_eng)
    return out


@pytest.mark.parametrize("attn_pim", [False, True])
def test_paged_streams_match_reference_engine(runs, attn_pim):
    r = runs[attn_pim]
    assert r["got"] == r["want"]
    assert len(r["got"]) == len(REQS)
    assert [s.fc_variant for s in r["eng"].stats] == [
        s.fc_variant for s in r["ref"].stats]


@pytest.mark.parametrize("attn_pim", [False, True])
def test_paged_streams_match_dense_engine(runs, attn_pim):
    r = runs[attn_pim]
    assert r["got"] == r["dense"]


@pytest.mark.parametrize("attn_pim", [False, True])
def test_paged_pool_counters_match_reference(runs, attn_pim):
    r = runs[attn_pim]
    got, want = _pool(r["eng"].stats), _pool(r["ref"].stats)
    assert got == want
    assert max(s[0] for s in got) > 0
    assert r["eng"].kv.alloc.watermark == r["ref"].kv.alloc.watermark
    assert all(s.kv_pages_used == 0 for s in r["dense_eng"].stats)


@pytest.mark.parametrize("attn_pim", [False, True])
def test_paged_pool_drains(runs, attn_pim):
    _assert_drained(runs[attn_pim]["eng"])


def test_paged_one_host_transfer_per_steady_iteration(runs):
    eng = runs[True]["eng"]
    steady = [s for s in eng.stats if s.admitted == 0]
    assert steady and all(s.transfers == 1 for s in steady)
    assert all(s.transfers == 2 for s in eng.stats if s.admitted > 0)


def test_paged_completes_request_beyond_dense_slot(models):
    """Prompt + generation far past the 64-token dense slot: the dense
    engine clamps the budget, the paged engine completes it, and the dense
    stream is a prefix of the paged one."""
    _, _, cfg, tp = models
    no_eos = cfg.vocab_size - 1
    req = [(0, [3, 5, 7, 11, 13, 17], 100)]
    dense, _ = _port(cfg, tp, req, eos_token=no_eos)
    paged_, eng = _port(cfg, tp, req, eos_token=no_eos, kv_layout="paged")
    tokens, reason = paged_[0]
    assert len(dense[0][0]) < 100
    assert len(tokens) == 100 and reason == "length"
    assert tokens[:len(dense[0][0])] == dense[0][0]
    assert eng.kv.alloc.watermark >= eng.kv.pages_for(6 + 100)
    _assert_drained(eng)


def test_paged_admission_defers_and_finishes_everyone(models):
    """Six requests of six pages each on a 16-page pool: admission defers
    (never rejects), keeps the order, and every request finishes as in the
    reference engine without preemption."""
    jcfg, jp, cfg, tp = models
    no_eos = cfg.vocab_size - 1
    reqs = [(i, [3 + i, 5, 7], 40) for i in range(6)]
    kw = dict(eos_token=no_eos, cache_capacity=32, kv_layout="paged",
              page_size=8)
    ref = JaxEngine(jcfg, jp, preempt_after=None, **{**ENGINE, **kw})
    for i, prompt, budget in reqs:
        ref.submit(JaxRequest(i, prompt, budget))
    want = _streams(ref.run(max_iterations=500))
    got, eng = _port(cfg, tp, reqs, preempt_after=None, **kw)
    assert got == want
    assert all(len(t) == 40 and r == "length" for t, r in got.values())
    assert max(s.rlp for s in eng.stats) < 4      # the pool held it back
    assert _pool(eng.stats) == _pool(ref.stats)
    _assert_drained(eng)


def test_paged_rejects_prompt_the_table_cannot_hold(models):
    _, _, cfg, tp = models
    reqs = [(0, list(range(3, 40)), 4), (1, [3, 5, 7], 3)]
    got, eng = _port(cfg, tp, reqs, kv_layout="paged", page_size=8,
                     max_blocks=4)                # 32-token context
    assert got[0] == ([], "rejected")
    assert got[1][1] in ("length", "eos")
    _assert_drained(eng)


def test_paged_run_exhaustion_aborts_and_drains(models):
    _, _, cfg, tp = models
    eng = PapiEngine(cfg, tp, device="cpu", kv_layout="paged", **ENGINE)
    eng.submit(ServeRequest(0, [3, 5, 7], max_new_tokens=20))
    res = eng.run(max_iterations=3)
    assert [r.finished_reason for r in res] == ["aborted"]
    _assert_drained(eng)


def test_launcher_runs_paged_on_cpu(capsys):
    serve_cli.main(["--arch", "qwen2-0.5b-smoke", "--device", "cpu",
                    "--requests", "4", "--capacity", "64", "--kv", "paged",
                    "--page-size", "8", "--prefill-len", "16",
                    "--max-prompt", "40", "--attn-pim"])
    out = capsys.readouterr().out
    assert "completed 4 requests" in out
    assert "kv pages: watermark" in out
