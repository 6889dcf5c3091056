"""Speculative decoding (TLP > 1) in the port against the JAX package.

* `sampler.accept_speculative` against `repro.serving.sampler`'s on random
  windows (b and k from 1 to 8, jitted JAX side); `sample`'s semantics as
  tests/test_sampler.py states them (torch's random stream, not JAX's).
* The engine on the reduced qwen2 twin in f32, the target's weights and
  two drafts carried across by `params_from_jax` — a seed-9 model (it
  accepts almost nothing) and the target's first layer alone (partial
  accepts, so the rewinds run) — against `repro.serving.PapiEngine` on the
  same requests, dense and paged, with prompts longer than the prefill
  window (chunked admission): equal token streams, equal per-iteration
  accepted counts and FC variants.  Then, in the port alone: the
  speculative streams equal the TLP = 1 streams, the perfect draft accepts
  every window, ``fused=True`` equals the host loop with one transfer per
  fused iteration, and `set_spec_len` clamps or re-budgets (mirroring
  tests/test_serving.py and tests/test_serving_paged.py).
* The refusal of a draft with another vocabulary.  Speculation on the SSM
  families serves since the port rewinds their state: its tests are in
  tests/test_torch_ssm_spec.py.
* A strict xfail that records a fault of the reference: its speculative
  streams on mamba2 leave its TLP = 1 streams (a partial accept rewinds
  the KV position, not the SSM state).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.serving import PapiEngine as JaxEngine  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro.serving import sampler as jax_sampler  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init_params, params_from_jax  # noqa: E402
from repro_torch.serving import (PapiEngine, ServeRequest,  # noqa: E402
                                 accept_speculative, greedy, sample)

ENGINE = dict(max_slots=4, cache_capacity=64, prefill_len=8, alpha=6.0,
              eos_token=1)
NO_EOS = 255


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The engines here run thousands of tiny CPU ops: one intra-op thread
    keeps them fast when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- sampler
@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("b", range(1, 9))
def test_accept_speculative_matches_reference(b, k):
    """Windows over a 3-token alphabet, so prefixes of every length match;
    the target is the window shifted by one with random corrections."""
    rng = np.random.default_rng(10 * b + k)
    window = rng.integers(0, 3, size=(b, k)).astype(np.int32)
    target = np.concatenate([window[:, 1:], rng.integers(0, 3, (b, 1))],
                            axis=1).astype(np.int32)
    flip = rng.random((b, k)) < 0.25
    target = np.where(flip, rng.integers(0, 3, (b, k)), target).astype(
        np.int32)
    want_out, want_acc = jax.jit(jax_sampler.accept_speculative)(
        jnp.asarray(window), jnp.asarray(target))
    out, acc = accept_speculative(torch.from_numpy(window),
                                  torch.from_numpy(target))
    assert out.dtype == acc.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    assert acc.min() >= 1 and acc.max() <= k


def test_greedy_matches_reference_and_breaks_ties_first():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((5, 3, 17)).astype(np.float32)
    logits[0, 0, [2, 9]] = 9.0                  # a tie: the first wins
    want = np.asarray(jax_sampler.greedy(jnp.asarray(logits)))
    got = greedy(torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0] == 2 and got.dtype == torch.int32


V = 16


@pytest.fixture(scope="module")
def logits():
    return torch.from_numpy(np.random.default_rng(7).standard_normal(
        (3, V)).astype(np.float32))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_sample_zero_temperature_is_greedy(logits):
    out = sample(logits, _gen(0), temperature=0.0, top_k=3)
    assert torch.equal(out, greedy(logits)) and out.dtype == torch.int32


def test_sample_top_k_one_is_greedy_for_any_generator(logits):
    for seed in range(5):
        assert torch.equal(sample(logits, _gen(seed), temperature=0.7,
                                  top_k=1), greedy(logits))


@pytest.mark.parametrize("top_k", [V, V + 1, 10 * V])
def test_sample_top_k_at_or_beyond_vocab_is_a_noop_filter(logits, top_k):
    got = sample(logits, _gen(3), temperature=1.0, top_k=top_k)
    want = sample(logits, _gen(3), temperature=1.0, top_k=0)
    assert torch.equal(got, want)
    assert bool(((got >= 0) & (got < V)).all())


def test_sample_tokens_always_inside_top_k_set(logits):
    k = 3
    topk = torch.topk(logits, k, dim=-1).indices
    for seed in range(20):
        out = sample(logits, _gen(seed), temperature=1.3, top_k=k)
        for row in range(logits.shape[0]):
            assert out[row] in topk[row]


def test_sample_temperature_sharpens_distribution():
    logits = torch.tensor([[0.0, 1.0, 0.5, -0.5]])
    cold = {int(sample(logits, _gen(s), temperature=0.05)[0])
            for s in range(25)}
    hot = {int(sample(logits, _gen(s), temperature=50.0)[0])
           for s in range(25)}
    assert cold == {1} and len(hot) > 1


def test_sample_draws_from_the_softmax():
    """The categorical draw's frequencies follow softmax(logits / T)."""
    logits = torch.tensor([0.0, 1.0, 0.5, -0.5]).expand(20000, 4)
    out = sample(logits, _gen(0), temperature=1.0)
    freq = torch.bincount(out.long(), minlength=4).float() / out.numel()
    want = torch.softmax(logits[0], -1)
    assert float((freq - want).abs().max()) < 0.02


# ----------------------------------------------------------- the engines
@pytest.fixture(scope="module")
def models():
    """Target, seed-9 draft and one-layer draft, in both packages."""
    jcfg = jax_config("qwen2-0.5b").reduced()
    init = jax.jit(jm.init_params, static_argnums=0)
    jp, jd = init(jcfg, jax.random.PRNGKey(0)), init(jcfg,
                                                     jax.random.PRNGKey(9))
    cfg = get_config("qwen2-0.5b-smoke")

    def bridge(c, p):
        return params_from_jax(c, jax.tree.map(np.asarray, p), "cpu")

    jcfg1 = dataclasses.replace(jcfg, num_layers=1)
    jp1 = dict(jp, layers=jax.tree.map(lambda x: x[:1], jp["layers"]))
    cfg1 = dataclasses.replace(cfg, num_layers=1)
    return {"target": ((jcfg, jp), (cfg, bridge(cfg, jp))),
            "seed9": ((jcfg, jd), (cfg, bridge(cfg, jd))),
            "layer0": ((jcfg1, jp1), (cfg1, bridge(cfg1, jp1)))}


def _requests():
    """Prompts shorter than, equal to and longer than the 8-token window
    (31: four chunks), one whose budget the speculative window clamps to
    one token on the dense slab (60 + 1 + 3 = 64) and one the slab cannot
    hold at spec_len 3 (62 + 3 > 63); staggered budgets."""
    rng = np.random.default_rng(0)
    lens = [3, 8, 20, 5, 31, 2, 12, 60, 62]
    return [(i, rng.integers(3, 256, size=n).tolist(), 2 + 2 * i)
            for i, n in enumerate(lens)]


def _port_engine(models, draft=None, **kw):
    cfg, params = models["target"][1]
    d = models[draft][1] if draft else None
    return PapiEngine(cfg, params, draft=d, device="cpu", **{**ENGINE, **kw})


def _serve(eng, request_cls, reqs=None):
    for i, prompt, budget in (reqs or _requests()):
        eng.submit(request_cls(i, prompt, budget))
    return {r.req_id: (r.tokens, r.finished_reason)
            for r in eng.run(max_iterations=300)}


def _drained(eng):
    eng.kv.alloc.check()
    return (eng.kv.alloc.mapped_count, eng.kv.alloc.reserved_unmapped) == (
        0, 0)


@pytest.fixture(scope="module")
def plain(models):
    """The port's TLP = 1 streams of the first 7 requests, per layout and
    eos token, each served once."""
    cache = {}

    def get(layout, eos_token=ENGINE["eos_token"]):
        if (layout, eos_token) not in cache:
            eng = _port_engine(models, kv_layout=layout, eos_token=eos_token)
            cache[layout, eos_token] = _serve(eng, ServeRequest,
                                              _requests()[:7])
        return cache[layout, eos_token]
    return get


@pytest.fixture(scope="module")
def runs(models):
    """The reference engine and the port's, spec_len 3, per layout and
    draft."""
    out = {}
    for layout in ("dense", "paged"):
        for draft in ("seed9", "layer0"):
            jcfg, jp = models["target"][0]
            ref = JaxEngine(jcfg, jp, spec_len=3, draft=models[draft][0],
                            kv_layout=layout, **ENGINE)
            eng = _port_engine(models, draft, spec_len=3, kv_layout=layout)
            out[layout, draft] = dict(want=_serve(ref, JaxRequest),
                                      got=_serve(eng, ServeRequest), ref=ref,
                                      eng=eng)
    return out


@pytest.mark.parametrize("draft", ["seed9", "layer0"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_spec_streams_and_accepts_match_reference_engine(runs, layout, draft):
    r = runs[layout, draft]
    assert r["got"] == r["want"]
    if layout == "dense":               # the pool spans more than a slab
        assert r["got"][8] == ([], "rejected")      # 62 + window 3 > 64 - 1
        assert len(r["got"][7][0]) == 1             # budget clamped to 1
    assert [s.accepted for s in r["eng"].stats] == [
        s.accepted for s in r["ref"].stats]
    assert [(s.fc_variant, s.rlp, s.tlp) for s in r["eng"].stats] == [
        (s.fc_variant, s.rlp, s.tlp) for s in r["ref"].stats]
    if draft == "layer0":                           # partial accepts ran
        acc = [s.accepted for s in r["eng"].stats]
        assert 1.0 < np.mean(acc) < 3.0


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_spec_pool_counters_match_reference_and_drain(runs, layout):
    r = runs[layout, "layer0"]
    key = [(s.kv_pages_used, s.kv_pages_free, s.kv_page_watermark)
           for s in r["eng"].stats]
    want = [(s.kv_pages_used, s.kv_pages_free, s.kv_page_watermark)
            for s in r["ref"].stats]
    assert key == want
    if layout == "paged":
        assert _drained(r["eng"])


@pytest.mark.parametrize("draft", ["seed9", "layer0"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_spec_streams_equal_tlp1_streams(runs, plain, layout, draft):
    """Greedy speculation is lossless: the TLP = 1 engine gives the same
    streams (aside the two requests whose dense budget the window sets)."""
    want = plain(layout)
    got = runs[layout, draft]["got"]
    assert {i: got[i] for i in want} == want


@pytest.mark.parametrize("spec_len", [2, 4])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_perfect_draft_accepts_every_window(models, plain, layout,
                                           spec_len):
    eng = _port_engine(models, "target", spec_len=spec_len, kv_layout=layout,
                       eos_token=NO_EOS)
    got = _serve(eng, ServeRequest, _requests()[:7])
    assert got == plain(layout, NO_EOS)
    assert all(s.accepted == spec_len for s in eng.stats)
    assert sum(s.new_tokens for s in eng.stats) == sum(
        len(t) - 1 for t, _ in got.values())       # the first from prefill
    if layout == "paged":
        assert _drained(eng)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_fused_equals_host_loop_with_one_transfer(models, layout):
    """The first 7 requests: no admission that finishes at once, so every
    iteration that admits nothing fetches only its decode results."""
    k = 3
    fused = _port_engine(models, "layer0", spec_len=k, kv_layout=layout)
    host = _port_engine(models, "layer0", spec_len=k, kv_layout=layout,
                        fused=False)
    reqs = _requests()[:7]
    assert _serve(fused, ServeRequest, reqs) == _serve(host, ServeRequest,
                                                       reqs)
    assert [s.accepted for s in fused.stats] == [
        s.accepted for s in host.stats]
    steady = [s.transfers for s in fused.stats if s.admitted == 0]
    assert steady and set(steady) == {1}
    assert set(s.transfers for s in host.stats if s.admitted == 0) == {k + 1}


def test_attn_pim_spec_streams_equal_plain_attention(models, runs):
    """The verify windows through the Attn-PIM path (its plain version on
    the CPU) at t = 3 give the streams of the plain attention."""
    a = _serve(_port_engine(models, "layer0", spec_len=3, attn_pim=True),
               ServeRequest)
    assert a == runs["dense", "layer0"]["got"]


def test_engine_without_draft_reserves_the_window_but_decodes_at_tlp1(
        models, plain):
    """As the reference: spec_len > 1 without a draft decodes one token a
    step, while admission and the scheduler see the window."""
    eng = _port_engine(models, spec_len=3)
    got = _serve(eng, ServeRequest)
    assert got[8] == ([], "rejected")
    assert all(s.tlp == 3 and s.accepted == 1.0 for s in eng.stats)
    want = plain("dense")
    assert {i: got[i] for i in want} == want


# --------------------------------------------------------- set_spec_len
def test_dense_set_spec_len_widen_clamps_to_slab(models):
    """Mirror of tests/test_serving.py: the slab holds prompt + budget +
    the old window, so widening clamps to the smallest live headroom."""
    plain = _port_engine(models, max_slots=2, cache_capacity=24,
                         eos_token=NO_EOS)
    want = _serve(plain, ServeRequest, [(0, [3, 5, 7], 19)])[0][0]
    assert len(want) == 19

    eng = _port_engine(models, "seed9", max_slots=2, cache_capacity=24,
                       eos_token=NO_EOS, spec_len=2)
    eng.submit(ServeRequest(0, [3, 5, 7], 19))
    eng.step()
    eng.step()
    assert eng.active_slots == [0]             # 3 + 19 + 2 = 24: no headroom
    eng.set_spec_len(6)
    assert eng.spec_len == 2 and eng.scheduler.tlp == 2
    assert eng.run(max_iterations=200)[0].tokens == want

    eng2 = _port_engine(models, "seed9", max_slots=2, cache_capacity=40,
                        eos_token=NO_EOS, spec_len=2)
    eng2.submit(ServeRequest(0, [3, 5, 7], 19))
    eng2.step()
    eng2.step()
    eng2.set_spec_len(6)
    assert eng2.spec_len == 6 and eng2.scheduler.tlp == 6
    assert eng2.run(max_iterations=200)[0].tokens == want


def test_paged_set_spec_len_widen_rebudgets_or_clamps(models):
    """Mirror of tests/test_serving_paged.py: widening re-budgets the live
    reservations, and clamps when the pool or the table width cannot
    cover the wider window."""
    kw = dict(max_slots=2, eos_token=NO_EOS, spec_len=2, kv_layout="paged",
              page_size=4)
    eng = _port_engine(models, "seed9", cache_capacity=32, **kw)
    for i in range(2):                  # 2 x pages_for(3 + 27 + 2) = 16
        eng.submit(ServeRequest(i, [3, 5, 7], 27))
    eng.step()
    eng.step()
    assert eng.active_slots == [0, 1] and eng.kv.alloc.available == 0
    eng.set_spec_len(6)
    assert eng.spec_len == 2
    res = eng.run(max_iterations=300)
    assert sorted(r.req_id for r in res) == [0, 1]
    assert all(len(r.tokens) == 27 and r.finished_reason == "length"
               for r in res)
    assert _drained(eng)

    eng2 = _port_engine(models, "seed9", cache_capacity=64, **kw)
    eng2.submit(ServeRequest(0, [3, 5, 7], 20))
    eng2.step()
    eng2.step()
    eng2.set_spec_len(6)
    assert eng2.spec_len == 6
    res2 = eng2.run(max_iterations=300)
    assert len(res2[0].tokens) == 20 and res2[0].finished_reason == "length"
    assert _drained(eng2)

    eng3 = _port_engine(models, "seed9", cache_capacity=64, max_blocks=6,
                        **kw)
    eng3.submit(ServeRequest(0, [3, 5, 7], 40))
    eng3.step()                         # admitted clamped to the 24-token table
    eng3.step()
    assert eng3.kv.alloc.available > 0
    eng3.set_spec_len(6)
    assert eng3.spec_len == 2
    res3 = eng3.run(max_iterations=300)[0]
    assert res3.finished_reason == "length" and len(res3.tokens) == 19
    assert _drained(eng3)


def test_set_spec_len_flips_the_scheduler(models):
    """TLP drives the FC path: 4 slots at spec_len 1 sit under alpha 6
    ("pim"); spec_len 2 makes AI = 8 > 6 ("pu"), logged as a reschedule."""
    eng = _port_engine(models, "seed9", eos_token=NO_EOS)
    for i in range(4):
        eng.submit(ServeRequest(i, [3 + i, 5, 7], 30))
    eng.step()
    eng.step()
    assert eng.scheduler.fc_assignment == "pim"
    flips = eng.scheduler.num_reschedules
    eng.set_spec_len(2)
    assert eng.scheduler.fc_assignment == "pu"
    assert eng.scheduler.num_reschedules == flips + 1
    assert eng.scheduler.events[-1].rescheduled
    eng.step()
    assert eng.stats[-1].fc_variant == "pu" and eng.stats[-1].tlp == 2


# --------------------------------------------------------------- refusals
def test_draft_with_another_vocabulary_is_refused(models):
    cfg, params = models["target"][1]
    dcfg = dataclasses.replace(cfg, vocab_size=cfg.vocab_size + 1)
    dp = init_params(dcfg, torch.Generator().manual_seed(9))
    with pytest.raises(ValueError, match="vocabulary"):
        PapiEngine(cfg, params, spec_len=2, draft=(dcfg, dp), device="cpu",
                   **ENGINE)


# ------------------------------------------------ the reference's fault
@pytest.mark.xfail(strict=True, reason="the reference rewinds only the KV "
                   "position after a partial accept, not the SSM state "
                   "(src/repro/serving/engine.py:1001-1002), so its "
                   "speculative mamba2 streams leave the TLP = 1 streams")
def test_reference_speculation_on_mamba2_is_lossless():
    jcfg = jax_config("mamba2-1.3b").reduced()
    init = jax.jit(jm.init_params, static_argnums=0)
    jp, jd = init(jcfg, jax.random.PRNGKey(0)), init(jcfg,
                                                     jax.random.PRNGKey(9))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 256, size=32).tolist() for _ in range(3)]

    def streams(spec_len):
        eng = JaxEngine(jcfg, jp, max_slots=4, cache_capacity=128,
                        prefill_len=32, alpha=6.0, eos_token=NO_EOS,
                        spec_len=spec_len, draft=(jcfg, jd))
        for i, p in enumerate(prompts):
            eng.submit(JaxRequest(i, p, 12))
        return {r.req_id: r.tokens for r in eng.run(max_iterations=100)}

    assert streams(3) == streams(1)
