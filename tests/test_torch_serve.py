"""The port's continuous-batching front end against the JAX package's.

Reduced qwen2 (f32, 2 layers, d=128) with the reference's weights carried
over by `params_from_jax`, and a seed-9 draft of the same config, at
``max_slots=4, cache_capacity=64, prefill_len=8``:

* `models.mixed_step` against `repro.models.mixed_step` (1e-4), dense and
  paged, with pinned prefill rows, a decode row, a ragged chunk and an
  idle row;
* `PapiEngine.serve` on requests whose prompts straddle the window,
  arriving with gaps, dense and paged, greedy and speculative (spec_len
  3): the streamed tokens equal the port's own offline ``run()`` and the
  reference's ``serve()``; every iteration's counters (arrivals, admitted,
  queued, prefill and decode slots, new tokens, transfers, FC variant,
  pool) and every request's queue delay and TTFT in iterations equal the
  reference's (built with ``preempt_after=None``; the port at its
  default never preempts here: its dense layout never defers, and no
  paged head defers for 8 iterations);
* mixed iterations exist and take no more transfers than plain decodes;
  idle gaps and the trailing drain; ``run()`` after ``serve()``; an early
  close and ``max_iterations`` finish in-flight requests as "aborted",
  drain the pool and leave the engine usable;
* `percentile` and `latency_summary` against the reference's on seeded
  inputs; ``tpot_s is None`` for a one-token result, as the reference
  stamps it;
* the mamba2 smoke twin: ``serve()`` equals its offline run and rejects a
  prompt longer than the window.
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
from repro.serving import metrics as jax_metrics  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving import (PapiEngine, ServeRequest,  # noqa: E402
                                 TokenEvent, latency_summary, percentile)

ENGINE = dict(max_slots=4, cache_capacity=64, prefill_len=8, alpha=6.0,
              eos_token=1)
GAPS = [0, 0, 2, 0, 1, 3, 0, 5]
TOL = dict(rtol=1e-4, atol=1e-4)
STAT_FIELDS = ("arrivals", "admitted", "queued", "prefill_slots",
               "decode_slots", "new_tokens", "transfers", "fc_variant",
               "rlp", "tlp", "accepted", "kv_pages_used", "kv_pages_free",
               "kv_page_watermark", "kv_fragmentation")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """Target and seed-9 draft, in both packages."""
    jcfg = jax_config("qwen2-0.5b").reduced()
    init = jax.jit(jm.init_params, static_argnums=0)
    jp, jd = init(jcfg, jax.random.PRNGKey(0)), init(jcfg,
                                                     jax.random.PRNGKey(9))
    cfg = get_config("qwen2-0.5b-smoke")

    def bridge(p):
        return tm.params_from_jax(cfg, jax.tree.map(np.asarray, p), "cpu")
    return {"target": ((jcfg, jp), (cfg, bridge(jp))),
            "seed9": ((jcfg, jd), (cfg, bridge(jd)))}


def _requests(seed, n, vocab, max_prompt=30, max_new=10):
    """The reference's stream workload: prompts of 3 to 29 tokens (some
    chunk), budgets of 2 to 9."""
    rng = np.random.default_rng(seed)
    return [(i, [int(t) for t in rng.integers(3, vocab - 1,
                                              rng.integers(3, max_prompt))],
             int(rng.integers(2, max_new))) for i in range(n)]


def _schedule(reqs, gaps, cls=ServeRequest):
    """gaps[i] quiet iterations before request i arrives."""
    sched = []
    for (i, prompt, budget), gap in zip(reqs, gaps):
        sched.extend([[]] * gap)
        sched.append([cls(i, list(prompt), budget)])
    return sched


def _kw(layout, spec, draft=None):
    kw = dict(ENGINE)
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=4)
    if spec:
        kw.update(spec_len=3, draft=draft)
    return kw


def _consume(events):
    """({req_id: streamed tokens}, {req_id: ServeResult}), checking the
    event contract: contiguous indices, a final event carrying the whole
    result."""
    streams, finals = {}, {}
    for ev in events:
        if ev.finished:
            assert ev.token == -1 and ev.result is not None
            assert ev.index == len(ev.result.tokens)
            assert ev.reason == ev.result.finished_reason
            finals[ev.req_id] = ev.result
        else:
            streams.setdefault(ev.req_id, []).append(ev.token)
            assert ev.index == len(streams[ev.req_id]) - 1
    for rid, res in finals.items():
        assert streams.get(rid, []) == res.tokens
    return streams, finals


def _offline(eng, reqs):
    for i, prompt, budget in reqs:
        eng.submit(ServeRequest(i, list(prompt), budget))
    return {r.req_id: r.tokens for r in eng.run(max_iterations=500)}


@pytest.fixture(scope="module")
def runs(models):
    """Per (layout, greedy | spec): the reference's serve(), the port's
    serve() and the port's offline run() on the same requests."""
    (jcfg, jp), (cfg, tp) = models["target"]
    out = {}
    reqs = _requests(7, 8, cfg.vocab_size)
    for layout in ("dense", "paged"):
        for spec in (False, True):
            ref = JaxEngine(jcfg, jp, preempt_after=None,
                            **_kw(layout, spec, models["seed9"][0]))
            _, want = _consume(ref.serve(_schedule(reqs, GAPS, JaxRequest)))
            kw = _kw(layout, spec, models["seed9"][1])
            eng = PapiEngine(cfg, tp, device="cpu", **kw)
            streams, got = _consume(eng.serve(_schedule(reqs, GAPS)))
            offline = _offline(PapiEngine(cfg, tp, device="cpu", **kw), reqs)
            out[layout, spec] = dict(ref=ref, want=want, eng=eng, got=got,
                                     streams=streams, offline=offline,
                                     reqs=reqs)
    return out


CASES = [("dense", False), ("paged", False), ("dense", True), ("paged", True)]
IDS = ["dense", "paged", "dense-spec", "paged-spec"]


@pytest.mark.parametrize("layout,spec", CASES, ids=IDS)
def test_serve_streams_equal_offline_and_reference(runs, layout, spec):
    r = runs[layout, spec]
    got = {i: res.tokens for i, res in r["got"].items()}
    assert set(got) == {i for i, _, _ in r["reqs"]}
    assert got == r["offline"]
    assert got == {i: res.tokens for i, res in r["want"].items()}
    assert {i: res.finished_reason for i, res in r["got"].items()} == {
        i: res.finished_reason for i, res in r["want"].items()}


@pytest.mark.parametrize("layout,spec", CASES, ids=IDS)
def test_serve_iteration_counters_equal_reference(runs, layout, spec):
    r = runs[layout, spec]
    key = [tuple(getattr(s, f) for f in STAT_FIELDS) for s in r["eng"].stats]
    want = [tuple(getattr(s, f) for f in STAT_FIELDS) for s in r["ref"].stats]
    assert key == want
    assert sum(s.arrivals for s in r["eng"].stats) == len(r["reqs"])
    assert r["eng"].preemptions == 0
    assert any(s.prefill_slots for s in r["eng"].stats)
    if layout == "paged":
        alloc = r["eng"].kv.alloc
        alloc.check()
        assert (alloc.mapped_count, alloc.reserved_unmapped) == (0, 0)


@pytest.mark.parametrize("layout,spec", CASES, ids=IDS)
def test_serve_iteration_latencies_equal_reference(runs, layout, spec):
    r = runs[layout, spec]
    for i, res in r["got"].items():
        want = r["want"][i]
        assert (res.queue_delay_iters, res.ttft_iters) == (
            want.queue_delay_iters, want.ttft_iters)
        assert res.ttft_iters >= res.queue_delay_iters >= 0
        assert res.ttft_s >= res.queue_delay_s >= 0.0
        assert (res.tpot_s is None) == (len(res.tokens) < 2)
    summary = latency_summary(r["got"].values())
    assert summary["n"] == len(r["reqs"])
    assert summary["ttft_iters"]["p99"] >= summary["ttft_iters"]["p50"]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_serve_mixes_prefill_and_decode_without_extra_transfer(models,
                                                              layout):
    """A 40-token prompt arriving mid-decode does not stall the decode: at
    TLP = 1 each mixed iteration (prefill and decode slots both live) is
    one wave and one fetch, as a plain decode iteration is."""
    kw = dict(kv_layout="paged", page_size=4) if layout == "paged" else {}
    eng = _engine(models, **kw)
    long_prompt = np.random.default_rng(3).integers(3, 255, 40).tolist()
    sched = [[ServeRequest(0, [3, 5, 7], 30)], [], [],
             [ServeRequest(1, long_prompt, 4)]]
    streams, finals = _consume(eng.serve(sched))
    mixed = [s for s in eng.stats if s.prefill_slots and s.decode_slots]
    plain = [s for s in eng.stats
             if s.decode_slots and not s.prefill_slots and not s.arrivals]
    assert len(mixed) == 4 and plain     # chunks 1..4 of 5 (0 at admission)
    assert {s.transfers for s in mixed if not s.admitted} == {1}
    assert {s.transfers for s in plain} == {1}
    assert all(s.new_tokens == 1 for s in mixed)   # the decode never stalls
    offline = _offline(_engine(models, **kw),
                       [(0, [3, 5, 7], 30), (1, long_prompt, 4)])
    assert {i: r.tokens for i, r in finals.items()} == offline


# ---------------------------------------------------------------- mixed_step
def _mixed_inputs(cfg):
    """Slot 0 decodes one token at its device position, slot 1 is idle,
    slot 2 takes a full chunk pinned at offset 8 and slot 3 a ragged one
    (5 tokens) pinned at offset 2, all after an admission of 8, 5 and 8
    prompt tokens into slots 0, 2 and 3."""
    rng = np.random.default_rng(4)
    prompt = rng.integers(3, cfg.vocab_size, size=(3, 8)).astype(np.int32)
    batch = {"tokens": prompt, "prompt_lens": np.array([8, 5, 8], np.int32)}
    src = np.array([0, -1, 1, 2], np.int32)
    toks = rng.integers(3, cfg.vocab_size, size=(4, 8)).astype(np.int32)
    lens = np.array([1, 0, 8, 5], np.int32)
    pin = np.array([False, False, True, True])
    pin_pos = np.array([0, 0, 8, 2], np.int32)
    return batch, src, (toks, lens, pin, pin_pos)


@pytest.mark.parametrize("fc,attn", [("pu", "xla"), ("pim", "pim")])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_mixed_step_matches_reference(models, layout, fc, attn):
    from repro.models.layers import attn_impl as jax_attn_impl
    from repro.models.linear import fc_variant as jax_fc_variant
    (jcfg, jp), (cfg, tp) = models["target"]
    batch, src, wave = _mixed_inputs(cfg)
    if layout == "paged":
        tables = (np.random.default_rng(5).permutation(24) + 1).reshape(
            4, 6).astype(np.int32)
        jc = jm.init_paged_cache(jcfg, 4, 25, 4, 6)
        jc["block_tables"] = jnp.asarray(tables)
        tc = tm.init_paged_cache(cfg, 4, 25, 4, 6, "cpu")
        tc["block_tables"] = torch.from_numpy(tables)
        jfill, tfill = jm.prefill_to_pages, tm.prefill_to_pages
    else:
        jc, tc = jm.init_cache(jcfg, 4, 32), tm.init_cache(cfg, 4, 32, "cpu")
        jfill, tfill = jm.prefill_to_slots, tm.prefill_to_slots
    _, jc = jax.jit(jfill, static_argnums=0)(
        jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()}, jc,
        jnp.asarray(src))
    _, tc = tfill(cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                  tc, torch.from_numpy(src))
    with jax_fc_variant(fc, interpret=True), jax_attn_impl(attn):
        jl, jc2 = jax.jit(jm.mixed_step, static_argnums=0)(
            jcfg, jp, jc, *map(jnp.asarray, wave))
    with tm.fc_variant(fc), tm.attn_impl(attn):
        tl_, tc2 = tm.mixed_step(cfg, tp, tc, *map(torch.from_numpy, wave))
    live = wave[1] > 0
    np.testing.assert_allclose(tl_.numpy()[live], np.asarray(jl)[live], **TOL)
    np.testing.assert_array_equal(tc2["pos"].numpy(), np.asarray(jc2["pos"]))
    np.testing.assert_array_equal(tc2["pos"].numpy(), [9, 0, 16, 7])
    lo = 1 if layout == "paged" else 0        # page 0 collects masked rows
    for key in ("k", "v"):
        np.testing.assert_allclose(tc2[key][:, lo:].numpy(),
                                   np.asarray(jc2[key])[:, lo:], **TOL)


def test_mixed_step_decode_row_equals_decode_step(models):
    """A decode row of a mixed wave gives `decode_step`'s logits."""
    _, (cfg, tp) = models["target"]
    batch, src, (toks, lens, pin, pin_pos) = _mixed_inputs(cfg)
    cache = tm.init_cache(cfg, 4, 32, "cpu")
    _, cache = tm.prefill_to_slots(
        cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()}, cache,
        torch.from_numpy(src))
    a = {k: v.clone() for k, v in cache.items()}
    logits, _ = tm.mixed_step(cfg, tp, a, *map(torch.from_numpy,
                                               (toks, lens, pin, pin_pos)))
    one, _ = tm.decode_step(cfg, tp, cache, torch.from_numpy(toks[:, :1]))
    torch.testing.assert_close(logits[0], one[0, 0], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- the serve() loop
def _engine(models, **kw):
    _, (cfg, tp) = models["target"]
    return PapiEngine(cfg, tp, device="cpu", **{**ENGINE, **kw})


def test_serve_idle_gaps_and_trailing_drain(models):
    eng = _engine(models)
    sched = ([[ServeRequest(0, [3, 5], 3)]] + [[]] * 30
             + [ServeRequest(1, [7, 11], 3)])
    events = list(eng.serve(sched))
    finals = [ev for ev in events if ev.finished]
    assert sorted(ev.req_id for ev in finals) == [0, 1]
    assert all(isinstance(ev, TokenEvent) for ev in events)
    assert all(len(ev.result.tokens) == 3 for ev in finals)
    assert not eng.queue and not eng.active_slots


def test_serve_none_ticks_and_single_requests_arrive(models):
    eng = _engine(models)
    sched = [None, ServeRequest(0, [3, 5, 7], 2), None,
             [ServeRequest(1, [5], 2), ServeRequest(2, [9, 9], 2)]]
    _, finals = _consume(eng.serve(sched))
    assert sorted(finals) == [0, 1, 2]
    assert [s.arrivals for s in eng.stats][:1] == [1]


def test_offline_run_after_serve_is_offline_again(models):
    """stream_chunks lives as long as the generator: a later run() admits
    long prompts whole, and gives the streams of a fresh offline engine."""
    eng = _engine(models)
    _, finals = _consume(eng.serve([[ServeRequest(0, [3, 5, 7], 3)]]))
    assert eng.stream_chunks is False and sorted(finals) == [0]
    long_prompt = list(range(3, 23))
    eng.submit(ServeRequest(1, long_prompt, 4))
    res = eng.run(max_iterations=100)
    assert {r.req_id for r in res} == {0, 1}
    fresh = _offline(_engine(models), [(1, long_prompt, 4)])
    assert res[-1].tokens == fresh[1]
    assert all(s.prefill_slots == 0 for s in eng.stats[-3:])


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_serve_early_close_aborts_in_flight_and_keeps_engine_usable(
        models, layout):
    kw = dict(kv_layout="paged", page_size=4) if layout == "paged" else {}
    eng = _engine(models, eos_token=255, **kw)
    sched = [[ServeRequest(0, [3, 5, 7], 30),
              ServeRequest(1, list(range(3, 28)), 30)]]
    for ev in eng.serve(sched):
        if ev.req_id == 0 and ev.index == 2:
            break
    reasons = {r.req_id: r.finished_reason for r in eng.results}
    assert reasons == {0: "aborted", 1: "aborted"}
    assert len(eng.results[0].tokens) >= 3 and not eng.active_slots
    assert eng.stream_chunks is False
    if layout == "paged":
        eng.kv.alloc.check()
        assert eng.kv.alloc.mapped_count == 0
    eng.submit(ServeRequest(2, [7, 9], 3))
    res = eng.run(max_iterations=eng.iteration + 20)
    assert res[-1].req_id == 2 and res[-1].finished_reason == "length"


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_serve_max_iterations_aborts_in_flight(models, layout):
    kw = dict(kv_layout="paged", page_size=4) if layout == "paged" else {}
    eng = _engine(models, eos_token=255, **kw)
    sched = [[ServeRequest(0, [3, 5, 7], 30)], [ServeRequest(1, [4, 6], 2)]]
    streams, finals = _consume(eng.serve(sched, max_iterations=6))
    assert finals[0].finished_reason == "aborted"
    assert finals[1].finished_reason == "length"
    assert eng.iteration == 6 and not eng.active_slots
    assert len(finals[0].tokens) == 7      # 1 at admission + 6 decode steps
    if layout == "paged":
        assert eng.kv.alloc.mapped_count == 0


def test_step_keeps_requests_running_for_a_later_run(models):
    eng = _engine(models, eos_token=255)
    eng.submit(ServeRequest(0, [3, 5, 7], 12))
    for _ in range(4):
        eng.step()
    assert eng.results == [] and eng.active_slots == [0]
    res = eng.run(max_iterations=50)
    want = _offline(_engine(models, eos_token=255), [(0, [3, 5, 7], 12)])
    assert res[0].tokens == want[0] and res[0].finished_reason == "length"


def test_one_token_result_has_no_tpot(models):
    eng = _engine(models)
    _, finals = _consume(eng.serve([[ServeRequest(0, [3, 5, 7], 1)]]))
    res = finals[0]
    assert len(res.tokens) == 1 and res.tpot_s is None
    assert res.ttft_s is not None and res.ttft_iters == 0
    assert latency_summary([res])["tpot_s"]["count"] == 0


def test_rejected_request_has_no_latency_past_submit(models):
    eng = _engine(models)
    _, finals = _consume(eng.serve([[ServeRequest(0, [3] * 70, 4)]]))
    res = finals[0]
    assert res.finished_reason == "rejected" and res.tokens == []
    assert (res.queue_delay_s, res.ttft_s, res.tpot_s, res.ttft_iters) == (
        None, None, None, None)


# ------------------------------------------------------------- metrics
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_percentile_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 2, 7, 100):
        vals = rng.standard_normal(n).tolist()
        for q in (0, 1, 50, 90, 99, 100):
            assert percentile(vals, q) == jax_metrics.percentile(vals, q)
    assert percentile(list(range(1, 101)), 99) == 99


@dataclasses.dataclass
class _Lat:
    queue_delay_s: float | None
    ttft_s: float | None
    tpot_s: float | None
    queue_delay_iters: int | None
    ttft_iters: int | None


def test_latency_summary_matches_reference():
    rng = np.random.default_rng(3)
    rows = []
    for _ in range(40):
        v = [float(x) for x in rng.random(3)] + [
            int(x) for x in rng.integers(0, 20, 2)]
        v = [None if rng.random() < 0.2 else x for x in v]
        rows.append(_Lat(*v))
    assert latency_summary(rows) == jax_metrics.latency_summary(rows)
    assert latency_summary([]) == jax_metrics.latency_summary([])


# ------------------------------------------------------------- mamba2
def test_mamba2_serve_equals_offline_and_rejects_long_prompt():
    cfg = get_config("mamba2-1.3b-smoke")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    kw = dict(ENGINE, device="cpu")
    rng = np.random.default_rng(2)
    reqs = [(i, rng.integers(3, cfg.vocab_size, size=n).tolist(), 3 + i)
            for i, n in enumerate([3, 8, 12, 5])]
    offline = _offline(PapiEngine(cfg, params, **kw), reqs)
    eng = PapiEngine(cfg, params, **kw)
    _, finals = _consume(eng.serve(_schedule(reqs, [0, 1, 0, 2])))
    assert {i: r.tokens for i, r in finals.items()} == offline
    assert finals[2].finished_reason == "rejected"     # 12 > prefill_len 8
    assert all(finals[i].finished_reason == "length" for i in (0, 1, 3))
    assert all(s.prefill_slots == 0 for s in eng.stats)
