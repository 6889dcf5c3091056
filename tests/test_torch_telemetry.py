"""The port's telemetry against the reference's, on the CPU.

Every case of `tests/test_telemetry.py` runs on the port's `Tracer` and
engine (reduced qwen2, f32, the reference's weights carried over by
`params_from_jax`; the reference tests' engine ``max_slots=4,
cache_capacity=64, prefill_len=8``, α 6, no eos):

  * the ring keeps the NEWEST events and counts what it dropped; the
    `NullTracer` is inert;
  * a traced run emits only vocabulary kinds in iteration order;
    `EVENT_KINDS` equals the reference's and `tools/trace_report.py`'s
    copy (the reference's static PL005 mirror check reads the JAX
    package's config; its runtime equality is what ports);
  * each exporter covers every kind; chrome / prometheus / jsonl round
    trips; the program table by hand count;
  * traced streams equal untraced ones; scheduler events carry the
    estimate and α; fault / degraded counts; the stall event before the
    raise; balanced page events;
  * `tools/trace_report.py`, unchanged, validates the port's chrome and
    jsonl traces and rejects bad ones.

Parity: the port's events, time fields removed, equal the reference
engine's ``(kind, iteration, data)`` sequence for the same trace, and its
program table has the reference's keys and counts (dense, paged with a
speculative draft, and `serve()`).  On the card the timing is a CUDA
event pair resolved after the iteration's fetch; its deferral is checked
here with stand-in events (the ``gpu`` case that traces a run on the card
lives in `tests/test_torch_sanitize.py`, which imports no jax: the card's
machine has none).
"""
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.serving import FaultInjector as JaxFaults  # noqa: E402
from repro.serving import PapiEngine as JaxEngine  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro.serving import Tracer as JaxTracer  # noqa: E402
from repro.serving.telemetry import EVENT_KINDS as JAX_EVENT_KINDS  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving import (EngineStallError, FaultInjector,  # noqa: E402
                                 PapiEngine, ServeRequest, Tracer,
                                 export_chrome, export_jsonl,
                                 export_prometheus, latency_summary,
                                 write_trace)
from repro_torch.serving.telemetry import (EVENT_KINDS, NULL_TRACER,  # noqa: E402
                                           Event, format_program_key)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import trace_report  # noqa: E402  (tools/ is not a package)

NO_EOS = get_config("qwen2-0.5b-smoke").vocab_size - 1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bridge(key):
    jcfg = jax_config("qwen2-0.5b").reduced()
    jp = jax.jit(jm.init_params, static_argnums=0)(jcfg,
                                                  jax.random.PRNGKey(key))
    cfg = get_config("qwen2-0.5b-smoke")
    return (jcfg, jp), (cfg, tm.params_from_jax(
        cfg, jax.tree.map(np.asarray, jp), "cpu"))


@pytest.fixture(scope="module")
def models():
    return {"target": _bridge(0), "draft": _bridge(9)}


@pytest.fixture(scope="module")
def small_model(models):
    return models["target"][1]


@pytest.fixture(scope="module")
def draft_model(models):
    return models["draft"][1]


def _engine(cfg, params, **kw):
    defaults = dict(max_slots=4, cache_capacity=64, prefill_len=8,
                    alpha=6.0, eos_token=NO_EOS, fused=True,
                    debug_invariants=True, device="cpu")
    defaults.update(kw)
    return PapiEngine(cfg, params, **defaults)


def _submit_all(eng, n=3, max_new=6, cls=ServeRequest):
    for i in range(n):
        eng.submit(cls(i, [3 + i, 5, 7], max_new_tokens=max_new))


# ------------------------------------------------------------- ring buffer

def test_ring_truncation_keeps_newest_and_counts_dropped():
    tr = Tracer(capacity=10)
    for i in range(25):
        tr.emit("submit", iteration=i, req_id=i, prompt_len=3, max_new=4)
    events = list(tr.events)
    assert len(events) == 10
    assert tr.emitted == 25
    assert tr.dropped == 15
    assert [ev.data["req_id"] for ev in events] == list(range(15, 25))
    assert tr.counters["submit"] == 25


def test_null_tracer_is_inert():
    calls = []
    assert NULL_TRACER.emit("finish", req_id=0) is None
    assert NULL_TRACER.span("iteration", 0.0) is None
    for timed in (NULL_TRACER.timed_call, NULL_TRACER.timed_call_cuda):
        out = timed(("k",), lambda x: calls.append(x) or x, 7)
        assert out == 7
    assert calls == [7, 7]                # bare calls, nothing recorded
    assert NULL_TRACER.resolve(block=True) is None
    assert NULL_TRACER.program_table() == {}
    assert not NULL_TRACER.enabled
    assert list(NULL_TRACER.events) == []


def test_untraced_engine_calls_programs_bare(small_model):
    """Under the default NullTracer `_call` is the bare call: nothing is
    emitted or timed, and no sanitizer counts the keys."""
    cfg, params = small_model
    eng = _engine(cfg, params)
    assert eng.tracer is NULL_TRACER and eng.sanitize_report() is None
    assert eng._call(("k",), lambda a, b: a + b, 2, 3) == 5
    assert NULL_TRACER.emitted == 0 and NULL_TRACER.programs == {}


# ------------------------------------------------- traced engine: vocabulary

def test_traced_run_vocabulary_and_iteration_order(small_model):
    cfg, params = small_model
    tr = Tracer()
    eng = _engine(cfg, params, tracer=tr)
    _submit_all(eng)
    eng.run(max_iterations=60)
    events = list(tr.events)
    assert events, "traced run emitted nothing"
    assert {ev.kind for ev in events} <= EVENT_KINDS
    iters = [ev.iteration for ev in events]
    assert iters == sorted(iters), "iteration stamps must be non-decreasing"
    assert tr.counters["scheduler"] == eng.iteration
    assert tr.counters["iteration"] == eng.iteration
    assert tr.counters["tokens"] == sum(s.new_tokens for s in eng.stats)
    assert tr.counters["finish:length"] == 3


def test_event_kinds_equal_the_reference_and_the_report_tool():
    """The port keeps its own copy of the vocabulary; it must equal the
    reference's and `tools/trace_report.py`'s, which validates traces."""
    assert EVENT_KINDS == JAX_EVENT_KINDS == trace_report.EVENT_KINDS
    assert len(EVENT_KINDS) == 18


def test_all_exporters_cover_every_event_kind(tmp_path):
    tr = Tracer()
    emitters = {
        "submit": dict(req_id=0, prompt_len=3, max_new=4),
        "admit": dict(req_id=0, slot=0, prompt_len=3),
        "first_token": dict(req_id=0),
        "preempt": dict(req_id=1, slot=1, done=2),
        "finish": dict(req_id=0, reason="length", tokens=4, slot=0),
        "defer": dict(req_id=2, age=3),
        "scheduler": dict(ai_estimate=1.0, alpha=6.0, assignment="pim",
                          flipped=True, rlp=1, tlp=2),
        "iteration": dict(new_tokens=1, fc_variant="pu"),
        "pool": dict(used=1, free=7, watermark=2, fragmentation=0.0),
        "fault": dict(fault="logits_nan"),
        "degraded": dict(mode="step"),
        "program": dict(key="decode|spec_len=1"),
        "page_map": dict(slot=0, pages=2),
        "page_unmap": dict(slot=0, pages=2, cause="finish"),
        "page_reserve": dict(slot=0, budget_pages=4, mapped_pages=2),
        "stall": dict(snapshot={"iteration": 5}),
        "journal": dict(op="open", path="wal.j", records=0,
                        truncated_bytes=0),
        "recover": dict(path="wal.j", resumed=2, finished=1, records=9,
                        torn_bytes=0, next_req_id=3),
    }
    assert set(emitters) == set(EVENT_KINDS), \
        "extend this test when the vocabulary grows"
    for kind, data in emitters.items():
        tr.emit(kind, iteration=1, **data)

    path = tmp_path / "t.trace.json"
    write_trace(tr, path, "chrome")
    events, _summary = trace_report.load_trace(path)
    assert {ev["kind"] for ev in events} == set(EVENT_KINDS)

    jsonl_kinds = {json.loads(line)["kind"]
                   for line in export_jsonl(tr).strip().splitlines()}
    assert jsonl_kinds == set(EVENT_KINDS) | {"summary"}

    samples = dict(re.findall(
        r'papi_engine_events_total\{kind="([^"]+)"\} (\d+)',
        export_prometheus(tr)))
    assert set(samples) == set(EVENT_KINDS)
    assert all(int(v) == 1 for v in samples.values())
    empty = dict(re.findall(
        r'papi_engine_events_total\{kind="([^"]+)"\} (\d+)',
        export_prometheus(Tracer())))
    assert set(empty) == set(EVENT_KINDS)
    assert all(int(v) == 0 for v in empty.values())


# ---------------------------------------------------------------- exporters

def test_chrome_export_round_trip(small_model, tmp_path):
    cfg, params = small_model
    tr = Tracer()
    eng = _engine(cfg, params, tracer=tr)
    _submit_all(eng)
    eng.run(max_iterations=60)
    path = tmp_path / "t.trace.json"
    write_trace(tr, path, "chrome")
    doc = json.loads(path.read_text())
    assert "traceEvents" in doc and doc["traceEvents"]
    for rec in doc["traceEvents"]:
        assert rec["ph"] in ("M", "X", "i", "C")
        assert rec["pid"] == 1
        assert isinstance(rec["ts"], (int, float)) and rec["ts"] >= 0
        if rec["ph"] == "X":
            assert rec["dur"] >= 0
        if rec["ph"] == "C":
            assert all(isinstance(v, (int, float))
                       for v in rec["args"].values())
    papi = doc["papi"]
    assert papi["counters"]["iteration"] == eng.iteration
    assert papi["events_dropped"] == 0
    assert papi["programs"], "traced run must record program timings"
    slot_spans = [r for r in doc["traceEvents"]
                  if r["ph"] == "X" and r.get("name", "").startswith("req ")]
    assert len(slot_spans) == 3


def test_prometheus_export_parses(small_model):
    cfg, params = small_model
    tr = Tracer()
    eng = _engine(cfg, params, tracer=tr)
    _submit_all(eng)
    eng.run(max_iterations=60)
    text = export_prometheus(tr)
    line_re = re.compile(
        r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9eE.+-]+$')
    names = set()
    for line in text.strip().splitlines():
        if line.startswith("#"):
            continue
        assert line_re.match(line), f"unparseable sample line: {line!r}"
        names.add(line.split("{")[0].split(" ")[0])
    for required in ("papi_engine_iterations_total",
                     "papi_engine_tokens_total",
                     "papi_engine_preemptions_total",
                     "papi_engine_degraded_steps_total",
                     "papi_engine_kv_pages_used",
                     "papi_engine_program_runs_total"):
        assert required in names
    assert (f"papi_engine_iterations_total {eng.iteration}"
            in text.splitlines())


def test_jsonl_export_has_trailing_summary(small_model):
    cfg, params = small_model
    tr = Tracer()
    eng = _engine(cfg, params, tracer=tr)
    _submit_all(eng, n=1)
    eng.run(max_iterations=30)
    lines = export_jsonl(tr).strip().splitlines()
    recs = [json.loads(ln) for ln in lines]
    assert all(r["kind"] in EVENT_KINDS for r in recs[:-1])
    assert recs[-1]["kind"] == "summary"
    assert recs[-1]["data"]["counters"]["iteration"] == eng.iteration
    assert recs[-1]["data"]["programs"]


# ----------------------------------------------------------- program timing

def test_program_table_hand_counted(small_model):
    """One greedy request, max_new=5, eos never fires: exactly 1 main
    prefill call and 4 plain_fused decode calls."""
    cfg, params = small_model
    tr = Tracer()
    eng = _engine(cfg, params, tracer=tr)
    eng.submit(ServeRequest(0, [3, 5, 7], max_new_tokens=5))
    res = eng.run(max_iterations=30)
    assert len(res[0].tokens) == 5
    table = tr.program_table()
    by_kind = {}
    for key, t in table.items():
        by_kind[key.split("|")[0]] = by_kind.get(key.split("|")[0], 0) \
            + t["count"]
    assert by_kind == {"main": 1, "plain_fused": 4}
    for t in table.values():
        assert t["count"] >= 1
        assert 0.0 <= t["min_s"] <= t["mean_s"] <= t["max_s"]
        assert abs(t["mean_s"] * t["count"] - t["total_s"]) < 1e-9
    progs = [ev for ev in tr.events if ev.kind == "program"]
    assert len(progs) == sum(t["count"] for t in table.values())
    assert all(ev.dur > 0 for ev in progs)


def test_format_program_key_compresses_defaults():
    assert format_program_key(("spec_fused", 4, "pim", None, False)) == \
        "spec_fused|4|pim|-|-"
    assert format_program_key(("main", "pu", True, True)) == "main|pu|True|True"


class _StandInEvent:
    """Stands in for `torch.cuda.Event` in `Tracer.resolve`: complete
    once `done` is set, at `t` milliseconds."""

    def __init__(self, t, done):
        self.t, self.done = t, done

    def query(self):
        return self.done["ok"]

    def synchronize(self):
        self.done["ok"] = True

    def elapsed_time(self, stop):
        return stop.t - self.t


def test_card_timings_resolve_only_after_the_stream_drained():
    """The card path emits each ``program`` event at the call and folds
    its time into the table only when `resolve` finds the stop event
    complete (after the iteration's fetch), in call order; a blocking
    resolve (the exporters, `program_table`) waits for the rest."""
    tr = Tracer()
    first, second = {"ok": False}, {"ok": False}
    for key, (t0, t1), done in ((("a",), (0.0, 2.0), first),
                                (("b",), (2.0, 5.0), second)):
        ev = tr.emit("program", key=format_program_key(key))
        tr._pending.append((key, ev, _StandInEvent(t0, done),
                            _StandInEvent(t1, done)))
    tr.resolve()
    assert tr.programs == {} and len(tr._pending) == 2
    first["ok"] = True
    tr.resolve()
    assert list(tr.programs) == [("a",)] and len(tr._pending) == 1
    assert tr.programs[("a",)].total_s == pytest.approx(2e-3)
    table = tr.program_table()                   # blocks for "b"
    assert table["b"]["total_s"] == pytest.approx(3e-3)
    assert [ev.dur for ev in tr.events] == pytest.approx([2e-3, 3e-3])
    assert tr._pending == []


# ------------------------------------------------- observation only (serve)

def test_serve_streams_bit_identical_traced_vs_untraced(small_model):
    cfg, params = small_model
    schedule = [[ServeRequest(0, [3, 5, 7], max_new_tokens=6)], [],
                [ServeRequest(1, [4, 6], max_new_tokens=5)], [],
                [ServeRequest(2, [5, 7, 9, 11], max_new_tokens=4)]]

    def streams(tracer):
        eng = _engine(cfg, params, tracer=tracer)
        got = {}
        for ev in eng.serve([list(w) for w in schedule]):
            if ev.finished:
                got[ev.req_id] = ev.result.tokens
        return got, [(s.transfers, s.new_tokens) for s in eng.stats]

    untraced = streams(None)
    tr = Tracer()
    traced = streams(tr)
    assert traced == untraced
    assert tr.counters["finish:length"] == 3
    assert tr.counters["submit"] == 3


# ------------------------------------- scheduler, faults, degraded, stalls

def test_scheduler_events_carry_estimate_and_threshold(small_model,
                                                       draft_model):
    cfg, params = small_model
    tr = Tracer()
    eng = _engine(cfg, params, tracer=tr, spec_len=3, draft=draft_model)
    _submit_all(eng, n=4, max_new=8)
    eng.run(max_iterations=80)
    sched = [ev for ev in tr.events if ev.kind == "scheduler"]
    assert sched
    for ev in sched:
        assert ev.data["alpha"] == eng.scheduler.alpha
        assert ev.data["assignment"] in ("pu", "pim")
        assert isinstance(ev.data["ai_estimate"], float)
    flips = [ev for ev in sched if ev.data["flipped"]]
    assert len(flips) == tr.counters["scheduler_flip"]
    assert len(flips) <= eng.scheduler.num_reschedules
    assert len(tr.program_table()) >= 2


def test_faults_and_degraded_events_match_engine_counts(small_model,
                                                        draft_model):
    cfg, params = small_model
    tr = Tracer()
    eng = _engine(cfg, params, tracer=tr, spec_len=3, draft=draft_model,
                  kv_layout="paged", page_size=8,
                  faults=FaultInjector(seed=3, nan_p=0.4, start=1, stop=8))
    _submit_all(eng, n=3, max_new=8)
    eng.run(max_iterations=80)
    assert eng.degraded_steps > 0, "fault seed never fired; test is vacuous"
    assert tr.counters["degraded"] == eng.degraded_steps
    assert tr.counters["fault:nan"] == eng.faults.counts["nan"]
    degraded_iters = {ev.iteration for ev in tr.events
                      if ev.kind == "degraded"}
    flagged = {s.iteration - 1 for s in eng.stats if s.degraded}
    assert degraded_iters == flagged
    spans = {ev.iteration: ev.data["degraded"] for ev in tr.events
             if ev.kind == "iteration"}
    assert all(spans[i] for i in flagged)
    # the re-runs are timed under the reference's oracle keys
    assert tr.program_table()["oracle|main"]["count"] == eng.degraded_steps


def test_stall_event_emitted_before_raise(small_model):
    cfg, params = small_model
    tr = Tracer()
    eng = _engine(cfg, params, tracer=tr, cache_capacity=16,
                  kv_layout="paged", page_size=4, stall_limit=5)
    eng.kv.can_admit = lambda *_: False
    eng.submit(ServeRequest(0, [3, 5, 7], max_new_tokens=4))
    with pytest.raises(EngineStallError):
        eng.run(max_iterations=100)
    assert tr.counters["stall"] == 1
    stall = [ev for ev in tr.events if ev.kind == "stall"][-1]
    assert stall.data["snapshot"]["queue"] == [0]
    assert tr.counters["defer"] >= 5


def test_page_events_balance_on_drained_pool(small_model):
    cfg, params = small_model
    tr = Tracer()
    eng = _engine(cfg, params, tracer=tr, cache_capacity=32,
                  kv_layout="paged", page_size=4)
    _submit_all(eng, n=3, max_new=6)
    eng.run(max_iterations=60)
    assert eng.kv.alloc.mapped_count == 0, "pool must drain after run()"
    mapped = sum(ev.data["mapped_pages"] for ev in tr.events
                 if ev.kind == "page_reserve")
    mapped += sum(ev.data["pages"] for ev in tr.events
                  if ev.kind == "page_map")
    unmapped = sum(ev.data["pages"] for ev in tr.events
                   if ev.kind == "page_unmap")
    assert mapped > 0
    assert mapped == unmapped
    for ev in tr.events:
        if ev.kind == "pool":
            assert ev.data["used"] <= ev.data["watermark"]


def test_page_events_only_when_asked(small_model):
    """Page events attach under debug_invariants or ``page_events=True``."""
    cfg, params = small_model
    quiet = _engine(cfg, params, tracer=Tracer(), kv_layout="paged",
                    page_size=4, debug_invariants=False)
    assert quiet.kv.tracer is None
    tr = Tracer(page_events=True)
    loud = _engine(cfg, params, tracer=tr, kv_layout="paged", page_size=4,
                   debug_invariants=False)
    assert loud.kv.tracer is tr


# ----------------------------------------------------------- trace_report

def test_trace_report_validates_both_formats(small_model, tmp_path):
    cfg, params = small_model
    tr = Tracer()
    eng = _engine(cfg, params, tracer=tr)
    _submit_all(eng, n=2)
    eng.run(max_iterations=40)
    chrome = tmp_path / "t.trace.json"
    jsonl = tmp_path / "t.jsonl"
    write_trace(tr, chrome, "chrome")
    write_trace(tr, jsonl, "jsonl")
    assert trace_report.main([str(chrome), "--validate"]) == 0
    assert trace_report.main([str(jsonl), "--validate"]) == 0
    assert trace_report.main([str(chrome)]) == 0
    assert trace_report.main([str(jsonl)]) == 0
    _, summ_c = trace_report.load_trace(chrome)
    _, summ_j = trace_report.load_trace(jsonl)
    assert summ_c["counters"] == summ_j["counters"]
    assert summ_c["programs"].keys() == summ_j["programs"].keys()


def test_trace_report_rejects_bad_traces(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"kind": "martian", "iteration": 0,
                               "ts": 0.0, "dur": 0.0, "data": {}}) + "\n")
    assert trace_report.main([str(bad), "--validate"]) == 1
    missing = tmp_path / "nope.json"
    assert trace_report.main([str(missing), "--validate"]) == 1
    empty = tmp_path / "empty.jsonl"
    write_trace(Tracer(), empty, "jsonl")
    assert trace_report.main([str(empty), "--validate"]) == 1


# ----------------------------------------------------------------- metrics

def test_latency_summary_counts_and_single_token_tpot(small_model):
    cfg, params = small_model
    eng = _engine(cfg, params)
    eng.submit(ServeRequest(0, [3, 5, 7], max_new_tokens=1))
    eng.submit(ServeRequest(1, [4, 6], max_new_tokens=5))
    res = {r.req_id: r for r in eng.run(max_iterations=30)}
    assert len(res[0].tokens) == 1
    assert res[0].tpot_s is None, "tpot is undefined for a 1-token request"
    assert res[1].tpot_s is not None and res[1].tpot_s >= 0.0
    summ = latency_summary(res.values())
    assert summ["n"] == 2
    assert summ["ttft_s"]["count"] == 2
    assert summ["tpot_s"]["count"] == 1
    for field, table in summ.items():
        if field == "n":
            continue
        assert set(table) >= {"p50", "p99", "mean", "count"}


# ---------------------------------------------------- parity with the JAX

def _untimed(tracer) -> list:
    """(kind, iteration, data) of every event, the time fields dropped."""
    return [(ev.kind, ev.iteration, ev.data) for ev in tracer.events]


def _counts(tracer) -> dict:
    return {k: t["count"] for k, t in tracer.program_table().items()}


SCHEDULE = [[(0, [3, 5, 7, 9, 11, 13, 15, 17, 19, 21], 6)], [],
            [(1, [4, 6], 5), (2, [5, 7, 9], 7)], [],
            [(3, [6, 8, 10, 12], 4)]]


@pytest.mark.parametrize("case", ["dense", "paged spec", "serve dense",
                                  "serve paged spec"])
def test_events_and_programs_equal_the_reference(models, case):
    """The same trace through both engines: the event sequence without
    its time fields, and the program table's keys and counts, equal."""
    kw = dict(max_slots=4, cache_capacity=64, prefill_len=8, alpha=6.0,
              eos_token=NO_EOS, debug_invariants=True)
    jkw, tkw = dict(kw), dict(kw)
    if "paged" in case:
        for d in (jkw, tkw):
            d.update(kv_layout="paged", page_size=4)
    if "spec" in case:
        jkw.update(spec_len=2, draft=models["draft"][0])
        tkw.update(spec_len=2, draft=models["draft"][1])
    jtr, ttr = JaxTracer(), Tracer()
    ref = JaxEngine(*models["target"][0], tracer=jtr, **jkw)
    eng = PapiEngine(*models["target"][1], tracer=ttr, device="cpu", **tkw)
    if case.startswith("serve"):
        def run(e, cls):
            sched = [[cls(i, list(p), max_new_tokens=n) for i, p, n in tick]
                     for tick in SCHEDULE]
            return {ev.req_id: ev.result.tokens
                    for ev in e.serve(sched) if ev.finished}
    else:
        def run(e, cls):
            for i, p, n in (r for tick in SCHEDULE for r in tick):
                e.submit(cls(i, list(p), max_new_tokens=n))
            return {r.req_id: r.tokens for r in e.run(max_iterations=200)}
    assert run(eng, ServeRequest) == run(ref, JaxRequest)
    assert _untimed(ttr) == _untimed(jtr)
    assert _counts(ttr) == _counts(jtr)
    assert ttr.counters == jtr.counters


def test_fault_events_equal_the_reference(models):
    """A nan / kernel / admit fault window: the fault, degraded and
    program events (the oracle re-runs' keys too) equal the reference's."""
    faults = dict(seed=3, nan_p=0.3, kernel_p=0.2, admit_p=0.2, start=1,
                  stop=12)
    kw = dict(max_slots=4, cache_capacity=64, prefill_len=8, alpha=6.0,
              eos_token=NO_EOS)
    jtr, ttr = JaxTracer(), Tracer()
    ref = JaxEngine(*models["target"][0], tracer=jtr,
                    faults=JaxFaults(**faults), **kw)
    eng = PapiEngine(*models["target"][1], tracer=ttr, device="cpu",
                     faults=FaultInjector(**faults), **kw)
    for e, cls in ((ref, JaxRequest), (eng, ServeRequest)):
        _submit_all(e, n=3, max_new=8, cls=cls)
        e.run(max_iterations=80)
    assert ttr.counters["degraded"] > 0
    assert _untimed(ttr) == _untimed(jtr)
    assert _counts(ttr) == _counts(jtr)


def test_event_dataclass_is_the_reference_shape():
    from repro.serving.telemetry import Event as JaxEvent
    ours = Event("submit", 1, 0.5)
    theirs = JaxEvent("submit", 1, 0.5)
    assert vars(ours) == vars(theirs)
