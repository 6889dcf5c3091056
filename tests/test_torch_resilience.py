"""The port's failure model against the JAX package's, on the CPU.

Reduced qwen2 (f32, 2 layers, d=128; the reference's weights carried over
by `params_from_jax`) and a seed-9 draft, at the reference tests' engine
(``max_slots=4, cache_capacity=64, prefill_len=8``, α 6, no eos,
``debug_invariants=True``) and its tight paged pool (``cache_capacity=16,
page_size=4``: two of three requests fit).  Every case of
`tests/test_resilience.py` runs on both engines with the same requests and
fault schedules, and the port must give the reference's streams,
``finished_reason`` and ``prompt_len``, and per iteration the same
``preemptions``, ``deferral_age``, ``degraded``, transfers, new tokens and
admissions:

* pool-pressure preemption (``preempt_after``, greedy and speculative)
  equals the unconstrained dense run; the oldest
  request is never preempted; one request in flight is never preempted;
* deadlines and `cancel`, queued and in flight (``_now`` patched), and
  `run()` exhaustion finish honestly and drain the pool;
* admission faults defer; ``nan`` / ``kernel`` faults degrade the plain
  step, the speculative verify and the mixed wave (dense and paged) into
  a re-run on the plain path without changing a stream, and a re-run that
  is non-finite again raises; a latency fault trips a
  deadline; a crash raises `EngineCrashError` with no clean-up, also out
  of ``serve()``;
* the watchdog's `EngineStallError` and ``debug_invariants``'s
  `AllocatorInvariantError` carry the reference's snapshots;
* through ``serve()``: preemption mid-stream (indices go on after
  re-admission, nothing is sent twice), cancel and timeout mid-stream,
  `test_serving_stream.py`'s NaN-fault and FIFO-fairness cases (seed 6174,
  whose cancel between two events frees a slot the reference's loop then
  trips on, included);
* mamba2 (the SSM family, whose decode step writes its new state to
  fresh tensors): a stream with injected faults equals the fault-free
  stream and the reference run on each prompt alone (the reference
  engine's prefill takes in the window's padding, ROADMAP queue 3; its
  reasons and per-iteration counters must still be equal).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.serving import AllocatorInvariantError as JaxInvariantError  # noqa: E402
from repro.serving import EngineCrashError as JaxCrashError  # noqa: E402
from repro.serving import EngineStallError as JaxStallError  # noqa: E402
from repro.serving import FaultInjector as JaxFaults  # noqa: E402
from repro.serving import PapiEngine as JaxEngine  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving import (AllocatorInvariantError,  # noqa: E402
                                 EngineCrashError, EngineStallError,
                                 FaultInjector, PapiEngine, ServeRequest)
from _ssm_oracle import greedy_streams  # noqa: E402

ENGINE = dict(max_slots=4, cache_capacity=64, prefill_len=8, alpha=6.0,
              debug_invariants=True)
TIGHT = dict(max_slots=4, cache_capacity=16, kv_layout="paged", page_size=4)
# three requests whose page budgets oversubscribe the tight pool
PRESSURE_REQS = [([3 + i, 5, 7], 20) for i in range(3)]
GUARD_REQS = [([3, 5, 7], 12), ([4, 5], 12)]
ITER_FIELDS = ("preemptions", "deferral_age", "degraded", "transfers",
               "new_tokens", "admitted", "decode_slots", "prefill_slots")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bridge(arch, jcfg, key):
    jp = jax.jit(jm.init_params, static_argnums=0)(jcfg,
                                                  jax.random.PRNGKey(key))
    cfg = get_config(arch + "-smoke")
    return (jcfg, jp), (cfg, tm.params_from_jax(
        cfg, jax.tree.map(np.asarray, jp), "cpu"))


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("qwen2-0.5b").reduced()
    return {"target": _bridge("qwen2-0.5b", jcfg, 0),
            "seed9": _bridge("qwen2-0.5b", jcfg, 9)}


NO_EOS = get_config("qwen2-0.5b-smoke").vocab_size - 1


def _engines(models, *, spec=False, faults=None, eos=NO_EOS, **kw):
    """(reference engine, port engine) on the same weights, settings and
    fault schedule (`faults`: FaultInjector keywords)."""
    (jcfg, jp), (cfg, tp) = models["target"]
    opts = {**ENGINE, "eos_token": eos, **kw}
    jkw, tkw = dict(opts), dict(opts)
    if spec:
        jkw.update(spec_len=2, draft=models["seed9"][0])
        tkw.update(spec_len=2, draft=models["seed9"][1])
    if faults is not None:
        jkw["faults"], tkw["faults"] = JaxFaults(**faults), FaultInjector(
            **faults)
    return (JaxEngine(jcfg, jp, **jkw),
            PapiEngine(cfg, tp, device="cpu", **tkw))


def _submit(eng, reqs, cls):
    for i, (prompt, n) in enumerate(reqs):
        eng.submit(cls(i, list(prompt), max_new_tokens=n))


def _run_both(ref, eng, reqs, max_iterations=500):
    """Both engines' {req_id: (tokens, reason, prompt_len)} of one offline
    run; the per-iteration counters must be equal."""
    _submit(ref, reqs, JaxRequest)
    _submit(eng, reqs, ServeRequest)
    want = _results(ref.run(max_iterations=max_iterations))
    got = _results(eng.run(max_iterations=max_iterations))
    assert got == want
    assert _per_iteration(eng) == _per_iteration(ref)
    return got


def _results(results):
    return {r.req_id: (r.tokens, r.finished_reason, r.prompt_len)
            for r in results}


def _per_iteration(eng):
    return [(s.iteration,) + tuple(getattr(s, f) for f in ITER_FIELDS)
            for s in eng.stats]


def _assert_drained(eng):
    eng.kv.alloc.check()
    assert eng.kv.alloc.mapped_count == 0
    assert eng.kv.alloc.reserved_unmapped == 0
    assert eng.kv.alloc.free_count == eng.kv.alloc.num_pages


@pytest.fixture(scope="module")
def dense_pressure(models):
    """The unconstrained dense run of PRESSURE_REQS (port and reference)."""
    return _run_both(*_engines(models), PRESSURE_REQS)


# ---------------------------------------------------------------- preemption

@pytest.mark.parametrize("trigger", ["after", "spec"])
def test_preemption_equals_unconstrained_and_reference(models, dense_pressure,
                                                       trigger):
    kw = {"after": dict(preempt_after=3),
          "spec": dict(preempt_after=3, spec=True)}[trigger]
    ref, eng = _engines(models, **TIGHT, **kw)
    got = _run_both(ref, eng, PRESSURE_REQS)
    assert eng.preemptions >= 1 and eng.preemptions == ref.preemptions
    assert eng.preempted_ids == ref.preempted_ids
    assert sum(s.preemptions for s in eng.stats) == eng.preemptions
    for i, (prompt, _) in enumerate(PRESSURE_REQS):
        assert got[i][0] == dense_pressure[i][0], i
        assert got[i][1:] == ("length", len(prompt))
    _assert_drained(eng)


def test_oldest_never_preempted_and_deferral_age_grows(models):
    K = 4
    ref, eng = _engines(models, **TIGHT, preempt_after=K)
    got = _run_both(ref, eng, PRESSURE_REQS)
    ages = [s.deferral_age for s in eng.stats]
    assert max(ages) == K
    first = next(i for i, a in enumerate(ages) if a == 1)
    assert ages[first:first + K] == list(range(1, K + 1))
    assert eng.stats[first + K - 1].preemptions == 1
    assert 1 in eng.preempted_ids and 0 not in eng.preempted_ids
    assert all(r[1] == "length" for r in got.values())
    _assert_drained(eng)


def test_no_preemption_with_single_active(models):
    ref, eng = _engines(models, **{**TIGHT, "cache_capacity": 8},
                        preempt_after=2)
    got = _run_both(ref, eng, [([3, 5, 7], 20), ([4, 5, 7], 20)])
    assert eng.preemptions == 0
    assert all(len(t) == 20 and r == "length" for t, r, _ in got.values())
    _assert_drained(eng)


# ------------------------------------------------------ deadlines and cancel

def _step_to(eng, n):
    """`run(max_iterations=n)` without aborting what is in flight."""
    while (eng.queue or eng.active_slots) and eng.iteration < n:
        eng.step()


def test_deadline_timeout_in_flight_and_queued(models):
    ref, eng = _engines(models, **{**TIGHT, "max_slots": 1})
    clock = {"now": 0.0}
    for e, cls in ((ref, JaxRequest), (eng, ServeRequest)):
        e._now = lambda: clock["now"]
        e.submit(cls(0, [3, 5, 7], max_new_tokens=30, deadline_s=5.0))
        e.submit(cls(1, [4, 5, 7], max_new_tokens=30, deadline_s=5.0))
    ref.run(max_iterations=3, abort_in_flight=False)
    _step_to(eng, 3)
    assert eng.active_slots == [0] and len(eng.queue) == 1
    clock["now"] = 10.0
    want = _results(ref.run(max_iterations=10))
    res = _results(eng.run(max_iterations=10))
    assert res == want
    assert res[0][1] == "timeout" and len(res[0][0]) >= 1
    assert res[1][:2] == ([], "timeout")
    assert _per_iteration(eng) == _per_iteration(ref)
    _assert_drained(eng)


def test_cancel_queued_and_in_flight(models):
    ref, eng = _engines(models, **{**TIGHT, "max_slots": 1})
    for e, cls in ((ref, JaxRequest), (eng, ServeRequest)):
        e.submit(cls(0, [3, 5, 7], max_new_tokens=30))
        e.submit(cls(1, [4, 5, 7], max_new_tokens=30))
    ref.run(max_iterations=3, abort_in_flight=False)
    _step_to(eng, 3)
    calls = [(1, True), (0, True), (99, False), (1, False)]
    for rid, ok in calls:
        assert ref.cancel(rid) is ok
        assert eng.cancel(rid) is ok
    res = _results(eng.results)
    assert res == _results(ref.results)
    assert res[1][:2] == ([], "cancelled")
    assert res[0][1] == "cancelled" and len(res[0][0]) >= 1
    _assert_drained(eng)


def test_run_exhaustion_aborts_in_flight(models):
    ref, eng = _engines(models, **TIGHT)
    got = _run_both(ref, eng, [([3, 5, 7], 20), ([4, 5, 7], 20)],
                    max_iterations=3)
    assert sorted(got) == [0, 1]
    assert all(r == "aborted" and len(t) >= 1 for t, r, _ in got.values())
    _assert_drained(eng)


# ------------------------------------------------------------ fault injection

def test_admission_fault_defers_then_recovers(models):
    faults = dict(seed=0, admit_p=1.0, start=1, stop=4)
    ref, eng = _engines(models, **TIGHT, preempt_after=None, faults=faults)
    got = _run_both(ref, eng, PRESSURE_REQS)
    assert eng.faults.counts == ref.faults.counts
    assert eng.faults.counts["admit"] >= 3
    assert max(s.deferral_age for s in eng.stats) >= 4
    assert all(len(t) == 20 and r == "length" for t, r, _ in got.values())
    _assert_drained(eng)


@pytest.fixture(scope="module")
def clean_guard(models):
    """The fault-free dense run of GUARD_REQS."""
    return _run_both(*_engines(models), GUARD_REQS)


@pytest.mark.parametrize("kind", ["nan", "kernel"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_logits_guard_degrades_to_the_clean_stream(models, clean_guard, kind,
                                                   layout, spec):
    """Poisoned logits out of the plain step or the speculative verify
    never reach a token: the step is re-run on the plain path, counted in
    `degraded` at the reference's iterations, and the stream equals the
    fault-free one."""
    p = 0.5 if spec and kind == "nan" else 1.0
    faults = dict(seed=5, start=1, stop=8, **{f"{kind}_p": p})
    kw = dict(kv_layout="paged", page_size=4) if layout == "paged" else {}
    ref, eng = _engines(models, spec=spec, faults=faults, **kw)
    got = _run_both(ref, eng, GUARD_REQS)
    assert got == clean_guard
    assert eng.degraded_steps >= 1 and eng.degraded_steps == ref.degraded_steps
    assert eng.faults.counts == ref.faults.counts
    assert eng.faults.counts[kind] >= 1
    assert sum(s.degraded for s in eng.stats) == eng.degraded_steps
    if layout == "paged":
        _assert_drained(eng)


def test_guard_takes_no_fault_under_the_host_loop(models, clean_guard):
    """``fused=False`` runs the unguarded host loop: the injector is never
    consulted for logits, as in the reference."""
    faults = dict(seed=5, nan_p=1.0)
    ref, eng = _engines(models, spec=True, faults=faults, fused=False)
    got = _run_both(ref, eng, GUARD_REQS)
    assert got == clean_guard
    assert eng.degraded_steps == 0 and eng.faults.counts["nan"] == 0


def _poisoned(fn):
    """`fn` with every logit it returns replaced by NaN: a fault of the
    path itself, which a re-run does not clear."""
    def wrapped(*args, **kw):
        logits, cache = fn(*args, **kw)
        return torch.full_like(logits, float("nan")), cache
    return wrapped


@pytest.mark.parametrize("path", ["step", "spec", "wave"])
def test_rerun_nonfinite_again_raises(models, monkeypatch, path):
    """Logits that are non-finite on the re-run too, with no fault
    injected, are not served: the engine counts one degraded step and
    raises."""
    import repro_torch.serving.engine as engine_mod
    fn = "mixed_step" if path == "wave" else "decode_step"
    monkeypatch.setattr(engine_mod, fn, _poisoned(getattr(engine_mod, fn)))
    _, eng = _engines(models, spec=(path == "spec"))
    with pytest.raises(RuntimeError, match="again on the re-run"):
        if path == "wave":
            # a prompt longer than the window enters mid-prefill, and the
            # next iteration runs the mixed wave
            for _ in eng.serve([[ServeRequest(0, list(range(3, 15)), 4),
                                 ServeRequest(1, [4, 5], 4)]]):
                pass
        else:
            _submit(eng, GUARD_REQS, ServeRequest)
            eng.run(max_iterations=20)
    assert eng.degraded_steps == 1


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("attn_pim", [False, True])
def test_rerun_scope_keeps_the_kernels_on_the_card(models, device, attn_pim):
    """A degraded re-run takes the reference's plain path ("pu" FC, plain
    attention) only where the wrappers take their plain versions anyway,
    on CPU tensors; on the card it keeps the engine's FC variant and
    attention, since a CUDA tensor goes to its kernel or raises.  (The
    engine here lives on the CPU; only its device attribute is set.)"""
    from repro_torch.models.layers import current_attn_impl
    from repro_torch.models.linear import current_fc_variant
    _, eng = _engines(models, attn_pim=attn_pim, alpha=99.0)
    assert eng.scheduler.fc_assignment == "pim"       # alpha above any AI
    eng.device = torch.device(device)
    with eng._rerun_scope():
        got = (current_fc_variant(), current_attn_impl())
    if device == "cpu":
        assert got == ("pu", "xla")
    else:
        assert got == ("pim", "pim" if attn_pim else "xla")


def test_latency_fault_trips_deadline(models):
    _, eng = _engines(models, **TIGHT,
                      faults=dict(seed=0, latency_p=1.0, latency_s=0.05))
    eng.submit(ServeRequest(0, [3, 5, 7], max_new_tokens=200,
                            deadline_s=0.15))
    res = eng.run(max_iterations=50)
    assert eng.faults.counts["latency"] >= 1
    assert res[0].finished_reason == "timeout"
    _assert_drained(eng)


def test_crash_fault_raises_with_no_clean_up(models):
    faults = dict(seed=0, crash_p=1.0, start=3)
    ref, eng = _engines(models, faults=faults)
    for e, cls in ((ref, JaxRequest), (eng, ServeRequest)):
        _submit(e, GUARD_REQS, cls)
    with pytest.raises(JaxCrashError) as want:
        ref.run(max_iterations=50)
    with pytest.raises(EngineCrashError) as got:
        eng.run(max_iterations=50)
    assert got.value.iteration == want.value.iteration == 3
    assert eng.results == [] and len(eng.active_slots) == 2
    assert _per_iteration(eng) == _per_iteration(ref)
    # out of serve(): re-raised, the slots left as they were
    _, live = _engines(models, faults=faults)
    sched = [[ServeRequest(i, list(p), n)]
             for i, (p, n) in enumerate(GUARD_REQS)]
    with pytest.raises(EngineCrashError):
        for _ in live.serve(sched):
            pass
    assert live.results == [] and len(live.active_slots) == 2


# --------------------------------------------------- watchdog and invariants

def test_watchdog_raises_structured_stall_error(models):
    ref, eng = _engines(models, **TIGHT, stall_limit=5)
    errs = []
    for e, cls, err in ((ref, JaxRequest, JaxStallError),
                        (eng, ServeRequest, EngineStallError)):
        e.kv.can_admit = lambda *_: False
        e.submit(cls(0, [3, 5, 7], max_new_tokens=4))
        with pytest.raises(err) as got:
            e.run(max_iterations=100)
        errs.append(got.value)
    want, got = errs
    snap = got.snapshot
    assert snap == want.snapshot
    assert snap["queue"] == [0] and snap["deferral_age"] >= 5
    assert snap["pool"]["free"] == eng.kv.alloc.num_pages
    assert eng.iteration == ref.iteration < 100


def test_debug_invariants_raises_structured_error(models):
    ref, eng = _engines(models, **TIGHT)
    errs = []
    for e, cls, err in ((ref, JaxRequest, JaxInvariantError),
                        (eng, ServeRequest, AllocatorInvariantError)):
        e.submit(cls(0, [3, 5, 7], max_new_tokens=30))
        if e is ref:
            e.run(max_iterations=2, abort_in_flight=False)
        else:
            _step_to(e, 2)
        assert e.active_slots == [0]
        e.kv.alloc._free.append(e.kv.alloc.pages_of(0)[0])
        with pytest.raises(err) as got:
            e.step()
        errs.append(got.value)
    want, got = errs
    assert "invariant" in str(got)
    assert got.snapshot == want.snapshot and got.snapshot["pool"]["mapped"]


# ------------------------------------------------------- streaming front end

def _events(gen, on_event=None):
    """The (req_id, token, index, finished, reason) of every event."""
    out = []
    for ev in gen:
        out.append((ev.req_id, ev.token, ev.index, ev.finished, ev.reason))
        if on_event is not None:
            on_event(ev)
    return out


def _streams(events):
    """{req_id: tokens} of an event list, checking that indices are
    contiguous (none repeats, none is skipped) and that each final event
    comes after its tokens."""
    streams, done = {}, set()
    for rid, tok, idx, fin, _ in events:
        assert rid not in done
        if fin:
            assert idx == len(streams.get(rid, []))
            done.add(rid)
        else:
            streams.setdefault(rid, []).append(tok)
            assert idx == len(streams[rid]) - 1
    return streams


def _schedule(reqs, gaps, cls, deadline=None):
    sched = []
    for (i, prompt, budget), gap in zip(reqs, gaps):
        sched.extend([[]] * gap)
        sched.append([cls(i, list(prompt), budget, deadline_s=deadline)])
    return sched


def test_serve_preemption_streams_equal_reference(models, dense_pressure):
    ref, eng = _engines(models, **TIGHT, preempt_after=3)
    reqs = [(i, p, n) for i, (p, n) in enumerate(PRESSURE_REQS)]
    want = _events(ref.serve(_schedule(reqs, [0] * 3, JaxRequest)))
    got = _events(eng.serve(_schedule(reqs, [0] * 3, ServeRequest)))
    assert got == want
    assert eng.preemptions >= 1
    streams = _streams(got)
    for i in range(3):
        assert streams[i] == dense_pressure[i][0], i
    assert [e[4] for e in got if e[3]] == ["length"] * 3
    assert _per_iteration(eng) == _per_iteration(ref)
    _assert_drained(eng)


def test_serve_cancel_and_timeout_mid_stream(models):
    ref, eng = _engines(models, max_slots=1)
    got = []
    for e, cls in ((ref, JaxRequest), (eng, ServeRequest)):
        clock = {"now": 0.0}
        e._now = lambda c=clock: c["now"]
        sched = [[cls(0, [3, 5, 7], max_new_tokens=60)],
                 [cls(1, [4, 5, 7], max_new_tokens=30, deadline_s=5.0)]]
        seen = []

        def on_event(ev, e=e, clock=clock, seen=seen):
            if not ev.finished and ev.req_id == 0:
                seen.append(ev.token)
                if len(seen) == 4:
                    clock["now"] = 10.0          # expire the queued deadline
                    assert e.cancel(0) is True   # cancel the one mid-stream
        got.append(_events(e.serve(sched), on_event))
    want, got = got
    assert got == want
    streams = _streams(got)
    finals = {e[0]: e[4] for e in got if e[3]}
    assert finals == {0: "cancelled", 1: "timeout"}
    assert len(streams[0]) >= 4 and 1 not in streams


def _stream_requests(seed, n, vocab, max_prompt=30, max_new=10):
    """`test_serving_stream.py`'s workload."""
    rng = np.random.default_rng(seed)
    return [(i, [int(t) for t in rng.integers(3, vocab - 1,
                                              rng.integers(3, max_prompt))],
             int(rng.integers(2, max_new))) for i in range(n)]


STREAM_GAPS = [0, 0, 2, 0, 1, 3, 0, 5]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_serve_nan_fault_degrades_but_streams_identically(models, layout):
    """The reference test of that name on the port (and paged): poisoned
    mixed waves are re-run on the plain path, at the reference's
    iterations, and the streams equal the fault-free serve run."""
    degraded = _serve_faulted(models, dict(seed=5, nan_p=0.3), layout)
    assert any(s.prefill_slots for s in degraded)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_serve_kernel_fault_degrades_mixed_waves(models, layout):
    """The ``kernel`` (+inf) fault over the first 12 iterations, where
    the mixed waves run."""
    degraded = _serve_faulted(
        models, dict(seed=5, kernel_p=1.0, stop=12), layout)
    assert any(s.prefill_slots and s.decode_slots for s in degraded)


def _serve_faulted(models, faults, layout):
    """A serve() run of `test_serving_stream.py`'s workload with and without
    `faults`, on both engines: the events and counters must equal the
    reference's, and the faulted streams the clean ones.  Returns the
    port's degraded iterations."""
    kw = dict(kv_layout="paged", page_size=4) if layout == "paged" else {}
    reqs = _stream_requests(13, 5, NO_EOS + 1)
    runs = {}
    for name, faults in (("clean", None), ("noisy", faults)):
        ref, eng = _engines(models, eos=1, faults=faults, **kw)
        want = _events(ref.serve(_schedule(reqs, STREAM_GAPS, JaxRequest)))
        got = _events(eng.serve(_schedule(reqs, STREAM_GAPS, ServeRequest)))
        assert got == want
        assert _per_iteration(eng) == _per_iteration(ref)
        runs[name] = (_streams(got), eng)
    assert runs["noisy"][0] == runs["clean"][0]
    eng = runs["noisy"][1]
    degraded = [s for s in eng.stats if s.degraded]
    assert degraded and eng.degraded_steps == len(degraded)
    return degraded


VALID_REASONS = {"eos", "length", "rejected", "cancelled", "timeout",
                 "aborted"}


@pytest.mark.parametrize("seed", [6174, 2, 3, 11])
def test_serve_fifo_fairness_property(models, seed):
    """`test_serve_fifo_fairness_property` on the port, at fixed seeds: a
    tight pool, injected admission faults and cancels between events.
    Every request terminates, first admissions keep FIFO order, and the
    events equal the reference's — up to where the reference's loop trips
    on a slot a cancel freed (seed 6174; ROADMAP queue 3)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 9))
    reqs = _stream_requests(seed, n, NO_EOS + 1, max_prompt=24, max_new=8)
    gaps = [int(g) for g in rng.integers(0, 3, n)]
    cancel_at = {int(rng.integers(2, 30)): int(rng.integers(0, n))
                 for _ in range(int(rng.integers(0, 3)))}
    ref, eng = _engines(models, eos=1, kv_layout="paged", page_size=4,
                        num_pages=24, preempt_after=2,
                        faults=dict(seed=seed, admit_p=0.2))
    runs = []
    for e, cls in ((ref, JaxRequest), (eng, ServeRequest)):
        pending = dict(cancel_at)

        def on_event(ev, e=e, pending=pending):
            rid = pending.pop(e.iteration, None)
            if rid is not None:
                e.cancel(rid)
        events = []
        try:
            _events(e.serve(_schedule(reqs, gaps, cls)),
                    lambda ev, events=events, f=on_event: (
                        events.append((ev.req_id, ev.token, ev.index,
                                       ev.finished, ev.reason)), f(ev)))
            tripped = False
        except AttributeError:
            tripped = True
        runs.append((events, tripped))
    (want, ref_tripped), (got, tripped) = runs
    assert not tripped and ref_tripped == (seed == 6174)
    assert got[:len(want)] == want
    if not ref_tripped:
        assert got == want
    finals = {e[0]: e[4] for e in got if e[3]}
    assert set(finals) == {i for i, _, _ in reqs}
    assert set(finals.values()) <= VALID_REASONS
    _streams(got)
    admits = [eng.admit_iteration[i] for i, _, _ in reqs
              if i in eng.admit_iteration]
    assert admits == sorted(admits)
    _assert_drained(eng)


# ---------------------------------------------------------------- SSM family

@pytest.fixture(scope="module")
def mamba():
    return _bridge("mamba2-1.3b", jax_config("mamba2-1.3b").reduced(), 0)


@pytest.mark.parametrize("kind", ["nan", "kernel"])
def test_ssm_guard_restores_the_state(mamba, kind):
    """mamba2 advances every layer's SSM state in a decode step; the
    port's poisoned step wrote the spare buffer, so the re-run starts from
    the pre-step state and the stream equals the fault-free one (and the
    reference's on each prompt alone; the reference engine drops the
    step's functional state, and its schedule is the port's)."""
    (jcfg, jp), (cfg, tp) = mamba
    reqs = [([3, 5, 7], 10), ([4, 5], 10), ([9, 8, 7, 6], 10)]
    kw = dict(ENGINE, eos_token=cfg.vocab_size - 1)
    out = {}
    for name, faults in (("clean", None),
                         ("noisy", dict(seed=2, start=1, stop=7,
                                        **{f"{kind}_p": 0.6}))):
        jkw, tkw = dict(kw), dict(kw)
        if faults:
            jkw["faults"], tkw["faults"] = (JaxFaults(**faults),
                                            FaultInjector(**faults))
        ref = JaxEngine(jcfg, jp, **jkw)
        eng = PapiEngine(cfg, tp, device="cpu", **tkw)
        _submit(ref, reqs, JaxRequest)
        _submit(eng, reqs, ServeRequest)
        want = _results(ref.run(max_iterations=500))
        out[name] = _results(eng.run(max_iterations=500))
        assert {i: (len(t), r, p) for i, (t, r, p) in out[name].items()} == {
            i: (len(t), r, p) for i, (t, r, p) in want.items()}
        assert _per_iteration(eng) == _per_iteration(ref)
        out[name + "_eng"] = eng
    alone = greedy_streams(jcfg, jp, [(i, p, n) for i, (p, n) in
                                      enumerate(reqs)],
                           kw["eos_token"], kw["cache_capacity"])
    assert {i: (t, r) for i, (t, r, _) in out["clean"].items()} == alone
    assert out["noisy"] == out["clean"]
    eng = out["noisy_eng"]
    # the pre-step state the engine keeps is never written by the step
    pre = dict(eng.cache)
    kept = [x.clone() for x in pre["ssm"]]
    tm.decode_step(cfg, tp, eng.cache, torch.full((4, 1), 3,
                                                  dtype=torch.int32))
    assert eng.cache["ssm"] is not pre["ssm"]
    assert all(torch.equal(x, y) for x, y in zip(pre["ssm"], kept))
    assert eng.degraded_steps >= 2
    assert sum(s.degraded for s in eng.stats) == eng.degraded_steps
