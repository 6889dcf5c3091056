"""The port's durability against the reference's, on the CPU.

Every case of `tests/test_journal.py` runs on the port (reduced qwen2,
f32, the reference's weights carried over by `params_from_jax`, a seed-9
draft; the reference tests' engine ``max_slots=4, cache_capacity=64,
prefill_len=8``, α 6, no eos, ``debug_invariants=True``):

  * `repro_torch.serving.journal` frames, reads, tears and truncates as
    the reference's; flush policies; `replay` folds records and
    synthesises a finish whose record was torn away;
  * the ``crash`` fault -> `recover` the durable finishes -> a fresh
    engine `restore()`s -> the union of durable and post-crash streams is
    the uncrashed run's, each request once, dense (spec 1) and paged
    (spec 2), and replay of the extended journal is the whole history;
    a hypothesis property over crash iteration x torn bytes x layout;
  * `snapshot` / `restore`, deadlines across a restart (``_now`` patched),
    and `serve()`'s early close against a crash.

Two parity cases hold the packages together: the journal bytes the port
writes for a deadline-free trace equal the reference engine's, and a
journal one package wrote after a crash is restored by the other to the
reference's streams.  The uncrashed port streams equal the reference
engine's.
"""
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from _propcompat import given, settings, st  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.serving import EngineCrashError as JaxCrashError  # noqa: E402
from repro.serving import FaultInjector as JaxFaults  # noqa: E402
from repro.serving import PapiEngine as JaxEngine  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving import (EngineCrashError, FaultInjector,  # noqa: E402
                                 Journal, PapiEngine, ServeRequest,
                                 parse_fault_specs, read_records, recover,
                                 replay)
from repro_torch.serving.journal import FLUSH_POLICIES, scan  # noqa: E402

NO_EOS = get_config("qwen2-0.5b-smoke").vocab_size - 1

# four requests of staggered length: some finish before any crash point,
# some after, so every recovery splits durable-vs-resumed nontrivially
REQS = [([3 + i, 5, 7], 6 + 2 * i) for i in range(4)]

# module-level model cache: the property test cannot take fixtures
_CACHE: dict = {}


def _models():
    if "models" not in _CACHE:
        jcfg = jax_config("qwen2-0.5b").reduced()
        cfg = get_config("qwen2-0.5b-smoke")
        got = {}
        for name, key in (("target", 0), ("draft", 9)):
            jp = jax.jit(jm.init_params, static_argnums=0)(
                jcfg, jax.random.PRNGKey(key))
            got[name] = ((jcfg, jp), (cfg, tm.params_from_jax(
                cfg, jax.tree.map(np.asarray, jp), "cpu")))
        _CACHE["models"] = got
    return _CACHE["models"]


def _opts(layout, spec, side, kw):
    d = dict(max_slots=4, cache_capacity=64, prefill_len=8, alpha=6.0,
             eos_token=NO_EOS, debug_invariants=True)
    if spec > 1:
        d.update(spec_len=spec, draft=_models()["draft"][side])
    if layout == "paged":
        d.update(kv_layout="paged", page_size=4)
    d.update(kw)
    return d


def _engine(layout="dense", spec=1, **kw):
    cfg, params = _models()["target"][1]
    return PapiEngine(cfg, params, device="cpu",
                      **_opts(layout, spec, 1, kw))


def _jax_engine(layout="dense", spec=1, **kw):
    jcfg, jp = _models()["target"][0]
    return JaxEngine(jcfg, jp, **_opts(layout, spec, 0, kw))


def _crash(k):
    return dict(seed=0, crash_p=1.0, start=k, stop=k + 1)


def _submit_all(eng, cls=ServeRequest):
    for i, (prompt, n) in enumerate(REQS):
        eng.submit(cls(i, list(prompt), max_new_tokens=n))


def _oracle(layout, spec):
    key = ("oracle", layout, spec)
    if key not in _CACHE:
        eng = _engine(layout, spec)
        _submit_all(eng)
        _CACHE[key] = {r.req_id: r.tokens
                       for r in eng.run(max_iterations=400)}
    return _CACHE[key]


def _jax_oracle(layout, spec):
    key = ("jax_oracle", layout, spec)
    if key not in _CACHE:
        eng = _jax_engine(layout, spec)
        _submit_all(eng, JaxRequest)
        _CACHE[key] = {r.req_id: r.tokens
                       for r in eng.run(max_iterations=400)}
    return _CACHE[key]


# ------------------------------------------------------------ journal file

def test_framing_roundtrip(tmp_path):
    path = tmp_path / "a.wal"
    with Journal(path) as j:
        j.append("submit", req_id=0, prompt=[1, 2, 3], max_new=8, dl=None)
        j.append("commit", req_id=0, toks=[5, 6], n=2, rem=6, dl=None, it=1)
        j.append("finish", req_id=0, reason="length", toks=[7], n=3, it=2)
    records, torn = read_records(path)
    assert torn == 0
    assert [r["k"] for r in records] == ["submit", "commit", "finish"]
    assert records[0]["prompt"] == [1, 2, 3]
    assert records[2]["toks"] == [7]
    with pytest.raises(AssertionError):
        Journal(tmp_path / "b.wal").append("not-a-kind", req_id=0)


def test_frame_casts_numpy_scalars_to_the_reference_bytes(tmp_path):
    """The engine holds budgets and tokens in numpy: a numpy field frames
    as the Python value it holds, so the bytes equal the reference's."""
    from repro.serving.journal import _frame as jax_frame
    from repro_torch.serving.journal import _frame
    plain = dict(k="commit", req_id=0, toks=[5, 6], n=2, rem=6, dl=None,
                 it=1)
    numpy = dict(k="commit", req_id=np.int64(0),
                 toks=[np.int32(5), np.int64(6)], n=np.int64(2),
                 rem=np.int64(6), dl=None, it=1)
    assert _frame(numpy) == _frame(plain) == jax_frame(plain)


def test_torn_tail_stops_reader_and_reopen_truncates(tmp_path):
    path = tmp_path / "torn.wal"
    with Journal(path) as j:
        for i in range(5):
            j.append("commit", req_id=0, toks=[i], n=i + 1, rem=5 - i,
                     dl=None, it=i)
    whole = path.read_bytes()
    cut = whole[:-9]                         # tear the last record
    path.write_bytes(cut)
    records, torn = read_records(path)
    assert len(records) == 4
    assert torn == len(cut) - (cut.rfind(b"\n") + 1) > 0
    # reopening physically truncates, so appends extend a valid prefix
    j2 = Journal(path)
    assert j2.records_kept == 4 and j2.truncated_bytes == torn
    j2.append("commit", req_id=0, toks=[9], n=5, rem=1, dl=None, it=9)
    j2.close()
    records, torn = read_records(path)
    assert torn == 0 and len(records) == 5 and records[-1]["toks"] == [9]


def test_checksum_corruption_stops_reader(tmp_path):
    path = tmp_path / "corrupt.wal"
    with Journal(path) as j:
        for i in range(4):
            j.append("preempt", req_id=i, done=i, it=i)
    data = bytearray(path.read_bytes())
    lines = bytes(data).split(b"\n")
    # flip one byte inside record 1's json body
    off = len(lines[0]) + 1 + lines[1].rfind(b"}")
    data[off - 2] ^= 0xFF
    records, valid_end, total = scan(bytes(data))
    assert len(records) == 1 and valid_end < total


def test_flush_policies(tmp_path):
    with pytest.raises(ValueError):
        Journal(tmp_path / "x.wal", flush="never")
    assert set(FLUSH_POLICIES) == {"fsync", "flush", "lazy"}
    lazy = Journal(tmp_path / "lazy.wal", flush="lazy")
    lazy.append("cancel", req_id=0, it=0)
    assert (tmp_path / "lazy.wal").stat().st_size == 0   # still buffered
    lazy.close()
    assert read_records(tmp_path / "lazy.wal")[0][0]["k"] == "cancel"
    sync = Journal(tmp_path / "sync.wal", flush="fsync")
    sync.append("cancel", req_id=1, it=0)
    assert read_records(tmp_path / "sync.wal")[0][0]["k"] == "cancel"
    sync.close()


# ------------------------------------------------------------------ replay

def test_replay_folds_and_orders():
    recs = [
        {"k": "submit", "req_id": 0, "prompt": [1, 2], "max_new": 9,
         "dl": None},
        {"k": "submit", "req_id": 1, "prompt": [3], "max_new": 4, "dl": 2.5},
        {"k": "admit", "req_id": 0, "slot": 0, "budget": 8, "it": 0},
        {"k": "commit", "req_id": 0, "toks": [7, 8], "n": 2, "rem": 6,
         "dl": None, "it": 1},
        {"k": "preempt", "req_id": 0, "done": 2, "it": 2},
    ]
    state = replay(recs)
    # preemption requeues at the back: recovery keeps that order
    assert state.req_ids == [1, 0]
    r0 = state.requests[1]
    assert r0.done == [7, 8] and r0.max_new == 6 and r0.prompt == [1, 2]
    assert state.requests[0].deadline_s == 2.5
    assert state.next_req_id == 2 and not state.finished


def test_replay_synthesizes_torn_finish():
    base = [{"k": "submit", "req_id": 0, "prompt": [1], "max_new": 3,
             "dl": None},
            {"k": "admit", "req_id": 0, "slot": 0, "budget": 3, "it": 0}]
    # budget exhausted by the last durable commit; finish record torn away
    state = replay(base + [{"k": "commit", "req_id": 0, "toks": [5, 6, 7],
                            "n": 3, "rem": 0, "dl": None, "it": 2}])
    assert not state.requests
    fin = state.finished[0]
    assert fin.synthesized and fin.reason == "length"
    assert fin.tokens == [5, 6, 7]
    # same for an eos tail with budget remaining
    state = replay(base + [{"k": "commit", "req_id": 0, "toks": [5, 99],
                            "n": 2, "rem": 1, "dl": None, "it": 1}],
                   eos_token=99)
    assert not state.requests
    assert state.finished[0].synthesized
    assert state.finished[0].reason == "eos"
    # without eos knowledge the request is (correctly) re-admitted
    state = replay(base + [{"k": "commit", "req_id": 0, "toks": [5, 99],
                            "n": 2, "rem": 1, "dl": None, "it": 1}])
    assert state.req_ids == [0]


# ------------------------------------------------------------- crash fault

def test_crash_fault_deterministic_and_windowed():
    a = FaultInjector(seed=7, crash_p=0.5)
    b = FaultInjector(seed=7, crash_p=0.5)
    seq = [a.crash_now(s) for s in range(64)]
    assert seq == [b.crash_now(s) for s in range(64)]
    assert seq == [JaxFaults(seed=7, crash_p=0.5).crash_now(s)
                   for s in range(64)]
    assert any(seq) and not all(seq)
    assert a.counts["crash"] == sum(seq)
    w = FaultInjector(seed=7, crash_p=1.0, start=5, stop=6)
    assert [w.crash_now(s) for s in range(8)] == [False] * 5 + [True,
                                                                False, False]
    assert not FaultInjector(seed=7).crash_now(3)


def test_parse_fault_specs_crash():
    inj = parse_fault_specs(["crash:0.25"])
    assert inj.crash_p == 0.25 and inj.nan_p == 0.0
    inj = parse_fault_specs(["crash", "nan:0.1"])
    assert inj.crash_p == 1.0 and inj.nan_p == 0.1
    with pytest.raises(ValueError):
        parse_fault_specs(["crash:1.5"])
    with pytest.raises(ValueError):
        parse_fault_specs(["crash:x"])


# ------------------------------------------------- crash -> restore -> run

def _crash_and_recover(layout, spec, k, wal, truncate=0):
    """Crash at iteration k, optionally tear `truncate` bytes off the
    journal, then restore a FRESH engine and complete.  Returns
    (durable finishes, post-crash results, surviving submit ids)."""
    eng = _engine(layout, spec, journal=wal,
                  faults=FaultInjector(**_crash(k)))
    _submit_all(eng)
    with pytest.raises(EngineCrashError) as exc:
        eng.run(max_iterations=400)
    assert exc.value.iteration == k
    eng.journal.close()
    if truncate:
        data = Path(wal).read_bytes()
        Path(wal).write_bytes(data[:max(0, len(data) - truncate)])
    records, _ = read_records(wal)
    known = {int(r["req_id"]) for r in records if r["k"] == "submit"}
    durable = {rid: f.tokens
               for rid, f in recover(wal, eos_token=NO_EOS).finished.items()}
    fresh = _engine(layout, spec, journal=wal)
    fresh.restore(wal)
    after = {r.req_id: r.tokens for r in fresh.run(max_iterations=400)}
    fresh.journal.close()
    return durable, after, known


@pytest.mark.parametrize("layout,spec", [("dense", 1), ("paged", 2)])
def test_crash_recovery_bit_identical(layout, spec, tmp_path):
    """Crash mid-trace -> recover -> the union of durable + post-crash
    streams is the oracle, exactly once — and replay of the SAME journal
    file (extended by the recovered engine) equals the full history."""
    oracle = _oracle(layout, spec)
    assert oracle == _jax_oracle(layout, spec)
    wal = str(tmp_path / "crash.wal")
    durable, after, known = _crash_and_recover(layout, spec, 3, wal)
    assert known == set(oracle)
    assert not set(durable) & set(after)          # exactly-once finishes
    assert {**durable, **after} == oracle
    final = recover(wal, eos_token=NO_EOS)
    assert not final.requests
    assert {rid: f.tokens for rid, f in final.finished.items()} == oracle


@settings(max_examples=5, deadline=None)
@given(st.integers(min_value=1, max_value=6),
       st.integers(min_value=0, max_value=160),
       st.sampled_from(["dense", "paged"]))
def test_crash_consistency_property(k, cut, layout):
    """Fuzz (crash iteration, torn-tail length, KV layout): every request
    whose submit record survived the tear completes exactly once with the
    oracle's stream — no duplicate finish, no lost committed token."""
    oracle = _oracle(layout, 1)
    with tempfile.TemporaryDirectory() as td:
        wal = str(Path(td) / "p.wal")
        durable, after, known = _crash_and_recover(layout, 1, k, wal,
                                                   truncate=cut)
    assert not set(durable) & set(after)
    union = {**durable, **after}
    assert set(union) == known
    for rid in known:
        assert union[rid] == oracle[rid], rid


# ---------------------------------------------------- parity with the JAX

@pytest.mark.parametrize("layout,spec", [("dense", 1), ("paged", 2)])
def test_journal_bytes_equal_the_reference(layout, spec, tmp_path):
    """The same deadline-free trace on the same weights: the port's
    journal is the reference engine's, byte for byte."""
    port, ref = tmp_path / "port.wal", tmp_path / "ref.wal"
    for path, make, cls in ((port, _engine, ServeRequest),
                            (ref, _jax_engine, JaxRequest)):
        eng = make(layout, spec, journal=str(path))
        _submit_all(eng, cls)
        eng.run(max_iterations=400)
        eng.journal.close()
    assert read_records(port)[0]
    assert port.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("layout,spec", [("dense", 1), ("paged", 2)])
def test_journal_restores_across_packages(writer, layout, spec, tmp_path):
    """One package crashes at iteration 3 with a journal; the other
    restores it and completes: the union of the durable finishes and the
    restored run's streams is the reference's uncrashed run, and the
    extended journal replays to it."""
    oracle = _jax_oracle(layout, spec)
    wal = str(tmp_path / "x.wal")
    if writer == "reference":
        crashed = _jax_engine(layout, spec, journal=wal,
                              faults=JaxFaults(**_crash(3)))
        _submit_all(crashed, JaxRequest)
        err, fresh = JaxCrashError, lambda: _engine(layout, spec,
                                                    journal=wal)
    else:
        crashed = _engine(layout, spec, journal=wal,
                          faults=FaultInjector(**_crash(3)))
        _submit_all(crashed)
        err, fresh = EngineCrashError, lambda: _jax_engine(layout, spec,
                                                           journal=wal)
    with pytest.raises(err):
        crashed.run(max_iterations=400)
    crashed.journal.close()
    durable = {rid: f.tokens
               for rid, f in recover(wal, eos_token=NO_EOS).finished.items()}
    eng = fresh()
    info = eng.restore(wal)
    assert info["resumed"] == len(REQS) - len(durable) > 0
    after = {r.req_id: r.tokens for r in eng.run(max_iterations=400)}
    eng.journal.close()
    assert not set(durable) & set(after)
    assert {**durable, **after} == oracle
    final = recover(wal, eos_token=NO_EOS)
    assert not final.requests
    assert {rid: f.tokens for rid, f in final.finished.items()} == oracle


# -------------------------------------------------------- snapshot/restore

def test_snapshot_restore_completes(tmp_path):
    oracle = _oracle("dense", 1)
    eng = _engine(faults=FaultInjector(**_crash(3)))
    _submit_all(eng)
    with pytest.raises(EngineCrashError):
        eng.run(max_iterations=400)
    snap = tmp_path / "engine.snap.json"
    state = eng.snapshot(str(snap))
    assert state["papi_snapshot"] == 1
    # the same crash on the reference engine snapshots to the same state
    ref = _jax_engine(faults=JaxFaults(**_crash(3)))
    _submit_all(ref, JaxRequest)
    with pytest.raises(JaxCrashError):
        ref.run(max_iterations=400)
    assert json.loads(snap.read_text()) == ref.snapshot()
    pre = {r.req_id: r.tokens for r in eng.results}
    fresh = _engine()
    info = fresh.restore(str(snap))
    assert info["resumed"] == len(state["requests"])
    after = {r.req_id: r.tokens for r in fresh.run(max_iterations=400)}
    assert not set(pre) & set(after)
    assert {**pre, **after} == oracle


def test_deadline_survives_restart_both_directions(tmp_path):
    """Deadlines persist as REMAINING monotonic deltas.  After recovery on
    a machine whose clock jumped far ahead, the nearly-expired request
    still times out on its remaining budget (keeping its committed
    tokens) while the fresh request completes in full."""
    oracle = _oracle("dense", 1)
    eng = _engine(faults=FaultInjector(**_crash(4)))
    clock = {"now": 100.0}
    eng._now = lambda: clock["now"]
    for i, (prompt, n) in enumerate(REQS):
        eng.submit(ServeRequest(i, list(prompt), max_new_tokens=n,
                                deadline_s=5.0 if i == 0 else 1000.0))
    with pytest.raises(EngineCrashError):
        eng.run(max_iterations=400)
    clock["now"] = 104.8          # request 0 has 0.2s of deadline left
    snap = tmp_path / "dl.snap.json"
    eng.snapshot(str(snap))
    by_id = {r["req_id"]: r for r in
             json.loads(snap.read_text())["requests"]}
    assert by_id[0]["deadline_s"] == pytest.approx(0.2)
    assert by_id[3]["deadline_s"] == pytest.approx(995.2)

    fresh = _engine()
    c2 = {"now": 1e6}             # wall clock far-jumped across the restart
    fresh._now = lambda: c2["now"]
    fresh.restore(str(snap))
    done0 = {r.req_id: list(r.done) for r in fresh.queue}[0]
    c2["now"] = 1e6 + 0.5         # past 0's remaining 0.2s, inside 3's
    got = {r.req_id: r for r in fresh.run(max_iterations=400)}
    assert got[0].finished_reason == "timeout"
    # committed tokens kept, stream still an oracle prefix, cut short
    assert len(done0) <= len(got[0].tokens) < len(oracle[0])
    assert got[0].tokens == oracle[0][:len(got[0].tokens)]
    for rid in (1, 2, 3):
        if rid in got:            # finished pre-crash otherwise
            assert got[rid].finished_reason == "length"
            assert got[rid].tokens == oracle[rid]


# ----------------------------------------------------- serve() early close

def test_serve_early_close_aborts_and_stays_usable():
    """Breaking out of the serve() generator mid-stream aborts in-flight
    requests honestly, drains the page pool, and the engine remains
    usable for a subsequent submit() + run()."""
    eng = _engine("paged")
    sched = [[ServeRequest(i, list(p), max_new_tokens=n)
              for i, (p, n) in enumerate(REQS)]]
    for ev in eng.serve(sched):
        break                     # close the generator after one event
    assert not eng.active_slots
    aborted = [r for r in eng.results if r.finished_reason == "aborted"]
    assert aborted                # in-flight requests were finished
    eng.kv.alloc.check()
    assert eng.kv.alloc.mapped_count == 0
    assert eng.kv.alloc.free_count == eng.kv.alloc.num_pages
    eng.submit(ServeRequest(99, [11, 13], max_new_tokens=4))
    later = {r.req_id: r for r in eng.run(max_iterations=400)}
    assert later[99].finished_reason == "length"
    assert len(later[99].tokens) == 4


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_serve_crash_is_recoverable_not_aborted(layout, tmp_path):
    """`EngineCrashError` escaping the serve() generator is a process
    death, not an early close: no abort clean-up runs and nothing is
    journaled "aborted", so the in-flight requests recover."""
    oracle = _oracle(layout, 1)
    wal = str(tmp_path / "serve-crash.wal")
    eng = _engine(layout, journal=wal, faults=FaultInjector(**_crash(3)))
    sched = [[ServeRequest(i, list(p), max_new_tokens=n)
              for i, (p, n) in enumerate(REQS)]]
    streamed: dict[int, list[int]] = {}
    with pytest.raises(EngineCrashError) as exc:
        for ev in eng.serve(sched):
            if not ev.finished:
                streamed.setdefault(ev.req_id, []).append(ev.token)
    assert exc.value.iteration == 3
    assert eng.active_slots
    records, _ = read_records(wal)
    assert not any(r["k"] == "finish" and r["reason"] == "aborted"
                   for r in records)
    # every streamed token was journaled before serve() yielded it
    committed = replay(records, eos_token=NO_EOS)
    journaled = {r.req_id: r.done for r in committed.requests}
    journaled.update({rid: f.tokens
                      for rid, f in committed.finished.items()})
    for rid, toks in streamed.items():
        assert journaled[rid][:len(toks)] == toks, rid
    durable = {rid: f.tokens
               for rid, f in recover(wal, eos_token=NO_EOS).finished.items()}
    fresh = _engine(layout, journal=wal)
    fresh.restore(wal)
    after = {r.req_id: r.tokens for r in fresh.run(max_iterations=400)}
    assert not set(durable) & set(after)
    assert {**durable, **after} == oracle
    for rid, toks in streamed.items():
        assert toks == oracle[rid][:len(toks)], rid
