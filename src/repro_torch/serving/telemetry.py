"""Engine telemetry of the port: typed event traces, per-program timing
and the exporters — the port's own copy of `repro.serving.telemetry`,
with the same event vocabulary, record shapes and exporters, so
`tools/trace_report.py` reads the port's traces unchanged.

  * `Tracer` — a bounded ring of typed `Event`s: iteration spans,
    scheduler decisions (the AI estimate and the α it was compared with,
    not just the verdict), preemptions, deferrals, injected faults,
    degraded re-runs, page-pool samples and per-request lifecycle marks
    (submit / admit / first_token / finish).  The ring keeps the NEWEST
    events and counts what it dropped; the counters and the per-program
    timing table live outside it, so exports stay exact under truncation.
  * per-program timing — the engine's `_call(key, fn, *args)` seam wraps
    every model program it dispatches (the plain and speculative decode
    steps, the prefill and chunk waves, the mixed wave, the degraded
    re-runs), keyed as the reference keys its jit caches:
    ``(kind, tlp, fc_variant, interpret, attn_pim)`` for decode programs,
    ``(kind, fc_variant, interpret, attn_pim)`` for prefill and waves;
    the port has no ``pim_interpret`` and passes None (``-``).  The
    reference times a dispatch around `jax.block_until_ready`, one host
    sync per program.  The port times two ways:

      - on the CPU (`Tracer.timed_call`), wall clock around the call:
        every CPU op is synchronous, so that is the program's time;
      - on the card (`Tracer.timed_call_cuda`), a pair of
        ``torch.cuda.Event(enable_timing=True)`` recorded on the current
        stream around the call, resolved (`Tracer.resolve`) only after
        the iteration's one host fetch has synchronised the stream, so a
        traced steady iteration keeps its ONE host sync.  An event pair
        measures stream time from start to stop: the kernels and the gaps
        in which the device waited for the host's next launch, not pure
        kernel time (a host-bound step reads close to its host time).

    The ``program`` event is emitted at the call, as in the reference;
    on the card its ``dur`` is filled in when the pair resolves.  The
    degraded re-run is timed under the reference's ``oracle`` /
    ``oracle_wave`` keys; on the card it runs the engine's own kernels,
    not the reference's plain oracle path.
  * `NullTracer` — the engine default.  Every hook is a no-op and the
    engine's `_call` is a bare call, so the untraced hot path is
    unchanged.

Exporters (one event vocabulary, three views — see docs/ARCHITECTURE.md,
"Observability & telemetry"):

  * `export_chrome` — Chrome-trace-event JSON (`{"traceEvents": [...]}`),
    opens in Perfetto / chrome://tracing.  One lane per engine slot
    (request residency spans + first-token marks), one for the scheduler
    (iteration spans named by the chosen FC variant, flip instants), one
    for the page pool (a counter track), one for compiled-program
    dispatches, one for the queue (submit/defer/fault instants).  The
    full typed-event payload rides in each event's ``args`` and the
    aggregate tables under a top-level ``"papi"`` key, so
    `tools/trace_report.py` reads the same facts from either format.
  * `export_prometheus` — text-exposition snapshot of ``papi_engine_*``
    counters/gauges derived from the same events (iterations, tokens,
    finishes by reason, preemptions, deferrals, degraded steps, faults by
    kind, scheduler flips, pool occupancy, per-program run counts and
    total seconds).
  * `export_jsonl` — the raw typed events, one JSON object per line, with
    a trailing ``summary`` record carrying the aggregate tables.

Both the offline `PapiEngine.run()` and the streaming `serve()` loop emit
the same vocabulary, so one trace format covers every engine mode
(dense/paged x greedy/spec x faults).  This module imports no torch: the
card's timing path imports it inside the call.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from collections import Counter, deque
from typing import Any, Iterable

# The event vocabulary, equal to the reference's and to
# `tools/trace_report.py`'s copy, which validates traces against it.
EVENT_KINDS = frozenset({
    "submit",        # request entered the queue        {req_id, prompt_len, max_new}
    "admit",         # request first admitted to a slot {req_id, slot, prompt_len}
    "first_token",   # request's first output token     {req_id}
    "finish",        # result emitted                   {req_id, reason, tokens, slot}
    "preempt",       # in-flight request preempted      {req_id, slot, done}
    "defer",         # queue head deferred by the pool  {req_id, age}
    "scheduler",     # per-iteration decision           {ai_estimate, alpha,
                     #   assignment, flipped, rlp, tlp}
    "iteration",     # span: one engine step            {IterStats fields}
    "pool",          # page-pool occupancy sample       {used, free, watermark,
                     #   fragmentation}
    "fault",         # an injected fault fired          {fault, ...}
    "degraded",      # finite-logits guard re-ran the   {mode: step|wave}
                     #   step on the oracle path
    "program",       # span: one compiled-program       {key, ...}
                     #   dispatch (traced only)
    "page_map",      # allocator mapped pages           {slot, pages}
    "page_unmap",    # allocator returned pages         {slot, pages, cause}
    "page_reserve",  # admission reserved a budget      {slot, budget_pages,
                     #   mapped_pages}
    "stall",         # EngineStallError snapshot        {snapshot}
    "journal",       # WAL lifecycle                    {op, path, ...}
                     #   op="open" (torn tail truncated) / "snapshot"
    "recover",       # restore() re-admitted work       {path, resumed,
                     #   finished, records, torn_bytes, next_req_id}
})


@dataclasses.dataclass
class Event:
    """One typed trace event.  ``ts`` is seconds on the tracer's clock
    (zero at `Tracer` construction); ``dur`` is nonzero for spans."""
    kind: str
    iteration: int
    ts: float
    dur: float = 0.0
    data: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ProgramTiming:
    """Running timing stats for one program key."""
    count: int = 0
    total_s: float = 0.0
    min_s: float = math.inf
    max_s: float = 0.0

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def record(self, dur: float) -> None:
        self.count += 1
        self.total_s += dur
        self.min_s = min(self.min_s, dur)
        self.max_s = max(self.max_s, dur)

    def as_dict(self) -> dict:
        return {"count": self.count, "total_s": self.total_s,
                "mean_s": self.mean_s,
                "min_s": self.min_s if self.count else 0.0,
                "max_s": self.max_s}


def format_program_key(key: tuple) -> str:
    """Stable string form of a program key for export/labels, e.g.
    ``('spec_fused', 4, 'pim', None, False)`` -> ``spec_fused|4|pim|-|-``
    (None and False compress to '-': most keys are mostly defaults)."""
    return "|".join("-" if part in (None, False) else str(part)
                    for part in key)


class Tracer:
    """Bounded typed-event trace + per-program timing table.

    ``capacity`` bounds the event ring (the NEWEST events are kept;
    ``dropped`` counts the truncated prefix).  Aggregate ``counters``,
    ``gauges``, and the ``programs`` timing table are maintained at emit
    time, outside the ring, so the Prometheus snapshot and the report
    tool's tables stay exact regardless of truncation.

    ``page_events=True`` opts into the allocator's per-call
    map/unmap/reserve events even without ``debug_invariants`` (they are
    the highest-volume kind; the engine attaches the tracer to the page
    manager only when one of the two flags asks for them).
    """

    enabled = True

    def __init__(self, capacity: int = 65536, *, page_events: bool = False):
        assert capacity >= 1, capacity
        self.capacity = int(capacity)
        self.page_events = bool(page_events)
        self._events: deque[Event] = deque(maxlen=self.capacity)
        self.emitted = 0
        self.iteration = 0           # engine refreshes this every step
        self.counters: Counter = Counter()
        self.gauges: dict[str, float] = {}
        self.programs: dict[tuple, ProgramTiming] = {}
        # card timings awaiting their stream: (key, event, start, stop)
        self._pending: list = []
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------ emission
    @property
    def events(self) -> Iterable[Event]:
        return self._events

    @property
    def dropped(self) -> int:
        return self.emitted - len(self._events)

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def emit(self, kind: str, iteration: int | None = None, *,
             ts: float | None = None, dur: float = 0.0, **data) -> Event:
        """Append one typed event (newest-wins ring) and fold it into the
        aggregate counters/gauges."""
        ev = Event(kind,
                   self.iteration if iteration is None else int(iteration),
                   self._now() if ts is None else ts, dur, data)
        self._events.append(ev)
        self.emitted += 1
        self.counters[kind] += 1
        if kind == "finish":
            self.counters[f"finish:{data.get('reason', 'unknown')}"] += 1
        elif kind == "fault":
            self.counters[f"fault:{data.get('fault', 'unknown')}"] += 1
        elif kind == "scheduler" and data.get("flipped"):
            self.counters["scheduler_flip"] += 1
        elif kind == "iteration":
            self.counters["tokens"] += int(data.get("new_tokens", 0))
        elif kind == "pool":
            for field in ("used", "free", "watermark", "fragmentation"):
                if field in data:
                    self.gauges[f"kv_pages_{field}"] = data[field]
        return ev

    def span(self, kind: str, start: float, iteration: int | None = None,
             **data) -> Event:
        """Emit a span that began at absolute `time.perf_counter()` value
        ``start`` and ends now."""
        end = time.perf_counter()
        return self.emit(kind, iteration, ts=start - self._t0,
                         dur=end - start, **data)

    # ------------------------------------------------------ program timing
    def timed_call(self, key: tuple, fn, *args):
        """Call ``fn(*args)`` and record its wall time against ``key``: the
        CPU path, where every op is synchronous."""
        start = time.perf_counter()
        out = fn(*args)
        self.record_program(key, time.perf_counter() - start, start=start)
        return out

    def timed_call_cuda(self, key: tuple, fn, *args):
        """Call ``fn(*args)`` between two CUDA events on the current stream
        and emit its ``program`` event now; its duration (stream time from
        start to stop) and its row of the table come when `resolve` finds
        the stop event complete.  No host sync here."""
        import torch
        start_t = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        stop.record()
        ev = self.emit("program", ts=start_t - self._t0,
                       key=format_program_key(key))
        self._pending.append((key, ev, start, stop))
        return out

    def resolve(self, block: bool = False) -> None:
        """Fold the card timings whose stop event has completed into the
        table, in call order.  The engine calls it right after a host
        fetch, when the stream has drained; ``block=True`` (the exporters,
        `program_table`) waits for the rest."""
        done = 0
        for key, ev, start, stop in self._pending:
            if block:
                stop.synchronize()
            elif not stop.query():
                break
            ev.dur = start.elapsed_time(stop) / 1e3
            self.programs.setdefault(key, ProgramTiming()).record(ev.dur)
            done += 1
        del self._pending[:done]

    def record_program(self, key: tuple, dur: float,
                       start: float | None = None) -> None:
        self.programs.setdefault(key, ProgramTiming()).record(dur)
        ts = None if start is None else start - self._t0
        self.emit("program", ts=ts, dur=dur, key=format_program_key(key))

    def program_table(self) -> dict[str, dict]:
        """The per-key timing table, string-keyed for export: the exact
        shape a measured-characterization scheduler consumes.  Waits for
        card timings still pending."""
        self.resolve(block=True)
        return {format_program_key(k): t.as_dict()
                for k, t in sorted(self.programs.items(), key=lambda kv:
                                   format_program_key(kv[0]))}


class NullTracer:
    """The engine default: every hook is a no-op, the timed calls are bare
    calls.  Shares the read surface (events/counters/programs/...) so
    exporters degrade gracefully on an untraced engine."""

    enabled = False
    page_events = False
    iteration = 0
    emitted = 0
    dropped = 0
    events: tuple = ()
    counters: dict = {}
    gauges: dict = {}
    programs: dict = {}

    def emit(self, kind, iteration=None, *, ts=None, dur=0.0, **data):
        return None

    def span(self, kind, start, iteration=None, **data):
        return None

    def timed_call(self, key, fn, *args):
        return fn(*args)

    timed_call_cuda = timed_call

    def resolve(self, block=False):
        return None

    def record_program(self, key, dur, start=None):
        return None

    def program_table(self):
        return {}


NULL_TRACER = NullTracer()


# --------------------------------------------------------------- exporters
def _settle(tracer) -> None:
    """Resolve card timings still pending, so exported events carry their
    durations."""
    resolve = getattr(tracer, "resolve", None)
    if callable(resolve):
        resolve(block=True)


def _jsonable(obj):
    """json.dumps default= hook: numpy scalars -> python, else str."""
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return item()
        except (TypeError, ValueError):
            pass
    return str(obj)


# Chrome lane (tid) layout inside pid 1 ("papi-engine").  Slot lanes start
# at SLOT_TID0 so any max_slots fits after the fixed lanes.
SCHED_TID, POOL_TID, PROG_TID, QUEUE_TID, SLOT_TID0 = 1, 2, 3, 4, 10
_PID = 1


def export_chrome(tracer) -> dict:
    """Chrome-trace-event JSON (the ``traceEvents`` array format).

    Opens directly in Perfetto (ui.perfetto.dev) or chrome://tracing:
    iteration spans on the scheduler lane are named by the FC variant the
    scheduler chose (the pu<->pim flip pattern is visible at a glance,
    flips marked as instants), each slot lane shows request residency
    spans with first-token marks, the pool lane is a page-occupancy
    counter track, and the program lane shows every traced compiled-
    program dispatch.  The typed payload of every event rides in ``args``
    (with its ``kind``), and the aggregate counter/gauge/program tables
    under the top-level ``"papi"`` key — `tools/trace_report.py` consumes
    those rather than re-deriving from the lanes.
    """
    _settle(tracer)
    out: list[dict] = []

    def meta(tid: int, name: str) -> None:
        out.append({"ph": "M", "pid": _PID, "tid": tid, "ts": 0,
                    "name": "thread_name", "args": {"name": name}})

    out.append({"ph": "M", "pid": _PID, "tid": 0, "ts": 0,
                "name": "process_name", "args": {"name": "papi-engine"}})
    meta(SCHED_TID, "scheduler")
    meta(POOL_TID, "kv-page-pool")
    meta(PROG_TID, "programs")
    meta(QUEUE_TID, "queue")

    def us(ts: float) -> float:
        return ts * 1e6

    open_slots: dict[int, dict] = {}   # slot -> open residency span
    slot_lanes: set[int] = set()
    last_ts = 0.0

    def base(ev: Event, tid: int, ph: str, name: str) -> dict:
        return {"ph": ph, "pid": _PID, "tid": tid, "ts": us(ev.ts),
                "name": name,
                "args": {"kind": ev.kind, "iteration": ev.iteration,
                         **ev.data}}

    def close_slot(slot: int, ts: float, name_suffix: str = "") -> None:
        span = open_slots.pop(slot, None)
        if span is None:
            return
        span["dur"] = max(us(ts) - span["ts"], 0.0)
        span["name"] += name_suffix
        out.append(span)

    for ev in tracer.events:
        last_ts = max(last_ts, ev.ts + ev.dur)
        if ev.kind == "iteration":
            rec = base(ev, SCHED_TID, "X",
                       f"fc={ev.data.get('fc_variant', '?')}")
            rec["dur"] = us(ev.dur)
            out.append(rec)
        elif ev.kind == "scheduler":
            if ev.data.get("flipped"):
                rec = base(ev, SCHED_TID, "i",
                           f"flip->{ev.data.get('assignment')}")
                rec["s"] = "t"
                out.append(rec)
        elif ev.kind == "pool":
            rec = base(ev, POOL_TID, "C", "kv_pages")
            rec["args"] = {"used": ev.data.get("used", 0),
                           "free": ev.data.get("free", 0)}
            out.append(rec)
        elif ev.kind == "program":
            rec = base(ev, PROG_TID, "X", ev.data.get("key", "program"))
            rec["dur"] = us(ev.dur)
            out.append(rec)
        elif ev.kind == "admit":
            slot = ev.data.get("slot")
            if slot is not None:
                tid = SLOT_TID0 + int(slot)
                slot_lanes.add(int(slot))
                close_slot(int(slot), ev.ts)   # defensive: no dangling span
                open_slots[int(slot)] = base(
                    ev, tid, "X", f"req {ev.data.get('req_id')}")
        elif ev.kind in ("finish", "preempt"):
            slot = ev.data.get("slot")
            suffix = " (preempted)" if ev.kind == "preempt" else ""
            if slot is not None:
                close_slot(int(slot), ev.ts, suffix)
            rec = base(ev, QUEUE_TID, "i", f"{ev.kind} "
                       f"req {ev.data.get('req_id')}")
            rec["s"] = "t"
            out.append(rec)
        elif ev.kind == "first_token":
            rec = base(ev, QUEUE_TID, "i",
                       f"first_token req {ev.data.get('req_id')}")
            rec["s"] = "t"
            out.append(rec)
        elif ev.kind in ("submit", "defer", "fault", "degraded", "stall",
                         "page_map", "page_unmap", "page_reserve",
                         "journal", "recover"):
            rec = base(ev, QUEUE_TID, "i", ev.kind)
            rec["s"] = "t"
            out.append(rec)

    for slot in list(open_slots):
        close_slot(slot, last_ts, " (open)")
    for slot in sorted(slot_lanes):
        meta(SLOT_TID0 + slot, f"slot {slot}")

    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "papi": {
            "counters": dict(tracer.counters),
            "gauges": dict(tracer.gauges),
            "programs": tracer.program_table(),
            "events_emitted": tracer.emitted,
            "events_dropped": tracer.dropped,
        },
    }


def export_jsonl(tracer) -> str:
    """Raw typed events, one JSON object per line, newest-ring contents in
    order, with a trailing ``summary`` record carrying the aggregate
    tables (exact under ring truncation)."""
    _settle(tracer)
    lines = []
    for ev in tracer.events:
        lines.append(json.dumps(
            {"kind": ev.kind, "iteration": ev.iteration, "ts": ev.ts,
             "dur": ev.dur, "data": ev.data},
            default=_jsonable, sort_keys=True))
    lines.append(json.dumps(
        {"kind": "summary", "iteration": tracer.iteration,
         "ts": 0.0, "dur": 0.0,
         "data": {"counters": dict(tracer.counters),
                  "gauges": dict(tracer.gauges),
                  "programs": tracer.program_table(),
                  "events_emitted": tracer.emitted,
                  "events_dropped": tracer.dropped}},
        default=_jsonable, sort_keys=True))
    return "\n".join(lines) + "\n"


def _prom_escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"')


def export_prometheus(tracer) -> str:
    """Prometheus text-exposition snapshot of ``papi_engine_*`` series,
    derived from the tracer's aggregate counters/gauges (NOT the ring, so
    truncation never undercounts).  Counter series end in ``_total``;
    pool occupancy and per-program means are gauges."""
    _settle(tracer)
    c, g = tracer.counters, tracer.gauges
    lines: list[str] = []

    def metric(name: str, mtype: str, help_text: str,
               samples: list[tuple[str, float]]) -> None:
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            lines.append(f"{name}{labels} {value}")

    metric("papi_engine_iterations_total", "counter",
           "Engine iterations executed.", [("", c.get("iteration", 0))])
    # one labelled sample per EVENT_KINDS member, zero-filled, so the
    # exposition always covers the full event vocabulary
    metric("papi_engine_events_total", "counter",
           "Telemetry events recorded, by event kind.",
           [(f'{{kind="{_prom_escape(k)}"}}', c.get(k, 0))
            for k in sorted(EVENT_KINDS)])
    metric("papi_engine_tokens_total", "counter",
           "Output tokens committed.", [("", c.get("tokens", 0))])
    reasons = sorted(k.split(":", 1)[1] for k in c if k.startswith("finish:"))
    metric("papi_engine_requests_finished_total", "counter",
           "Requests finished, by finished_reason.",
           [(f'{{reason="{_prom_escape(r)}"}}', c[f"finish:{r}"])
            for r in reasons] or [("", 0)])
    metric("papi_engine_preemptions_total", "counter",
           "In-flight requests preempted under pool pressure.",
           [("", c.get("preempt", 0))])
    metric("papi_engine_deferrals_total", "counter",
           "Iterations the queue head was deferred by the pool.",
           [("", c.get("defer", 0))])
    metric("papi_engine_degraded_steps_total", "counter",
           "Iterations re-run on the oracle path by the finite-logits "
           "guard.", [("", c.get("degraded", 0))])
    kinds = sorted(k.split(":", 1)[1] for k in c if k.startswith("fault:"))
    metric("papi_engine_faults_injected_total", "counter",
           "Injected faults fired, by kind.",
           [(f'{{kind="{_prom_escape(k)}"}}', c[f"fault:{k}"])
            for k in kinds] or [("", 0)])
    metric("papi_engine_scheduler_flips_total", "counter",
           "Scheduler FC-path reschedules (pu<->pim).",
           [("", c.get("scheduler_flip", 0))])
    metric("papi_engine_kv_pages_used", "gauge",
           "KV pool pages holding live KV (latest sample).",
           [("", g.get("kv_pages_used", 0))])
    metric("papi_engine_kv_pages_free", "gauge",
           "KV pool pages on the free list (latest sample).",
           [("", g.get("kv_pages_free", 0))])
    metric("papi_engine_kv_page_watermark", "gauge",
           "Peak KV pool pages mapped over the engine lifetime.",
           [("", g.get("kv_pages_watermark", 0))])
    metric("papi_engine_kv_fragmentation", "gauge",
           "Tail-of-page waste share of mapped rows (latest sample).",
           [("", g.get("kv_pages_fragmentation", 0.0))])
    table = tracer.program_table()
    metric("papi_engine_program_runs_total", "counter",
           "Program calls, by program key.",
           [(f'{{key="{_prom_escape(k)}"}}', t["count"])
            for k, t in table.items()] or [("", 0)])
    metric("papi_engine_program_seconds_total", "counter",
           "Seconds inside programs (wall clock on the CPU, CUDA-event "
           "stream time on the card), by program key.",
           [(f'{{key="{_prom_escape(k)}"}}', t["total_s"])
            for k, t in table.items()] or [("", 0.0)])
    metric("papi_engine_program_mean_seconds", "gauge",
           "Mean seconds per call, by program key.",
           [(f'{{key="{_prom_escape(k)}"}}', t["mean_s"])
            for k, t in table.items()] or [("", 0.0)])
    metric("papi_engine_trace_events_total", "counter",
           "Typed trace events emitted.", [("", tracer.emitted)])
    metric("papi_engine_trace_events_dropped_total", "counter",
           "Events truncated out of the ring buffer.",
           [("", tracer.dropped)])
    return "\n".join(lines) + "\n"


def write_trace(tracer, path, fmt: str = "chrome") -> None:
    """Serialize the trace to ``path``: ``chrome`` (Perfetto-openable JSON)
    or ``jsonl`` (raw typed events)."""
    from pathlib import Path
    p = Path(path)
    if fmt == "chrome":
        p.write_text(json.dumps(export_chrome(tracer), default=_jsonable)
                     + "\n")
    elif fmt == "jsonl":
        p.write_text(export_jsonl(tracer))
    else:
        raise ValueError(f"unknown trace format {fmt!r} "
                         "(choose 'chrome' or 'jsonl')")
