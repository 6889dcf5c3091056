"""Write-ahead request journal and snapshot format for the port's
`PapiEngine`: the port's own copy of `repro.serving.journal`, byte for
byte the same grammar, so a journal or snapshot written by either package
is read and restored by the other.

Durability rides the engine's resume path: a request resumed as
``prompt + tokens so far`` re-chunks through prefill to the stream an
uninterrupted run gives, so crash recovery needs no device state.  It
re-admits every unfinished request through the `_ResumedRequest` path and
greedy / speculative decoding recomputes the lost tail.  What must survive
a crash is host-side logical state only: the queue, each request's
committed tokens, its remaining token budget and its remaining deadline
(a monotonic-clock delta: wall timestamps would not survive a restart).

On the card the recomputed tail equals the lost one in f32; in bf16 a
re-prefill of ``prompt + done`` is a different computation from the
decode steps that produced ``done``, so a recovered stream begins with
its committed tokens and may then drift from an uncrashed run's.

Every field is framed as a Python ``int`` / ``float`` / ``list``: the
engine holds budgets and tokens in numpy, and ``json.dumps`` rejects
``np.int64`` (`_frame` converts numpy scalars, so the bytes equal the
reference's).

Record grammar (append-only, one record per line)::

    J1 <len> <crc32:08x> <json>\\n

``<json>`` is a compact JSON object whose ``"k"`` key names the record
kind; ``<len>`` is the UTF-8 byte length of ``<json>`` and the checksum is
``zlib.crc32`` over those same bytes.  Kinds and their payloads:

  ``submit``   {req_id, prompt, max_new, dl}           caller submission
  ``resume``   {req_id, prompt, done, max_new, dl, plen}  restore() re-admission
               (prompt = ORIGINAL prompt; max_new / dl = REMAINING budgets)
  ``admit``    {req_id, slot, budget, it}   budget = admission-clamped
               remaining new-token budget (re-admission must clamp the
               same way preemption does, so the clamped value is logged)
  ``commit``   {req_id, toks, n, rem, dl, it}   tokens committed this
               step (delta), total after, remaining budgets
  ``preempt``  {req_id, done, it}            requeued at the back
  ``cancel``   {req_id, it}                  cooperative cancel accepted
  ``finish``   {req_id, reason, toks, n, it} result emitted; ``toks`` is
               the tail since the last commit, so the journal alone
               reconstructs every finished stream

Torn-tail rule: the reader walks the valid prefix and stops at the first
record that is truncated, checksum-corrupt, or unparseable — that record
and everything after it are discarded.  This is safe by construction:
commit records past the last consistent point are superseded by re-decode
(deterministic greedy/speculative acceptance recomputes the identical
tokens), and a lost ``finish`` record merely re-completes the request —
its recomputed stream still matches the oracle.  Exactly-once *delivery*
of finishes to a durable consumer holds when the consumer treats the
journal as the source of truth (a finish is "delivered" once its record
is durable); the ``fsync`` flush policy makes every record durable before
`PapiEngine` externalizes it.

`Journal` opened on an existing path validates the prefix and physically
truncates any torn tail, so a recovered engine can keep appending to the
SAME file — replay of the extended journal equals the uninterrupted
history, because re-decoded tokens land exactly where the discarded
records would have.

Flush policy (``Journal(path, flush=...)``):

  ``"fsync"``  flush + os.fsync after every record (exactly-once durable)
  ``"flush"``  flush after every record (default: survives process death,
               not power loss)
  ``"lazy"``   buffered; flushed on close() (fastest, at-least-once)
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from pathlib import Path
from typing import Any, Iterable

_MAGIC = b"J1"
FLUSH_POLICIES = ("fsync", "flush", "lazy")

# record kinds the writer accepts / the reader folds
RECORD_KINDS = ("submit", "resume", "admit", "commit", "preempt", "cancel",
                "finish")


def _plain(obj):
    """json.dumps default= hook: a numpy scalar becomes its Python value."""
    item = getattr(obj, "item", None)
    if callable(item):
        return item()
    raise TypeError(f"{type(obj).__name__} is not JSON serializable")


def _frame(payload: dict) -> bytes:
    body = json.dumps(payload, separators=(",", ":"),
                      default=_plain).encode("utf-8")
    return b"%s %d %08x %s\n" % (_MAGIC, len(body), zlib.crc32(body), body)


class Journal:
    """Append-only write-ahead journal (see the module docstring for the
    record grammar).  Opening an existing file validates it and truncates
    any torn tail, so appends always extend a consistent prefix."""

    def __init__(self, path: str | Path, *, flush: str = "flush") -> None:
        if flush not in FLUSH_POLICIES:
            raise ValueError(
                f"unknown flush policy {flush!r} (choose from "
                f"{FLUSH_POLICIES})")
        self.path = Path(path)
        self.flush = flush
        self.truncated_bytes = 0
        self.records_kept = 0
        if self.path.exists():
            records, valid_end, total = scan(self.path.read_bytes())
            self.records_kept = len(records)
            if valid_end < total:
                self.truncated_bytes = total - valid_end
                with open(self.path, "r+b") as fh:
                    fh.truncate(valid_end)
        self._fh = open(self.path, "ab")

    def append(self, kind: str, **fields: Any) -> None:
        assert kind in RECORD_KINDS, kind
        self._fh.write(_frame({"k": kind, **fields}))
        if self.flush != "lazy":
            self._fh.flush()
            if self.flush == "fsync":
                os.fsync(self._fh.fileno())

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def scan(data: bytes) -> tuple[list[dict], int, int]:
    """Walk the valid prefix of raw journal bytes.  Returns
    ``(records, valid_end, total)``: the decoded records, the byte offset
    where the valid prefix ends, and the total byte length.  The first
    truncated / corrupt / unparseable record stops the walk — it and
    everything after it are the torn tail."""
    records: list[dict] = []
    off = 0
    total = len(data)
    while off < total:
        nl = data.find(b"\n", off)
        if nl < 0:
            break                       # no newline: torn final record
        line = data[off:nl]
        parts = line.split(b" ", 3)
        if len(parts) != 4 or parts[0] != _MAGIC:
            break
        try:
            length, crc = int(parts[1]), int(parts[2], 16)
        except ValueError:
            break
        body = parts[3]
        if len(body) != length or zlib.crc32(body) != crc:
            break
        try:
            rec = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            break
        if not isinstance(rec, dict) or rec.get("k") not in RECORD_KINDS:
            break
        records.append(rec)
        off = nl + 1
    return records, off, total


def read_records(path: str | Path) -> tuple[list[dict], int]:
    """Decode the valid prefix of the journal at `path`.  Returns
    ``(records, torn_bytes)`` — torn_bytes counts the discarded tail."""
    records, valid_end, total = scan(Path(path).read_bytes())
    return records, total - valid_end


# --------------------------------------------------------------- recovery
@dataclasses.dataclass
class RecoveredRequest:
    """One unfinished request reconstructed from the journal / snapshot:
    exactly the payload `PapiEngine.restore` needs to rebuild a
    `_ResumedRequest` (original prompt, committed tokens, REMAINING token
    budget, REMAINING deadline delta)."""
    req_id: int
    prompt: list[int]            # ORIGINAL prompt (never the resumed one)
    done: list[int]              # tokens already committed
    max_new: int                 # remaining new-token budget
    deadline_s: float | None     # remaining deadline (monotonic delta)
    orig_prompt_len: int


@dataclasses.dataclass
class FinishedRequest:
    req_id: int
    reason: str
    tokens: list[int]            # the full committed stream
    # True when no finish record survived but the committed prefix already
    # exhausted the budget / hit eos: the finish was externalized before
    # the crash, so recovery must NOT re-run or re-emit it.
    synthesized: bool = False


@dataclasses.dataclass
class RecoveredState:
    """Folded logical state: the unfinished queue (in recovery order),
    the finished set, and the req-id counter."""
    requests: list[RecoveredRequest]
    finished: dict[int, FinishedRequest]
    next_req_id: int
    admit_seq: int = 0
    records: int = 0
    torn_bytes: int = 0

    @property
    def req_ids(self) -> list[int]:
        return [r.req_id for r in self.requests]


def replay(records: Iterable[dict], *, eos_token: int | None = None,
           torn_bytes: int = 0) -> RecoveredState:
    """Fold journal records into a `RecoveredState`.

    A pending request whose remaining budget hit zero — or whose last
    committed token is ``eos_token`` — lost only its finish record to the
    torn tail; it is synthesized into the finished set instead of being
    re-admitted, which is what makes finishes exactly-once."""
    records = list(records)
    pend: dict[int, dict] = {}
    finished: dict[int, FinishedRequest] = {}
    max_rid = -1
    for rec in records:
        rid = int(rec["req_id"])
        max_rid = max(max_rid, rid)
        kind = rec["k"]
        if kind == "submit":
            pend[rid] = dict(prompt=list(rec["prompt"]),
                             plen=len(rec["prompt"]), done=[],
                             rem=int(rec["max_new"]), dl=rec.get("dl"))
        elif kind == "resume":
            pend.pop(rid, None)
            pend[rid] = dict(prompt=list(rec["prompt"]),
                             plen=int(rec["plen"]), done=list(rec["done"]),
                             rem=int(rec["max_new"]), dl=rec.get("dl"))
        elif kind == "admit":
            if rid in pend:
                pend[rid]["rem"] = int(rec["budget"])
        elif kind == "commit":
            e = pend.get(rid)
            if e is not None:
                e["done"] += list(rec["toks"])
                e["rem"] = int(rec["rem"])
                if rec.get("dl") is not None:
                    e["dl"] = rec["dl"]
        elif kind == "preempt":
            if rid in pend:      # requeued at the back: recovery keeps that
                pend[rid] = pend.pop(rid)
        elif kind == "finish":
            e = pend.pop(rid, {"done": []})
            finished[rid] = FinishedRequest(
                rid, rec["reason"], list(e["done"]) + list(rec["toks"]))
        # "cancel" is informational: the engine emits the authoritative
        # finish record (reason="cancelled") through the same path as any
        # other completion
    requests: list[RecoveredRequest] = []
    for rid, e in pend.items():
        hit_eos = (eos_token is not None and e["done"]
                   and e["done"][-1] == eos_token)
        if e["rem"] <= 0 or hit_eos:
            finished[rid] = FinishedRequest(
                rid, "eos" if hit_eos else "length", list(e["done"]),
                synthesized=True)
            continue
        requests.append(RecoveredRequest(
            req_id=rid, prompt=list(e["prompt"]), done=list(e["done"]),
            max_new=int(e["rem"]), deadline_s=e["dl"],
            orig_prompt_len=int(e["plen"])))
    return RecoveredState(requests=requests, finished=finished,
                          next_req_id=max_rid + 1, records=len(records),
                          torn_bytes=torn_bytes)


# --------------------------------------------------------------- snapshot
SNAPSHOT_VERSION = 1


def write_snapshot(path: str | Path, state: dict) -> None:
    """Atomically write an engine snapshot dict: tmp + fsync + rename +
    directory fsync, so neither a process crash nor a power loss
    mid-snapshot leaves a half-written file where restore expects a
    consistent one (without the data fsync the rename can survive a power
    loss while the bytes do not)."""
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "w") as fh:
        fh.write(json.dumps(state, indent=2) + "\n")
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    try:
        dfd = os.open(path.parent, os.O_RDONLY)
    except OSError:               # platform can't open directories
        return
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _snapshot_state(snap: dict) -> RecoveredState:
    requests = [RecoveredRequest(
        req_id=int(r["req_id"]), prompt=list(r["prompt"]),
        done=list(r["done"]), max_new=int(r["max_new"]),
        deadline_s=r.get("deadline_s"),
        orig_prompt_len=int(r["orig_prompt_len"]))
        for r in snap["requests"]]
    finished = {int(f["req_id"]): FinishedRequest(
        int(f["req_id"]), f["reason"], list(f.get("tokens", [])))
        for f in snap.get("finished", [])}
    return RecoveredState(requests=requests, finished=finished,
                          next_req_id=int(snap.get("next_req_id", 0)),
                          admit_seq=int(snap.get("admit_seq", 0)))


def recover(path: str | Path, *, eos_token: int | None = None
            ) -> RecoveredState:
    """Load a snapshot file OR a journal file into a `RecoveredState`.
    Snapshots are JSON dicts carrying ``"papi_snapshot"``; anything else
    is read as a framed journal (torn tail discarded)."""
    data = Path(path).read_bytes()
    if data.lstrip()[:1] == b"{":
        snap = json.loads(data.decode("utf-8"))
        if snap.get("papi_snapshot") != SNAPSHOT_VERSION:
            raise ValueError(
                f"{path}: unsupported snapshot version "
                f"{snap.get('papi_snapshot')!r}")
        state = _snapshot_state(snap)
        # the eos/budget guard applies to snapshots too (a snapshot taken
        # right at a finish boundary must not re-run the request)
        keep = []
        for r in state.requests:
            hit_eos = (eos_token is not None and r.done
                       and r.done[-1] == eos_token)
            if r.max_new <= 0 or hit_eos:
                state.finished[r.req_id] = FinishedRequest(
                    r.req_id, "eos" if hit_eos else "length", list(r.done),
                    synthesized=True)
            else:
                keep.append(r)
        state.requests = keep
        return state
    records, valid_end, total = scan(data)
    return replay(records, eos_token=eos_token, torn_bytes=total - valid_end)
