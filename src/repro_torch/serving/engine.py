"""PAPI serving engine of the port: continuous batching with dynamic
FC-path scheduling over a dense KV slab or a paged KV pool, and lossless
greedy speculative decoding (TLP > 1) with a draft model —
`repro.serving.engine`'s `PapiEngine.submit/run/serve/step/cancel/
set_spec_len`, with its failure model.

Each iteration:
  1. admits waiting requests into free KV slots: chunk 0 of every admitted
     prompt runs through one batched `prefill_to_slots` call, later
     `prefill_len`-token chunks of long prompts through `prefill_chunk`
     waves (the decode path at the running offset, masked KV writes); only
     the final chunk's logits give the first token, and the whole admission
     costs one device->host copy.  With a draft model its cache is
     prefilled in the same waves, at the same offsets;
  2. decodes every slot (inactive slots decode garbage at pos = 1 that is
     never read) with greedy sampling on the device: one decode step at
     TLP = 1, or, with ``spec_len = k > 1`` and a draft, one speculative
     iteration — k draft steps at t = 1, one target `decode_step` over the
     window ``[last, proposals[:-1]]`` at t = k (the verify), the
     accept-longest-prefix (`sampler.accept_speculative`) and the rewind
     of both caches to the accepted prefix (positions, and the SSM state
     the window's steps kept per token), all on the device.  The
     iteration's ONE host transfer fetches the tokens (with the accepted
     counts and the eos flags when speculating); an MoE model's layers add one copy
     each per forward (`models.moe`), counted in the iteration's
     transfers and in `transfer_budget`;
  3. feeds the finish flags to `core.scheduler.PapiScheduler`, which
     compares AI ~= RLP * TLP with alpha and picks "pu" (matmul) or "pim"
     (`fc_gemv`) for the next iteration's FC projections (the draft's
     included).  `set_spec_len` writes the TLP register.

``fused=False`` keeps the reference's host loop as the oracle of the
speculative iteration: one fetch per draft step and one for the verify.

`serve(arrivals)` is the live front end: a generator of `TokenEvent`s over
an arrival stream polled once per iteration.  Under it admission does not
stall on a long prompt: chunk 0 runs at admission and the slot enters
MID-PREFILL (``slot_offset < slot_prompt``; under pages only chunk 0's
pages are mapped up front).  Each later iteration advances every
mid-prefill slot by one chunk: at TLP = 1 in ONE `models.mixed_step` wave
with the ongoing decodes (a decode is a chunk of length 1), under the
scheduler's FC variant and the engine's attention, with one fetch; when
speculating, in a chunk wave of its own (ambient FC variant) before the
fused speculative iteration.  Every request carries its queue delay, TTFT
and TPOT (`serving.metrics`), in seconds and in iterations.  The streams
equal the offline ``submit()`` + ``run()`` streams of the same requests.

``attn_pim=True`` routes every decode-path attention — plain decode and
chunk waves and verify windows alike — through the Attn-PIM kernel.
Admission runs under the ambient FC variant ("pu"), as in the reference.

Every decoder family is served.  The pure attention ones (dense, MoE, the
VLM backbone) take chunk waves, the paged layout and speculation.  An MoE
model's scheduler reads its per-expert parallelism RLP·TLP·top_k/E
(`core.ai.effective_parallelism`), so its FC variant follows that figure.
The SSM (mamba2) and hybrid (zamba2) families carry per-slot SSM state
that has no sequence dim to mask, so they take no chunk waves: a prompt
longer than ``prefill_len`` is rejected honestly, as in the reference.
Every admission wave's prefill runs each SSM layer's chunked scan through
the `ssd_scan` kernel, with each row's state stopped at its prompt's end
(the reference's takes in the window's padding).  They speculate on the
dense slab: the verify keeps each layer's SSM state and conv history
after every token of its window, the draft keeps its k steps' states, and
a partial accept selects both at the accepted prefix (`models.rewind_ssm`)
beside the position rewind.  The reference rewinds only the position, so
its speculative streams on these families leave its TLP = 1 streams; the
port's equal them.

``kv_layout="paged"`` holds the KV cache in a pool of ``page_size``-token
pages (one Attn-PIM bank row each; `serving.kv_pages`), by default the
dense slab's bytes: ``max_slots * cache_capacity / page_size`` pages plus
the garbage page 0.  Admission is budgeted by pages from that one pool: a
prompt longer than the table can hold is rejected; a request whose prompt,
budget and decode window (``max(spec_len, 1)`` rows) do not fit the pages
available right now DEFERS (the queue keeps its order); otherwise its
whole prompt's pages are mapped up front and the rest of its budget is
reserved.  Each decode maps the pages its next KV rows need (`ensure`), a
partial accept returns the pages past the accepted prefix (`rewind`; the
reservation keeps them claimable), and the block tables go host->device
only after a row changed.  The draft's KV is a second pool indexed by the
same block tables.  A request longer than a dense slot completes.

The failure model is the reference's:

  * pool-pressure preemption (paged): when the head of the queue has
    deferred ``preempt_after`` iterations in a row, the YOUNGEST
    in-flight request (highest admission number) is preempted: its pages
    go back to the pool and it is requeued at the back as a
    `_ResumedRequest`, ``prompt + tokens so far``, which chunked admission
    recomputes.  The oldest is never preempted, so the head always admits
    in bounded time;
  * ``ServeRequest.deadline_s`` (from submit) and `cancel` finish a queued
    or in-flight request as "timeout" / "cancelled" with its tokens so
    far, and drain its pages;
  * the finite-logits guard: the plain step, the fused speculative verify
    and the mixed wave compute ``~isfinite(logits).all()`` on the device,
    and the flag rides the iteration's one fetch.  A poisoned step is
    discarded and re-run once without the injected fault, speculation
    clamped to one step for the target and the draft
    (`IterStats.degraded`, a WARNING on the ``repro_torch.serving``
    logger).  On the CPU the re-run takes the reference's plain path ("pu"
    FC, plain attention); on the card it runs the engine's own kernels,
    since a CUDA tensor goes to its kernel or raises, so a step that is
    non-finite again with no fault injected is a fault of the path and
    raises.  The guard catches no exception: a kernel that fails to build
    or launch raises.  The reference drops a poisoned step by never
    assigning the cache it returned; the port's caches change in place, so
    the engine keeps the caches' dict entries from before the step and
    puts them back: the ``pos`` tensors are replaced, never mutated, so
    the old ones hold the pre-step positions; K/V rows the step wrote sit
    at its own positions, which the re-run writes again (rows past the
    restored ``pos`` are never read); and a decode step writes the SSM
    families' new state into fresh tensors, as it replaces ``pos``, so the
    old entry is the pre-step state;
  * `faults.FaultInjector` forces admission failure, NaN / Inf logits,
    step latency and a crash (`EngineCrashError`, raised at the top of
    `step` with no clean-up), deterministically;
  * the watchdog: ``stall_limit`` iterations in a row that admit, decode,
    prefill, finish and preempt nothing while work is pending raise
    `EngineStallError` with a snapshot of the queue, slots and pool;
  * ``debug_invariants=True`` checks the page allocator every iteration
    and raises `AllocatorInvariantError` with the snapshot.

Durability (``journal=``, `serving.journal`): a write-ahead journal takes
a record at every submit, admission, preemption, cancel and finish, and
at the end of every step one ``commit`` per live request that committed
tokens, before `serve()` yields them.  `snapshot` holds host-side logical
state only, never a device tensor; `restore` re-admits every unfinished
request of a journal or snapshot through the `_ResumedRequest` path, with
its deadline rebased to the budget it had left, and never re-runs a
finished one.  The crash fault ends a run with no finish, no abort and no
clean-up, so ``restore`` finds its in-flight requests unfinished.  The
records are the reference's, byte for byte: a journal written by either
package restores in the other.

Observability (``tracer=``, `serving.telemetry`): every lifecycle step,
scheduler decision, iteration, pool sample, fault, degraded re-run and
stall emits the reference's typed event, and every model program goes
through `_call(key, fn, *args)` under the reference's key, which the
tracer times (wall clock on the CPU, a CUDA event pair on the card,
resolved after the iteration's one fetch).  Under the default
`NullTracer` `_call` is a bare call.  ``sanitize=True``
(`debug.sanitize`) runs each step under PyTorch's sync-debug mode on the
card and holds steady iterations to `transfer_budget` host transfers.

Mesh serving (``mesh=``, `launch.mesh.make_serving_mesh`): the engine is
SPMD over the ranks of a (data, model) mesh, one process each, and every
rank runs the same host loop on the same requests: the queue, admission,
the scheduler (which sees the whole batch's RLP), the page manager,
preemption, deadlines and the journal are host state that is the same
everywhere.  ``rules`` defaults to ``serve_rules(attn_pim=attn_pim or
kv_layout == "paged")`` as in the reference.  The tensor axis (``model``)
splits the weights: each rank keeps its block of the params (and the
draft's; `models.weights.shard_params`), the paged pools split by KV
head, the dense slab by sequence unless ``attn_pim``, and every model
program runs under `distributed.sharding.axis_rules`, whose collectives
(`models.linear` row banks, the sharded Attn-PIM units, the vocab-split
embedding and logits) leave every rank of a tensor group the same
logits.  The data axis splits the slot batch by the reference's "batch"
rule: slot s lives on data group s // (max_slots / dp) (a batch dp does
not divide stays whole on every group).  A group's slab and SSM state
hold its slots only, and every forward (the plain step, the fused verify
and the draft's steps, the mixed and chunk waves, the admission prefill,
whose rows sit at their slots) takes its slots' rows only; what the
iteration's one fetch reads (tokens, accepted counts, the eos and
finite-logits flags) is gathered over ``data`` on the device, in rank
order, and fetched once, so every rank reads the whole batch's values
and picks, admits, schedules and finishes alike.  The paged pools stay
whole on every data rank (the reference puts no "batch" on them); a
group maps its slots' rows of the block tables and writes and reads only
their pages, and nothing of the pools is gathered.  What could differ is
agreed: deadline expiry (each rank's clock) is OR-ed over the ranks, and
``debug_invariants`` gathers each fetch's tokens and raises unless every
rank chose the same.  Rank 0 alone writes files (the journal, snapshots;
the launcher writes the trace and the metrics).  Where the ranks share a
card over gloo, each collective stages through a host copy: the engine
counts those in `IterStats.transfers` and in `transfer_budget`.  Every
decoder family is served on both axes: the MoE layer splits its experts
over the tensor axis, the Mamba2 block its heads (and the SSM state), and
zamba2's shared block is banked as a dense layer.

``rules`` may also keep the batch whole over "data" (`_data_split` is
then False: every data group holds and computes every slot, and `_fetch`
gathers nothing, so `transfer_budget` counts as on a tensor split): the
long-context table (the KV sequence over (data, model); every decoder
family, the dense slab) and the 2D weight-stationary decode of
`launch.steps.choose_rules` (each FC weight the rank's 2D block,
contracted in place, `models.linear`; the dense family).  The FSDP
prefill's table (the weights and the batch over "data") gathers each
layer's weights at its entry (`models.model.serve_split`).  With dp > 1
a paged cache under those tables, and a non-dense family under a table
that puts the weights on "data", raise (`check_mesh`), naming a later
slice.

Not ported yet: ``run(abort_in_flight=False)``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.scheduler import PapiScheduler
from repro_torch.debug.sanitize import EngineSanitizer
from repro_torch.distributed.sharding import (axis_rules, batch_block,
                                              data_layout, serve_rules)
from repro_torch.models import (attn_impl, current_fc_variant, decode_step,
                                fc_variant, init_cache, init_paged_cache,
                                mixed_step, prefill_chunk, prefill_to_pages,
                                prefill_to_slots, rewind_ssm,
                                ssm_step_buffers)
from repro_torch.models import moe as M
from repro_torch.models.model import (KV_FAMILIES, collectives_per_forward,
                                      host_copies_per_forward)
from repro_torch.models.weights import shard_params
from repro_torch.serving.faults import (FAULT_NAN, FAULT_NONE,
                                        FaultInjector)
from repro_torch.serving.journal import (SNAPSHOT_VERSION, Journal, recover,
                                         write_snapshot)
from repro_torch.serving.kv_pages import PagedKVManager
from repro_torch.serving.sampler import accept_speculative, greedy
from repro_torch.serving.telemetry import NULL_TRACER, Tracer

# deferral (DEBUG), preemption and unhappy finishes (INFO), degraded
# re-runs (WARNING), stalls (ERROR); silent until configured
# (`launch.serve --log-level`)
log = logging.getLogger("repro_torch.serving")

@dataclasses.dataclass
class ServeRequest:
    req_id: int
    prompt: list[int]
    max_new_tokens: int
    # wall-clock budget in seconds from submit(); None: unbounded.  An
    # expired request finishes as "timeout" with its tokens so far at the
    # next step boundary.
    deadline_s: float | None = None


@dataclasses.dataclass
class ServeResult:
    req_id: int
    tokens: list[int]
    prompt_len: int
    iterations: int
    finished_reason: str = "length"
    # latencies (serving/metrics.py): wall-clock seconds, None where the
    # phase never happened; the *_iters twins count engine iterations
    queue_delay_s: float | None = None   # submit -> first admission
    ttft_s: float | None = None          # submit -> first token
    tpot_s: float | None = None          # mean gap after the first token
    queue_delay_iters: int | None = None
    ttft_iters: int | None = None


@dataclasses.dataclass
class TokenEvent:
    """One event of `PapiEngine.serve`: a committed token of a live
    request, or (``finished=True``) its completion, which carries
    ``token == -1``, ``index == len(result.tokens)``, the reason and the
    `ServeResult`."""
    req_id: int
    token: int
    index: int
    iteration: int
    finished: bool = False
    reason: str | None = None
    result: ServeResult | None = None


@dataclasses.dataclass
class _ResumedRequest:
    """A preempted request requeued: the caller's prompt extended with the
    tokens already emitted, so chunked admission recomputes the KV and the
    first token it gives is the decode step the preemption skipped.  The
    caller's `ServeRequest` is never touched; `done` and `orig_prompt_len`
    let `_emit` and `serve()` reassemble the caller's stream."""
    req_id: int
    prompt: list[int]          # original prompt + tokens emitted so far
    max_new_tokens: int        # the remaining generation budget
    deadline_s: float | None
    done: list[int]            # tokens emitted before the preemption(s)
    orig_prompt_len: int


class EngineStallError(RuntimeError):
    """No progress — nothing admitted, decoded, prefilled, finished or
    preempted — for ``stall_limit`` iterations in a row while requests
    were pending.  ``snapshot`` holds the queue, slot and pool state."""

    def __init__(self, message: str, snapshot: dict):
        super().__init__(message)
        self.snapshot = snapshot


class EngineCrashError(RuntimeError):
    """A ``crash`` fault fired: the engine dies at the top of the
    iteration like a killed process (no results, no pages drained, no
    journal finalisation).  Recovery starts a fresh engine and `restore()`s
    from the journal or a snapshot."""

    def __init__(self, message: str, iteration: int):
        super().__init__(message)
        self.iteration = iteration


class AllocatorInvariantError(RuntimeError):
    """A ``debug_invariants=True`` engine caught the page allocator
    breaking an invariant; ``snapshot`` holds the engine and pool state."""

    def __init__(self, message: str, snapshot: dict):
        super().__init__(message)
        self.snapshot = snapshot


def _inject_fault(logits: torch.Tensor, code: int) -> torch.Tensor:
    """The iteration's logits fault: FAULT_NAN poisons every logit with
    NaN, FAULT_INF (an overflowed accumulator) with +inf, FAULT_NONE
    passes the logits through untouched."""
    if code == FAULT_NONE:
        return logits
    return torch.full_like(logits,
                           float("nan") if code == FAULT_NAN else float("inf"))


def _nonfinite(logits: torch.Tensor) -> torch.Tensor:
    """The finite-logits guard's flag, a device bool: any NaN or Inf."""
    with torch.profiler.record_function("finite_guard"):
        return ~torch.isfinite(logits).all()


def _plain_step(cfg, params, cache, last, code):
    """The fused plain decode program: one decode step, the iteration's
    logits fault, greedy tokens and the guard's flag on the device."""
    logits, cache = decode_step(cfg, params, cache, last[:, None])
    logits = _inject_fault(logits, code)
    return greedy(logits[:, -1]), _nonfinite(logits), cache


def _step_slice(steps, j: int):
    """Step j's [L, 1, b, ...] slice of per-token SSM state buffers, for
    one of the draft's t = 1 steps (None without SSM state)."""
    return None if steps is None else type(steps)(*(x[:, j:j + 1]
                                                     for x in steps))


def _guarded_wave(cfg, params, cache, toks, lens, pin_mask, pin_pos, code):
    """The mixed wave program: `mixed_step`, the logits fault, greedy
    tokens and the guard's flag."""
    logits, cache = mixed_step(cfg, params, cache, toks, lens, pin_mask,
                               pin_pos)
    logits = _inject_fault(logits, code)
    return greedy(logits), _nonfinite(logits), cache


@dataclasses.dataclass
class IterStats:
    iteration: int
    rlp: int
    tlp: int
    ai_estimate: float
    fc_variant: str
    new_tokens: int
    wall_s: float
    accepted: float = 0.0  # mean accepted tokens per decoding slot
    transfers: int = 0     # device->host copies this iteration
    admitted: int = 0      # requests admitted to slots this iteration
    # the failure model:
    preemptions: int = 0   # in-flight requests preempted this iteration
    deferral_age: int = 0  # iterations in a row the queue head deferred
    degraded: int = 0      # 1 if the finite-logits guard re-ran the step
    # paged KV layout only (zeros under the dense layout):
    kv_pages_used: int = 0       # pages holding live KV right now
    kv_pages_free: int = 0       # pages on the free list
    kv_page_watermark: int = 0   # peak pages used over the engine lifetime
    kv_fragmentation: float = 0.0  # tail-of-page waste share of mapped rows
    # continuous batching (arrivals and prefill_slots stay 0 under run()):
    arrivals: int = 0        # requests that arrived this iteration
    queued: int = 0          # queue depth after this iteration's admission
    prefill_slots: int = 0   # slots mid-chunked-prefill this iteration
    decode_slots: int = 0    # slots that ran a decode step this iteration


def check_decoder(cfg: ModelConfig) -> None:
    """Refuse an encoder-only model: it has no decode step to serve."""
    if not cfg.has_decode_step:
        raise ValueError(f"{cfg.name} is encoder-only")


# `distributed.sharding.data_layout` -> the table it names
DATA_TABLES = {"gather": "the FSDP prefill",
               "contract": "the 2D weight-stationary decode",
               "seq": "the long-context table"}


def check_mesh(shape: dict, rules: dict, family: str,
               kv_layout: str = "dense") -> None:
    """Refuse what mesh serving does not cover yet, naming the later
    slice.  With dp > 1: a paged cache under a table that puts the weights
    or the KV sequence on "data" or keeps the batch whole (the FSDP
    prefill, the 2D weight-stationary decode, the long-context table:
    they serve the dense slab, as `launch.steps.build_step`'s cells do),
    and a MoE, SSM, hybrid or VLM model (`family`) under a table that puts
    the weights on "data" (no such assigned model passes the threshold of
    `launch.steps.choose_rules` on an 80 GB card).  Every decoder family
    is served on both axes under the other tables, the long-context one
    included."""
    if shape.get("data", 1) <= 1:
        return
    layout = data_layout(rules)
    if layout is None:
        return
    table = DATA_TABLES[layout]
    if kv_layout == "paged":
        raise ValueError(
            f"mesh {dict(shape)}: a paged KV cache under {table} with "
            "dp > 1 comes with a later slice of the port (serve the dense "
            "slab)")
    if family != "dense" and layout != "seq":
        raise ValueError(
            f"mesh {dict(shape)}: the {family} family under {table} (its "
            "weights over 'data') with dp > 1 comes with a later slice of "
            "the port")


def _check_mesh(mesh, rules: dict, device: torch.device, family: str,
                kv_layout: str) -> None:
    check_mesh(mesh.shape, rules, family, kv_layout)
    if mesh.device.type != device.type:
        raise ValueError(f"the mesh's rank runs on {mesh.device}, the "
                         f"engine on {device}")
    if rules.get("act_kv_seq") is not None and rules.get("kv_heads") \
            is not None:
        raise ValueError("rules split both the KV sequence and the KV "
                         "heads; a slab takes one of them")


class PapiEngine:
    """Serving engine on one device (``cuda`` unless ``device="cpu"``), or
    one rank of a mesh (``mesh=``, ``rules=``; module docstring).

    ``draft=(cfg, params)`` and ``spec_len > 1`` turn on speculative
    decoding; the draft needs the target's vocabulary and its params on
    the engine's device."""

    def __init__(self, cfg: ModelConfig, params: dict, *, max_slots: int = 8,
                 cache_capacity: int = 256, prefill_len: int = 64,
                 alpha: float = 32.0, spec_len: int = 1,
                 draft: tuple[ModelConfig, dict] | None = None,
                 eos_token: int = 2, fused: bool = True,
                 attn_pim: bool = False, kv_layout: str = "dense",
                 page_size: int = 16, num_pages: int | None = None,
                 max_blocks: int | None = None,
                 faults: FaultInjector | None = None,
                 preempt_after: int | None = 8,
                 stall_limit: int | None = 256,
                 debug_invariants: bool = False,
                 tracer: Tracer | None = None,
                 sanitize: bool = False,
                 journal: Journal | str | None = None,
                 mesh=None, rules: dict | None = None,
                 device: torch.device | str | None = None) -> None:
        check_decoder(cfg)
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', not "
                             f"{kv_layout!r}")
        self.device = resolve_device(device)
        for what, p in (("params", params),
                        ("draft params", draft[1] if draft else None)):
            if p is not None and p["embed"]["w"].device.type != self.device.type:
                raise ValueError(f"{what} live on {p['embed']['w'].device}, "
                                 f"the engine on {self.device}")
        if draft is not None and draft[0].vocab_size != cfg.vocab_size:
            raise ValueError(f"draft {draft[0].name} has vocabulary "
                             f"{draft[0].vocab_size}, the target {cfg.name} "
                             f"{cfg.vocab_size}: their tokens must agree")
        self.mesh = mesh
        self.rules = None
        if mesh is not None:
            self.rules = (dict(rules) if rules is not None else serve_rules(
                attn_pim=attn_pim or kv_layout == "paged"))
            for c in (cfg, draft[0] if draft else None):
                if c is not None:
                    _check_mesh(mesh, self.rules, self.device, c.family,
                                kv_layout)
            params = shard_params(cfg, params, self.rules, mesh)
            if draft is not None:
                draft = (draft[0], shard_params(draft[0], draft[1],
                                                self.rules, mesh))
        # this data group's slots: the rows its forwards compute and its
        # caches hold (all of them on one device, or where the data axis
        # does not divide the batch)
        with self._mesh_scope():
            lo, hi = batch_block(max_slots)
        self._rows = slice(lo, hi)
        self._data_split = hi - lo < max_slots
        self.cfg, self.params = cfg, params
        self.draft_cfg, self.draft_params = draft if draft else (None, None)
        self.spec_len = spec_len
        self.fused = fused
        self.max_slots = max_slots
        self.capacity = cache_capacity
        self.prefill_len = prefill_len
        self.eos_token = eos_token
        self.attn_pim = attn_pim
        # chunked prefill masks its KV writes per slot; SSM state has no
        # sequence dim to mask, so stateful families keep single-window
        # prefill and reject longer prompts honestly — as target or draft,
        # since the draft's cache is prefilled in the same waves
        self._can_chunk = all(c.family in KV_FAMILIES
                              for c in (cfg, self.draft_cfg) if c is not None)
        # telemetry: NULL_TRACER's hooks are no-ops and `_call` is then a
        # bare call, so the untraced hot path is unchanged
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._timed_call = (self.tracer.timed_call_cuda
                            if self.device.type == "cuda"
                            else self.tracer.timed_call)
        # the sanitizer (debug/sanitize.py): sync-debug scopes around every
        # step on the card, the transfer budget, the program/build census
        self._sanitizer = EngineSanitizer() if sanitize else None
        self.scheduler = PapiScheduler(cfg, alpha=alpha, tlp=spec_len,
                                       eos_token=eos_token)
        self.scheduler.initial_schedule(0, spec_len)
        self.kv: PagedKVManager | None = None
        if kv_layout == "paged":
            # default pool: the dense slab's bytes plus the garbage page,
            # pooled so that one request may span nearly all of it
            if num_pages is None:
                num_pages = max(max_slots * cache_capacity // page_size, 1) + 1
            self.kv = PagedKVManager(num_pages=num_pages, page_size=page_size,
                                     max_slots=max_slots,
                                     max_blocks=max_blocks)
            # per-call page events are the trace's highest-volume kind:
            # only under debug_invariants or a tracer that asked for them
            if self.tracer.enabled and (debug_invariants
                                        or self.tracer.page_events):
                self.kv.tracer = self.tracer
            # the draft's KV lives at the same logical positions: a second
            # pool of the same geometry, indexed by the same block tables
            with self._mesh_scope():
                self.cache, self.draft_cache = (
                    init_paged_cache(c, max_slots, num_pages, page_size,
                                     self.kv.max_blocks, self.device)
                    if c is not None else None
                    for c in (cfg, self.draft_cfg))
        else:
            with self._mesh_scope():
                self.cache, self.draft_cache = (
                    init_cache(c, max_slots, cache_capacity, self.device)
                    if c is not None else None
                    for c in (cfg, self.draft_cfg))
        # per-slot host state
        self.slot_req: list[ServeRequest | None] = [None] * max_slots
        self.slot_tokens: list[list[int]] = [[] for _ in range(max_slots)]
        self.slot_last = np.zeros(max_slots, np.int32)
        self.slot_prompt = np.zeros(max_slots, np.int32)
        # admission-clamped generation budget; the caller's request is
        # never written back
        self.slot_budget = np.zeros(max_slots, np.int64)
        # prompt tokens prefilled so far: a slot is MID-PREFILL while
        # slot_offset < slot_prompt, which only serve() allows (offline
        # admission runs a prompt's waves to the end)
        self.slot_offset = np.zeros(max_slots, np.int64)
        self.queue: list[ServeRequest] = []
        self.results: list[ServeResult] = []
        self.stats: list[IterStats] = []
        self.iteration = 0
        self.host_transfers = 0
        self.stream_chunks = False   # serve() turns it on for its lifetime
        self._arrived_this_step = 0  # set by serve(), kept in IterStats
        # latency stamps by req_id, wall clock and iteration; the first
        # submission, admission and token win
        self._submit_t: dict[int, float] = {}
        self._admit_t: dict[int, float] = {}
        self._first_tok_t: dict[int, float] = {}
        self.submit_iteration: dict[int, int] = {}
        self.admit_iteration: dict[int, int] = {}
        self.first_token_iteration: dict[int, int] = {}
        # the failure model
        self.faults = faults
        self.preempt_after = preempt_after
        self.stall_limit = stall_limit
        self.debug_invariants = debug_invariants
        # admission order per slot: preemption takes the highest number
        # (the youngest), never the lowest
        self._admit_seq = 0
        self.slot_seq: list[int] = [0] * max_slots
        self._defer_head: int | None = None     # req_id of the deferring head
        self._defer_age = 0                     # iterations it deferred
        self._deferred_head: int | None = None  # set by _admit on a deferral
        self._degraded_this_step = False
        self._stalled = 0                       # no-progress iterations
        self.preemptions = 0                    # engine lifetime
        self.degraded_steps = 0                 # engine lifetime
        self.preempted_ids: set[int] = set()
        # durability: a path opens (and torn-tail-truncates) a Journal with
        # the default flush policy; pass a Journal to choose the policy.
        # _journal_done counts the tokens already journaled per req_id, so
        # the end-of-step commits append deltas only.
        if not self._writes_files:
            journal = None      # rank 0 alone writes files
        self.journal: Journal | None = (
            Journal(journal) if journal is not None
            and not isinstance(journal, Journal) else journal)
        self._journal_done: dict[int, int] = {}
        if self.journal is not None and self.tracer.enabled:
            self.tracer.emit("journal", 0, op="open",
                             path=str(self.journal.path),
                             records=self.journal.records_kept,
                             truncated_bytes=self.journal.truncated_bytes)

    # ------------------------------------------------------------------ API
    def submit(self, req: ServeRequest) -> None:
        self.queue.append(req)
        self._submit_t.setdefault(req.req_id, self._now())
        self.submit_iteration.setdefault(req.req_id, self.iteration)
        if self.journal is not None:
            self.journal.append("submit", req_id=req.req_id,
                                prompt=list(req.prompt),
                                max_new=int(req.max_new_tokens),
                                dl=req.deadline_s)
        if self.tracer.enabled:
            self.tracer.emit("submit", self.iteration, req_id=req.req_id,
                             prompt_len=len(req.prompt),
                             max_new=req.max_new_tokens)

    def set_spec_len(self, tlp: int) -> None:
        """The host writes the TLP register (dynamic speculation length).

        Admission reserved ``prompt + budget + window`` per live slot, so a
        wider window re-checks them, or the verify's KV writes would run
        past what was reserved: under pages the live reservations are
        re-budgeted and the window clamped to what the free pool and the
        table width cover; on the dense slab it is clamped to the smallest
        live slot's headroom (a write past the capacity would clamp down
        onto live KV).  Narrower is always affordable; on a clamp the
        scheduler gets a smaller TLP than was asked for."""
        if tlp != self.spec_len:
            tlp = (self._rebudget_spec_window(tlp) if self.kv is not None
                   else self._clamp_spec_window_dense(tlp))
        self.spec_len = tlp
        self.scheduler.set_tlp(tlp)

    @property
    def active_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    def run(self, max_iterations: int = 10_000) -> list[ServeResult]:
        """Step until the queue and the slots are empty.  Exhaustion of
        `max_iterations` returns the in-flight requests as "aborted" with
        their tokens so far and drains their pages (queued requests stay
        queued)."""
        while (self.queue or self.active_slots) and (
                self.iteration < max_iterations):
            self.step()
        if self.iteration >= max_iterations:
            for s in self.active_slots:
                self._finish_slot(s, "aborted")
        return self.results

    def serve(self, arrivals, *, max_iterations: int = 100_000):
        """Continuous batching over a live arrival stream: a generator of
        `TokenEvent`s.

        ``arrivals`` is polled once per iteration; each item is the
        requests arriving then (a `ServeRequest`, a list of them, or None),
        and its end closes the stream: the loop then drains the queue and
        the slots and returns.  Each iteration yields the tokens committed
        in it (live slots first), then each finished request's tail and
        final event.

        A token's index counts the caller's stream: a preempted request's
        indices go on after its re-admission, and the tokens it recomputes
        are never sent again.  `cancel` may be called between two events:
        a slot it frees is skipped, and its final event follows.

        Exhausting `max_iterations` finishes the in-flight requests as
        "aborted" and still yields their final events.  Closing the
        generator early (``break``, ``close()``) finishes them as "aborted"
        too, in ``self.results`` (no event can be yielded then); the pool
        drains, queued requests stay queued and the engine stays usable.
        An exception out of `step()` (`EngineCrashError`,
        `EngineStallError`, ...) re-raises with no such clean-up."""
        arrivals = iter(arrivals)
        streamed: dict[int, int] = {}   # req_id -> tokens already yielded
        reported = len(self.results)    # results already turned into events
        stream_open, completed, crashed = True, False, False
        prev = self.stream_chunks
        self.stream_chunks = True
        try:
            while True:
                if stream_open:
                    try:
                        got = next(arrivals)
                    except StopIteration:
                        stream_open = False
                    else:
                        if got is None:
                            got = []
                        elif isinstance(got, ServeRequest):
                            got = [got]
                        for req in got:
                            self.submit(req)
                        self._arrived_this_step = len(got)
                if not stream_open and not (self.queue or self.active_slots):
                    completed = True
                    return
                if self.iteration >= max_iterations:
                    for s in self.active_slots:
                        self._finish_slot(s, "aborted")
                    yield from self._drain_events(streamed, reported)
                    completed = True
                    return
                self.step()
                for s in self.active_slots:
                    req = self.slot_req[s]
                    if req is None:
                        continue      # a cancel() between two events freed it
                    full = self._full_stream(s)
                    sent = streamed.get(req.req_id, 0)
                    for i in range(sent, len(full)):
                        yield TokenEvent(req.req_id, full[i], i,
                                         self.iteration)
                    streamed[req.req_id] = max(sent, len(full))
                new_reported = len(self.results)
                yield from self._drain_events(streamed, reported)
                reported = new_reported
        except GeneratorExit:
            raise                 # early close: the finally aborts
        except BaseException:
            crashed = True        # a failure in step(): no clean-up
            raise
        finally:
            self.stream_chunks = prev
            if not completed and not crashed:
                for s in self.active_slots:
                    self._finish_slot(s, "aborted")

    def _drain_events(self, streamed: dict[int, int], reported: int):
        """For every result since `reported`: its tokens not yet streamed,
        then its final event."""
        for res in self.results[reported:]:
            sent = streamed.pop(res.req_id, 0)
            for i in range(sent, len(res.tokens)):
                yield TokenEvent(res.req_id, res.tokens[i], i,
                                 self.iteration)
            yield TokenEvent(res.req_id, -1, len(res.tokens), self.iteration,
                             finished=True, reason=res.finished_reason,
                             result=res)

    def cancel(self, req_id: int) -> bool:
        """Cancel a queued or in-flight request: it finishes as "cancelled"
        with its tokens so far, and its pages drain.  False when no pending
        request carries `req_id`."""
        for i, req in enumerate(self.queue):
            if req.req_id == req_id:
                self.queue.pop(i)
                self._journal_cancel(req_id)
                self._emit(req, [], "cancelled")
                return True
        for s in self.active_slots:
            if self.slot_req[s].req_id == req_id:
                self._journal_cancel(req_id)
                self._finish_slot(s, "cancelled")
                return True
        return False

    def _journal_cancel(self, req_id: int) -> None:
        if self.journal is not None:
            self.journal.append("cancel", req_id=req_id, it=self.iteration)

    # ----------------------------------------------------------- durability
    def _full_stream(self, s: int) -> list[int]:
        """Live slot `s`'s caller-visible tokens: a resumed request's
        earlier output, then this admission's."""
        req = self.slot_req[s]
        done = req.done if isinstance(req, _ResumedRequest) else []
        return list(done) + self.slot_tokens[s]

    def _remaining_deadline(self, req, now: float) -> float | None:
        """The deadline budget `req` has left at `now` (a monotonic delta)."""
        if req.deadline_s is None:
            return None
        t0 = self._submit_t.get(req.req_id)
        return req.deadline_s if t0 is None else req.deadline_s - (now - t0)

    def _journal_commits(self) -> None:
        """End-of-step WAL flush: one commit record (the new tokens, the
        total, the remaining token budget and deadline) per live slot that
        committed tokens this iteration.  It runs before `serve()` yields
        the step's events, so a streamed token is at least as durable as
        the journal's flush policy."""
        now = self._now()
        for s in self.active_slots:
            req = self.slot_req[s]
            full = self._full_stream(s)
            prev = self._journal_done.get(req.req_id, 0)
            if len(full) <= prev:
                continue
            self.journal.append(
                "commit", req_id=req.req_id, toks=full[prev:], n=len(full),
                rem=int(self.slot_budget[s]) - len(self.slot_tokens[s]),
                dl=self._remaining_deadline(req, now), it=self.iteration)
            self._journal_done[req.req_id] = len(full)

    def snapshot(self, path: str | None = None) -> dict:
        """Host-side logical state only — the queue's order, each unfinished
        request's (prompt, committed tokens, remaining token budget,
        remaining deadline), the admission counter — never a device
        tensor: `restore` re-admits the work through the `_ResumedRequest`
        path, which rebuilds the KV cache.  Unfinished work is listed in
        recovery order: in-flight slots (oldest admission first), then the
        queue.  With `path` the snapshot is also written atomically
        (`journal.write_snapshot`)."""
        now = self._now()

        def entry(req, emitted, rem):
            if isinstance(req, _ResumedRequest):
                prompt = req.prompt[:req.orig_prompt_len]
                plen = req.orig_prompt_len
                done = list(req.done) + list(emitted)
            else:
                prompt, plen, done = req.prompt, len(req.prompt), list(emitted)
            return {"req_id": req.req_id, "prompt": [int(t) for t in prompt],
                    "done": [int(t) for t in done], "max_new": int(rem),
                    "deadline_s": self._remaining_deadline(req, now),
                    "orig_prompt_len": plen}

        requests = [entry(self.slot_req[s], self.slot_tokens[s],
                          int(self.slot_budget[s]) - len(self.slot_tokens[s]))
                    for _, s in sorted((self.slot_seq[s], s)
                                       for s in self.active_slots)]
        requests += [entry(req, [], req.max_new_tokens) for req in self.queue]
        all_ids = ([r.req_id for r in self.results]
                   + [e["req_id"] for e in requests])
        state = {
            "papi_snapshot": SNAPSHOT_VERSION,
            "iteration": self.iteration,
            "admit_seq": self._admit_seq,
            "next_req_id": max(all_ids, default=-1) + 1,
            "requests": requests,
            "finished": [{"req_id": r.req_id, "reason": r.finished_reason,
                          "tokens": list(r.tokens)} for r in self.results],
        }
        if path is not None and self._writes_files:
            write_snapshot(path, state)
            if self.tracer.enabled:
                self.tracer.emit("journal", self.iteration, op="snapshot",
                                 path=str(path), requests=len(requests))
        return state

    def restore(self, path) -> dict:
        """Re-admit every unfinished request of the snapshot or journal at
        `path` into this (fresh) engine as a `_ResumedRequest`: ``prompt +
        committed tokens`` re-chunks through prefill and the stream goes
        on where the journal left it.  Finished requests — a torn tail's
        too, whose committed prefix already spent its budget or hit eos —
        are never re-admitted, so finishes stay exactly-once.  Each
        deadline resumes with the budget it had left.  Returns a summary
        (resumed / finished / records / torn_bytes / next_req_id)."""
        state = recover(path, eos_token=self.eos_token)
        now = self._now()
        for r in state.requests:
            self.queue.append(_ResumedRequest(
                req_id=r.req_id, prompt=list(r.prompt) + list(r.done),
                max_new_tokens=int(r.max_new), deadline_s=r.deadline_s,
                done=list(r.done), orig_prompt_len=r.orig_prompt_len))
            # the deadline survives as a remaining delta: rebase the submit
            # stamp to now, so the expiry sees the budget that was left
            self._submit_t[r.req_id] = now
            self.submit_iteration.setdefault(r.req_id, self.iteration)
            self._journal_done[r.req_id] = len(r.done)
            if self.journal is not None:
                self.journal.append(
                    "resume", req_id=r.req_id, prompt=list(r.prompt),
                    done=list(r.done), max_new=int(r.max_new),
                    dl=r.deadline_s, plen=r.orig_prompt_len)
        self._admit_seq = max(self._admit_seq, state.admit_seq)
        summary = {"resumed": len(state.requests),
                   "finished": len(state.finished),
                   "records": state.records,
                   "torn_bytes": state.torn_bytes,
                   "next_req_id": state.next_req_id}
        if self.tracer.enabled:
            self.tracer.emit("recover", self.iteration, path=str(path),
                             **summary)
        log.info("restored %d unfinished request(s) from %s (%d already "
                 "finished, %d torn byte(s) discarded)", summary["resumed"],
                 path, summary["finished"], summary["torn_bytes"])
        return summary

    # ------------------------------------------------------------- internals
    @property
    def _speculating(self) -> bool:
        return self.spec_len > 1 and self.draft_cfg is not None

    @property
    def _writes_files(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def _mesh_scope(self):
        """The rules and mesh every model program of this engine runs
        under (nothing on one device)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return axis_rules(self.rules, self.mesh)

    def _model_copies(self) -> int:
        """Host copies made inside model programs so far: the MoE layers'
        count reads and a shared-card mesh's staged collectives."""
        return M.host_copies() + (self.mesh.staged_copies
                                  if self.mesh is not None else 0)

    def _per_forward(self, cfg, cache) -> int:
        """Host copies of one forward of `cfg`: one per MoE layer, and one
        per collective where the mesh stages them through the host."""
        n = host_copies_per_forward(cfg)
        if self.mesh is not None and self.mesh.staged:
            with self._mesh_scope():
                n += collectives_per_forward(cfg, cache, self.attn_pim)
        return n

    @property
    def transfer_budget(self) -> int:
        """Device->host copies of a steady decode iteration: the one fetch
        (and, on a shared-card mesh whose data axis splits the batch, the
        staged copy of its gather over "data"), and per forward (the
        target's, and the draft's spec_len when speculating) one per MoE
        layer (`models.moe`) and one per collective that a shared-card
        mesh stages through the host."""
        n = 1 + int(self._data_split and self.mesh.staged)
        n += self._per_forward(self.cfg, self.cache)
        if self._speculating:
            n += self.spec_len * self._per_forward(self.draft_cfg,
                                                   self.draft_cache)
        return n

    def _clamp_spec_window_dense(self, tlp: int) -> int:
        """Dense slab: admission kept ``prompt + budget + old window <=
        capacity`` per live slot, so the widest window every live slot can
        hold is its remaining headroom."""
        want = max(tlp, 1)
        for s in self.active_slots:
            headroom = (self.capacity - int(self.slot_prompt[s])
                        - int(self.slot_budget[s]))
            want = min(want, max(headroom, 1))
        return want if want != max(tlp, 1) else tlp

    def _rebudget_spec_window(self, tlp: int) -> int:
        """Pages: move the live slots' reservations from the old window to
        `tlp`'s, and return the (possibly clamped) window every live slot
        can hold within the free pool and the block-table width."""
        old_win = max(self.spec_len, 1)
        live = self.active_slots

        def budget(s: int, win: int) -> int:
            base = int(self.slot_prompt[s]) + int(self.slot_budget[s])
            return self.kv.pages_for(base + win)

        def delta(s: int, new_win: int) -> int:
            return budget(s, new_win) - budget(s, old_win)

        want = max(tlp, 1)
        while want > old_win and (
                sum(delta(s, want) for s in live) > self.kv.alloc.available
                or any(budget(s, want) > self.kv.max_blocks for s in live)):
            want -= 1
        for s in live:
            self.kv.alloc.reserve_more(s, delta(s, want))
        return want if want != max(tlp, 1) else tlp

    def _fetch(self, *tensors: torch.Tensor):
        """The engine's one counted device->host copy: int tensors are
        flattened into one buffer, copied once, and split on the host.
        The copy drains the stream, so the tracer's card timings of the
        programs before it resolve here without another sync.

        Under a split batch each tensor holds this data group's slots
        (dim 0), or is a 0-d flag: the buffer is gathered over "data" on
        the device first, in rank order (slot order), and the host joins
        each tensor's rows and ORs each flag, so every rank reads the whole
        batch's values."""
        self.host_transfers += 1
        flat = torch.cat([t.reshape(-1).to(torch.int32) for t in tensors])
        groups = 1
        if self._data_split:
            groups = self.mesh.shape["data"]
            flat = self.mesh.all_gather(flat, "data")
        with self._allowed():
            host = flat.cpu().numpy()
        if self.debug_invariants and self.mesh is not None:
            if any(not np.array_equal(host, other)
                   for other in self.mesh.host_gather(host)):
                raise RuntimeError(
                    f"ranks of the mesh disagree on the fetched tokens at "
                    f"iteration {self.iteration}")
        if self.tracer.enabled:
            self.tracer.resolve()
        parts, out, at = host.reshape(groups, -1), [], 0
        for t in tensors:
            got = parts[:, at:at + t.numel()]
            at += t.numel()
            if t.dim() == 0:
                out.append(got.max().reshape(()))
            else:
                out.append(got.reshape((groups * t.shape[0],)
                                       + tuple(t.shape[1:])))
        return out[0] if len(out) == 1 else out

    def _slot_pos(self, s: int) -> int:
        """Device cache position of live slot s (KV rows written): the
        first output token's KV is written by the next decode step."""
        return int(self.slot_prompt[s]) + len(self.slot_tokens[s]) - 1

    def _sync_tables(self) -> None:
        """Point the paged cache at the current block tables: an identity
        check on the no-change path, a host->device copy after a row
        changed, never a device->host one."""
        if self.kv is not None:
            with self._allowed():
                tables = self.kv.tables.device(self.device, self._rows)
            for cache in (self.cache, self.draft_cache):
                if cache is not None:
                    cache["block_tables"] = tables

    def _attn_scope(self):
        return attn_impl("pim" if self.attn_pim else "xla")

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """An upload (host->device; never counted as a transfer)."""
        with self._allowed():
            return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _rows_to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Upload this data group's rows of a per-slot host array."""
        return self._to_device(arr[self._rows])

    def _allowed(self):
        """The sanitizer's allow-scope for a sanctioned copy: the one
        counted fetch, and the uploads, which PyTorch's sync check also
        flags (see `debug.sanitize`)."""
        if self._sanitizer is None:
            return contextlib.nullcontext()
        return self._sanitizer.allow_transfers()

    def _call(self, key: tuple, fn, *args):
        """Run one model program under its program key (the reference's
        jit-cache key, ``pim_interpret`` None).  Traced, the tracer times
        it (`serving.telemetry`); untraced it is the bare call."""
        if self._sanitizer is not None:
            self._sanitizer.note_program(key)
        if self.tracer.enabled:
            return self._timed_call(key, fn, *args)
        return fn(*args)

    def _decode_key(self, kind: str, tlp: int) -> tuple:
        return (kind, tlp, self.scheduler.fc_assignment, None,
                self.attn_pim)

    def _wave_key(self, kind: str) -> tuple:
        """Prefill, chunk and wave programs run under the ambient FC
        variant (admission's is "pu"), which keys them."""
        return (kind, current_fc_variant(), None, self.attn_pim)

    def _now(self) -> float:
        return time.monotonic()

    def _mark_admitted(self, slot: int, req) -> None:
        """Admission order (preemption takes the youngest) and the first
        admission's stamps."""
        self._admit_seq += 1
        self.slot_seq[slot] = self._admit_seq
        self.admit_iteration.setdefault(req.req_id, self.iteration)
        self._admit_t.setdefault(req.req_id, self._now())
        if self.journal is not None:
            # the admission-CLAMPED budget: a re-admission after recovery
            # clamps the same way, so replay must see the effective value
            self.journal.append("admit", req_id=req.req_id, slot=slot,
                                budget=int(self.slot_budget[slot]),
                                it=self.iteration)
        if self.tracer.enabled:
            self.tracer.emit("admit", self.iteration, req_id=req.req_id,
                             slot=slot, prompt_len=len(req.prompt))

    def _note_first_token(self, req_id: int) -> None:
        """The TTFT stamp: the request's first output token exists now."""
        if req_id not in self._first_tok_t:
            self._first_tok_t[req_id] = self._now()
            self.first_token_iteration.setdefault(req_id, self.iteration)
            if self.tracer.enabled:
                self.tracer.emit("first_token", self.iteration,
                                 req_id=req_id)

    def _latency_fields(self, req_id: int, n_tokens: int) -> dict:
        """The result's latencies; a phase that never happened is None,
        and so is TPOT below two tokens (no gap exists)."""
        now = self._now()
        t0, i0 = self._submit_t.get(req_id), self.submit_iteration.get(req_id)
        ta, ia = self._admit_t.get(req_id), self.admit_iteration.get(req_id)
        tf = self._first_tok_t.get(req_id)
        i_f = self.first_token_iteration.get(req_id)
        return dict(
            queue_delay_s=(ta - t0) if (t0 is not None and ta is not None)
            else None,
            ttft_s=(tf - t0) if (t0 is not None and tf is not None) else None,
            tpot_s=(((now - tf) / (n_tokens - 1)) if n_tokens > 1 else None)
            if tf is not None else None,
            queue_delay_iters=(ia - i0)
            if (i0 is not None and ia is not None) else None,
            ttft_iters=(i_f - i0)
            if (i0 is not None and i_f is not None) else None,
        )

    def _emit(self, req, tokens: Sequence[int], reason: str,
              slot: int | None = None) -> None:
        """Append the caller's result for `req`; a `_ResumedRequest`'s
        prompt carries its own earlier output, which is put back in front
        of the tokens.  The journal's finish record (the tail since the
        last commit) goes down BEFORE the result exists, so a durable
        consumer sees every finish exactly once across a crash."""
        if isinstance(req, _ResumedRequest):
            toks, plen = req.done + list(tokens), req.orig_prompt_len
        else:
            toks, plen = list(tokens), len(req.prompt)
        if self.journal is not None:
            prev = self._journal_done.pop(req.req_id, 0)
            self.journal.append("finish", req_id=req.req_id, reason=reason,
                                toks=toks[prev:], n=len(toks),
                                it=self.iteration)
        self.results.append(ServeResult(
            req.req_id, toks, plen, self.iteration, reason,
            **self._latency_fields(req.req_id, len(toks))))
        if self.tracer.enabled:
            self.tracer.emit("finish", self.iteration, req_id=req.req_id,
                             reason=reason, tokens=len(toks), slot=slot)
        if reason not in ("eos", "length"):
            log.info("request %d finished: %s (%d tokens)", req.req_id,
                     reason, len(toks))

    def _finish_slot(self, s: int, reason: str) -> None:
        """Finish live slot `s`: emit its tokens so far, free the slot and
        drain its pages."""
        self._emit(self.slot_req[s], self.slot_tokens[s], reason, slot=s)
        self._free_slot(s)

    def _free_slot(self, s: int) -> None:
        self.slot_req[s] = None
        self.slot_tokens[s] = []
        self.slot_last[s] = 0
        if self.kv is not None:
            self.kv.release(s)

    def _deadline_expired(self, req) -> bool:
        dl = req.deadline_s
        if dl is None:
            return False
        t0 = self._submit_t.get(req.req_id)
        return t0 is not None and self._now() - t0 > dl

    def _expire_deadlines(self) -> None:
        """Finish expired requests, queued then live; under a mesh every
        rank takes the OR of the ranks' verdicts (their clocks differ)."""
        live = self.active_slots
        reqs = self.queue + [self.slot_req[s] for s in live]
        expired = np.array([self._deadline_expired(r) for r in reqs], bool)
        if self.mesh is not None and any(r.deadline_s is not None
                                         for r in reqs):
            expired = self.mesh.host_any(expired)
        queued = expired[:len(self.queue)]
        if queued.any():
            for req, gone in zip(self.queue, queued):
                if gone:
                    self._emit(req, [], "timeout")
            self.queue = [r for r, gone in zip(self.queue, queued)
                          if not gone]
        for s, gone in zip(live, expired[len(queued):]):
            if gone:
                self._finish_slot(s, "timeout")

    def _age_deferral(self) -> None:
        """Iterations in a row the SAME queue head was deferred by the pool
        (or an injected admission fault); a wait for a slot does not
        count."""
        if self._deferred_head is None:
            self._defer_age = 0
            self._defer_head = None
        elif self._deferred_head != self._defer_head:
            self._defer_head = self._deferred_head
            self._defer_age = 1
        else:
            self._defer_age += 1
        if self._deferred_head is not None:
            if self.tracer.enabled:
                self.tracer.emit("defer", self.iteration,
                                 req_id=self._deferred_head,
                                 age=self._defer_age)
            log.debug("queue head %d deferred by the pool (age %d)",
                      self._deferred_head, self._defer_age)

    def _should_preempt(self) -> bool:
        """The head deferred `preempt_after` iterations in a row.  Dense
        admission never defers: preemption is paged only."""
        return (self.kv is not None and self.preempt_after is not None
                and self._defer_age >= self.preempt_after)

    def _preempt_one(self) -> bool:
        """Preempt the youngest in-flight request: free its pages and
        requeue it at the back as ``prompt + tokens so far``.  With one
        request in flight there is nothing younger: the head waits for it
        to finish."""
        live = sorted((self.slot_seq[s], s) for s in self.active_slots)
        if len(live) < 2:
            return False
        victim = live[-1][1]
        req = self.slot_req[victim]
        emitted = self.slot_tokens[victim]
        if isinstance(req, _ResumedRequest):
            done = req.done + list(emitted)
            base, plen = req.prompt[:req.orig_prompt_len], req.orig_prompt_len
        else:
            done, base, plen = list(emitted), list(req.prompt), len(req.prompt)
        self.queue.append(_ResumedRequest(
            req_id=req.req_id, prompt=base + done,
            max_new_tokens=int(self.slot_budget[victim]) - len(emitted),
            deadline_s=req.deadline_s, done=done, orig_prompt_len=plen))
        self._free_slot(victim)
        self.preemptions += 1
        self.preempted_ids.add(req.req_id)
        if self.journal is not None:
            self.journal.append("preempt", req_id=req.req_id,
                                done=len(done), it=self.iteration)
        if self.tracer.enabled:
            self.tracer.emit("preempt", self.iteration, req_id=req.req_id,
                             slot=victim, done=len(done))
        log.info("preempted request %d from slot %d (%d tokens done, "
                 "deferral age %d)", req.req_id, victim, len(done),
                 self._defer_age)
        return True

    def _snapshot(self) -> dict:
        """The state the structured errors carry."""
        snap = {
            "iteration": self.iteration,
            "queue": [r.req_id for r in self.queue],
            "deferred_head": self._defer_head,
            "deferral_age": self._defer_age,
            "active": {s: self.slot_req[s].req_id for s in self.active_slots},
            "slot_budget": {s: int(self.slot_budget[s])
                            for s in self.active_slots},
            "preemptions": self.preemptions,
            "degraded_steps": self.degraded_steps,
            "stalled_iterations": self._stalled,
        }
        if self.kv is not None:
            snap["pool"] = self.kv.alloc.snapshot()
        return snap

    def _watchdog(self, progress: bool) -> None:
        if progress:
            self._stalled = 0
            return
        self._stalled += 1
        if (self.stall_limit is not None
                and (self.queue or self.active_slots)
                and self._stalled >= self.stall_limit):
            snap = self._snapshot()
            # the snapshot rides the trace too, for a post-mortem that does
            # not depend on the exception reaching a logger
            if self.tracer.enabled:
                self.tracer.emit("stall", self.iteration, snapshot=snap)
            log.error("engine stalled for %d iterations at iteration %d "
                      "(queue=%s)", self._stalled, self.iteration,
                      snap["queue"])
            raise EngineStallError(
                f"engine made no progress for {self._stalled} consecutive "
                f"iterations at iteration {self.iteration} "
                f"(queue={snap['queue']}, deferral_age={self._defer_age}, "
                f"pool={snap.get('pool')})", snap)

    def _check_invariants(self) -> None:
        if not (self.debug_invariants and self.kv is not None):
            return
        try:
            self.kv.alloc.check()
        except AssertionError as err:
            raise AllocatorInvariantError(
                f"page-pool invariant violated at iteration "
                f"{self.iteration}: {err}", self._snapshot()) from err

    def _admit(self) -> int:
        """Fill free slots from the queue, one batched prefill per wave; a
        request that finishes at admission (first token <eos>, or a
        1-token budget) frees its slot for the next wave of this step.  An
        injected admission fault defers the whole wave, as the pool would."""
        self._deferred_head = None
        if (self.queue and self.faults is not None
                and self.faults.admission_blocked(self.iteration)):
            self._deferred_head = self.queue[0].req_id
            if self.tracer.enabled:
                self.tracer.emit("fault", self.iteration, fault="admit",
                                 req_id=self._deferred_head)
            return 0
        admitted = 0
        while True:
            wave_admitted, instant_finish = self._admit_wave()
            admitted += wave_admitted
            if not (instant_finish and self.queue):
                return admitted

    def _admit_wave(self) -> tuple[int, bool]:
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        batch_rows: list[tuple[int, ServeRequest]] = []
        window = max(self.spec_len, 1)
        while self.queue and free:
            req = self.queue[0]
            p = len(req.prompt)        # the FULL prompt — never truncated
            if p > self.prefill_len and not self._can_chunk:
                # SSM/hybrid state cannot mask the garbage tail of a chunk
                # window: reject instead of dropping the prompt head
                self._emit(self.queue.pop(0), [], "rejected")
                continue
            # a slot holds prompt + budget + a full decode window past the
            # last new token (the verify writes `window` rows)
            room = (self.kv.max_context if self.kv is not None
                    else self.capacity) - p - window
            if room < 1:
                # it cannot hold the prompt and one token: reject honestly
                # instead of truncating
                self._emit(self.queue.pop(0), [], "rejected")
                continue
            budget = max(1, min(req.max_new_tokens, room))
            if self.kv is not None and not self.kv.can_admit(
                    p + budget + window):
                # pool busy: defer, keep the order; step() ages the
                # deferral and preempts past `preempt_after`
                self._deferred_head = req.req_id
                break
            self.queue.pop(0)
            slot = free.pop(0)
            if self.kv is not None:
                # the prompt's pages are mapped now, the rest of the budget
                # reserved and mapped as decoding grows; serve() maps only
                # chunk 0's and lets each later wave map its own chunk
                initial = min(p, self.prefill_len) if self.stream_chunks else p
                self.kv.admit(slot, p + budget + window, initial)
            self.slot_budget[slot] = budget
            self._mark_admitted(slot, req)
            batch_rows.append((slot, req))
        if not batch_rows:
            return 0, False

        # chunk 0: the fixed-shape batched prefill (positions 0..P-1) over
        # this data group's rows; a split batch puts each admitted prompt
        # at its slot's row, so a group prefills its own slots only
        lo, hi = self._rows.start, self._rows.stop
        tokens = np.zeros((hi - lo, self.prefill_len), np.int32)
        lens = np.ones(hi - lo, np.int32)
        src = np.full(hi - lo, -1, np.int32)
        for row, (slot, req) in enumerate(batch_rows):
            self.slot_prompt[slot] = len(req.prompt)
            if self._data_split:
                if not lo <= slot < hi:
                    continue
                row = slot - lo
            p0 = min(len(req.prompt), self.prefill_len)
            tokens[row, :p0] = req.prompt[:p0]
            lens[row] = p0
            src[slot - lo] = row
        batch = {"tokens": self._to_device(tokens),
                 "prompt_lens": self._to_device(lens)}
        src_dev = self._to_device(src)
        self._sync_tables()    # paged: the admitted rows just mapped pages
        to_cache = prefill_to_pages if self.kv is not None else prefill_to_slots
        with self._attn_scope():
            first, self.cache = self._call(
                self._wave_key("main"), to_cache, self.cfg, self.params,
                batch, self.cache, src_dev)
            if self.draft_cfg is not None:
                _, self.draft_cache = self._call(
                    self._wave_key("draft"), to_cache, self.draft_cfg,
                    self.draft_params, batch, self.draft_cache, src_dev)
            admitted = 0
            if self.stream_chunks:
                # serve(): a prompt longer than the window enters its slot
                # mid-prefill and counts toward RLP now; later iterations
                # advance it a chunk at a time beside the decodes.  Short
                # prompts finish admission here, as offline.
                for slot, req in batch_rows:
                    if len(req.prompt) > self.prefill_len:
                        self.slot_req[slot] = req
                        self.slot_tokens[slot] = []
                        self.slot_offset[slot] = self.prefill_len
                        admitted += 1
                batch_rows = [(slot, req) for slot, req in batch_rows
                              if len(req.prompt) <= self.prefill_len]
                if not batch_rows:
                    return admitted, False
                first_h = np.array(self._fetch(first))
            else:
                first_h = self._admission_chunks(batch_rows, first)

        for slot, req in batch_rows:
            self.slot_req[slot] = req
            self.slot_offset[slot] = len(req.prompt)
        finished = self._finalize_first_tokens(
            [slot for slot, _ in batch_rows], first_h)
        # the slots still live count toward RLP
        return admitted + len(batch_rows) - finished, finished > 0

    def _admission_chunks(self, batch_rows, first: torch.Tensor
                          ) -> np.ndarray:
        """Offline admission's chunks 1..: every wave advances each pending
        slot by one (ragged-tail-masked) window; nothing host-side depends
        on a wave's result, so all waves run back to back and admission ends
        in ONE device->host copy.  Returns the first tokens by slot."""
        pending = {slot: req for slot, req in batch_rows
                   if len(req.prompt) > self.prefill_len}
        offs = {slot: self.prefill_len for slot in pending}
        wave_finals: list[tuple[torch.Tensor, list[int]]] = []
        while pending:
            ctoks = np.zeros((self.max_slots, self.prefill_len), np.int32)
            clens = np.zeros(self.max_slots, np.int32)
            final: list[int] = []
            for slot, req in list(pending.items()):
                n = min(len(req.prompt) - offs[slot], self.prefill_len)
                ctoks[slot, :n] = req.prompt[offs[slot]:offs[slot] + n]
                clens[slot] = n
                offs[slot] += n
                if offs[slot] == len(req.prompt):
                    final.append(slot)
                    del pending[slot]
            ct, cl = self._rows_to_device(ctoks), self._rows_to_device(clens)
            nxt, self.cache = self._call(
                self._wave_key("chunk_main"), prefill_chunk, self.cfg,
                self.params, self.cache, ct, cl)
            if self.draft_cfg is not None:
                # the draft's KV covers the same prompt positions
                _, self.draft_cache = self._call(
                    self._wave_key("chunk_draft"), prefill_chunk,
                    self.draft_cfg, self.draft_params, self.draft_cache,
                    ct, cl)
            if final:
                wave_finals.append((nxt, final))
        got = self._fetch(first, *(nxt for nxt, _ in wave_finals))
        if not wave_finals:
            return np.array(got)
        first_h = np.array(got[0])
        for (_, final), nxt_h in zip(wave_finals, got[1:]):
            for slot in final:
                first_h[slot] = int(nxt_h[slot])
        return first_h

    # ------------------------------------------------------ serve() waves
    def _prefilling_slots(self) -> list[int]:
        return [s for s in self.active_slots
                if int(self.slot_offset[s]) < int(self.slot_prompt[s])]

    def _tokens_written(self, s: int) -> int:
        """KV rows live slot `s` holds: the chunk frontier while
        mid-prefill, the decode position after."""
        off = int(self.slot_offset[s])
        return off if off < int(self.slot_prompt[s]) else self._slot_pos(s)

    def _wave_rows(self, prefilling: list[int]):
        """One chunk wave over the mid-prefill slots, each advanced by one
        window from its offset: (tokens, lens, pin mask, pin positions, the
        slots whose prompt it completes)."""
        ctoks = np.zeros((self.max_slots, self.prefill_len), np.int32)
        clens = np.zeros(self.max_slots, np.int32)
        pin = np.zeros(self.max_slots, bool)
        pin_pos = np.zeros(self.max_slots, np.int32)
        finals: list[int] = []
        for s in prefilling:
            req = self.slot_req[s]
            off, plen = int(self.slot_offset[s]), int(self.slot_prompt[s])
            n = min(plen - off, self.prefill_len)
            ctoks[s, :n] = req.prompt[off:off + n]
            clens[s] = n
            pin[s] = True
            pin_pos[s] = off
            if off + n == plen:
                finals.append(s)
        return ctoks, clens, pin, pin_pos, finals

    def _finalize_first_tokens(self, finals: list[int],
                               nxt_h: np.ndarray) -> int:
        """These live slots' prompts are complete: commit each first token,
        and finish at once on <eos> or a 1-token budget, which frees the
        slot for the next admission.  Returns how many finished."""
        finished = 0
        for s in finals:
            tok = int(nxt_h[s])
            self._note_first_token(self.slot_req[s].req_id)
            self.slot_tokens[s] = [tok]
            self.slot_last[s] = tok
            if tok == self.eos_token or self.slot_budget[s] <= 1:
                self._finish_slot(
                    s, "eos" if tok == self.eos_token else "length")
                finished += 1
        return finished

    def _ensure_wave_pages(self, prefilling: list[int],
                           clens: np.ndarray) -> None:
        """Map the pages this wave's chunks write; cannot fail, admission
        reserved the whole prompt, budget and window."""
        if self.kv is not None:
            for s in prefilling:
                self.kv.ensure(s, int(self.slot_offset[s]) + int(clens[s]))

    def _chunk_wave(self, prefilling: list[int]) -> None:
        """Speculative serve: the chunks run as a wave of their own, under
        the ambient FC variant as offline admission's chunks do, and the
        decodes take the fused speculative iteration after it.  One fetch,
        only when the wave completes a prompt."""
        ctoks, clens, pin, pin_pos, finals = self._wave_rows(prefilling)
        self._ensure_wave_pages(prefilling, clens)
        self._sync_tables()
        ct, cl, pm, pp = map(self._rows_to_device,
                             (ctoks, clens, pin, pin_pos))
        with self._attn_scope():
            nxt, _, self.cache = self._call(
                self._wave_key("wave_main"), _guarded_wave, self.cfg,
                self.params, self.cache, ct, cl, pm, pp, FAULT_NONE)
            if self.draft_cfg is not None:
                _, self.draft_cache = self._call(
                    self._wave_key("wave_draft"), mixed_step, self.draft_cfg,
                    self.draft_params, self.draft_cache, ct, cl, pm, pp)
        for s in prefilling:
            self.slot_offset[s] += int(clens[s])
        if finals:
            self._finalize_first_tokens(finals, np.asarray(self._fetch(nxt)))

    def _mixed_wave_iteration(self, prefilling: list[int],
                              decoding: list[int]
                              ) -> tuple[np.ndarray, np.ndarray]:
        """The TLP = 1 serve iteration: the decodes (chunks of length 1
        holding each slot's last token) and the prefill chunks in ONE
        `mixed_step` under the scheduler's FC variant, and one fetch of the
        tokens and the guard's flag.  A poisoned wave is re-run
        (`_degraded_wave`); the draft's chunk rows are kept, as in the
        reference.  Returns `_decode_all`'s (tokens, accepted)."""
        ctoks, clens, pin, pin_pos, finals = self._wave_rows(prefilling)
        chunk_lens = clens.copy()        # the prefill rows only, for the draft
        for s in decoding:
            ctoks[s, 0] = self.slot_last[s]
            clens[s] = 1
        self._ensure_wave_pages(prefilling, chunk_lens)
        if self.kv is not None:
            for s in decoding:
                self.kv.ensure(s, self._slot_pos(s) + 1)
        self._sync_tables()
        ct, cl, pm, pp = map(self._rows_to_device,
                             (ctoks, clens, pin, pin_pos))
        pre = dict(self.cache)
        code = self._fault_code()
        with fc_variant(self.scheduler.fc_assignment), self._attn_scope():
            nxt, bad, self.cache = self._call(
                self._wave_key("wave_main"), _guarded_wave, self.cfg,
                self.params, self.cache, ct, cl, pm, pp, code)
            if self.draft_cfg is not None and prefilling:
                # the draft's KV covers the prompt positions (the TLP = 1
                # decodes never advance the draft)
                _, self.draft_cache = self._call(
                    self._wave_key("wave_draft"), mixed_step, self.draft_cfg,
                    self.draft_params, self.draft_cache, ct,
                    self._rows_to_device(chunk_lens), pm, pp)
        out_h, bad_h = self._fetch(nxt, bad)
        if bad_h:
            out_h = self._degraded_wave(pre, ct, cl, pm, pp)
        out_h = np.asarray(out_h)
        for s in prefilling:
            self.slot_offset[s] += int(chunk_lens[s])
        self._finalize_first_tokens(finals, out_h)
        return out_h[:, None].astype(np.int32), np.ones(self.max_slots)

    def _degraded_wave(self, pre: dict, ct, cl, pm, pp) -> np.ndarray:
        """Re-run a poisoned mixed wave from the pre-wave cache entries,
        never injected (`_rerun_scope`)."""
        self._note_degraded("wave")
        self.cache = pre
        with self._rerun_scope():
            nxt, bad, self.cache = self._call(
                ("oracle_wave",), _guarded_wave, self.cfg, self.params,
                self.cache, ct, cl, pm, pp, FAULT_NONE)
            return self._rerun_tokens(nxt, bad)

    def _fault_code(self) -> int:
        """This iteration's logits fault; none under ``fused=False``, whose
        host loop takes no guard."""
        if self.faults is None or not self.fused:
            return FAULT_NONE
        code = self.faults.logits_fault(self.iteration)
        if code != FAULT_NONE and self.tracer.enabled:
            self.tracer.emit("fault", self.iteration,
                             fault="nan" if code == FAULT_NAN else "inf")
        return code

    def _note_degraded(self, mode: str) -> None:
        self.degraded_steps += 1
        self._degraded_this_step = True
        if self.tracer.enabled:
            self.tracer.emit("degraded", self.iteration, mode=mode)
        what = "the step" if mode == "step" else "the mixed wave"
        log.warning("non-finite logits at iteration %d: re-running %s",
                    self.iteration, what)

    @contextlib.contextmanager
    def _rerun_scope(self):
        """The paths of a degraded re-run: the reference's plain path ("pu"
        FC, plain attention) where the wrappers take their plain versions
        anyway (CPU tensors); on the card the engine's own, because a CUDA
        tensor goes to its kernel or raises."""
        if self.device.type == "cpu":
            with attn_impl("xla"), fc_variant("pu"):
                yield
        else:
            with fc_variant(self.scheduler.fc_assignment), self._attn_scope():
                yield

    def _rerun_tokens(self, nxt: torch.Tensor, bad: torch.Tensor
                      ) -> np.ndarray:
        """The re-run's tokens, fetched with its own guard flag in one
        copy: logits that are non-finite with no fault injected come from
        the path itself, and raise."""
        nxt_h, bad_h = self._fetch(nxt, bad)
        if bad_h:
            raise RuntimeError(
                f"non-finite logits at iteration {self.iteration} again on "
                "the re-run, with no fault injected: a fault of the FC or "
                "attention path")
        return np.asarray(nxt_h)

    def _pre_step(self) -> tuple[dict, dict | None]:
        """The caches' entries before a guarded step: what `_degraded_step`
        puts back (see the module docstring)."""
        return dict(self.cache), (dict(self.draft_cache)
                                  if self.draft_cache is not None else None)

    def _degraded_step(self, pre: tuple[dict, dict | None]
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Re-run a poisoned decode iteration from the pre-step cache
        entries, never injected (`_rerun_scope`), as one plain step: when
        speculating, the draft advances one plain step too, so the two
        caches stay in step."""
        self._note_degraded("step")
        self.cache, self.draft_cache = pre
        last = self._rows_to_device(self.slot_last)[:, None]
        with self._rerun_scope():
            logits, self.cache = self._call(
                ("oracle", "main"), decode_step, self.cfg, self.params,
                self.cache, last)
            if self._speculating:
                _, self.draft_cache = self._call(
                    ("oracle", "draft"), decode_step, self.draft_cfg,
                    self.draft_params, self.draft_cache, last)
            nxt = self._rerun_tokens(greedy(logits[:, -1]),
                                     _nonfinite(logits))
        return nxt[:, None].astype(np.int32), np.ones(self.max_slots)

    def _decode_all(self) -> tuple[np.ndarray, np.ndarray]:
        """One decoding iteration for all slots, under the scheduler's FC
        variant.  Returns (tokens [slots, <= spec_len], accepted [slots])."""
        with fc_variant(self.scheduler.fc_assignment), self._attn_scope():
            if not self._speculating:
                # the fused plain step: decode_step + greedy on the device,
                # then the iteration's single host fetch (with the guard's
                # flag; ``fused=False`` takes no guard, as the reference)
                last = self._rows_to_device(self.slot_last)
                if not self.fused:
                    logits, self.cache = self._call(
                        self._decode_key("plain", 1), decode_step, self.cfg,
                        self.params, self.cache, last[:, None])
                    nxt_h = np.asarray(self._fetch(greedy(logits[:, -1])))
                    return nxt_h[:, None], np.ones(self.max_slots)
                pre = self._pre_step()
                code = self._fault_code()
                nxt, bad, self.cache = self._call(
                    self._decode_key("plain_fused", 1), _plain_step,
                    self.cfg, self.params, self.cache, last, code)
                nxt_h, bad_h = self._fetch(nxt, bad)
                if bad_h:
                    return self._degraded_step(pre)
                return np.asarray(nxt_h)[:, None], np.ones(self.max_slots)
            if self.fused:
                return self._speculative_iteration_fused()
            return self._speculative_iteration_host()

    def _rewind(self, accepted: torch.Tensor, steps, draft_steps) -> None:
        """The target advanced k for every slot: rewind it to the accepted
        prefix, and the draft (k steps ahead) to the target.  The SSM state
        (`steps`, `draft_steps`: the per-token states the window's steps
        kept, or None) is each slot's after `accepted` tokens of the
        window, in both: the draft consumed exactly the window's tokens."""
        self.cache["pos"] = self.cache["pos"] - (self.spec_len - accepted)
        self.draft_cache["pos"] = torch.minimum(self.draft_cache["pos"],
                                                self.cache["pos"])
        rewind_ssm(self.cache, steps, accepted)
        rewind_ssm(self.draft_cache, draft_steps, accepted)

    def _speculative_iteration_fused(self) -> tuple[np.ndarray, np.ndarray]:
        """Draft, verify, accept and rewind on the device; the host fetches
        one (out, accepted, finished_eos, guard flag) bundle.  Poisoned
        verify logits put both caches back and degrade the iteration to
        one plain step."""
        last = self._rows_to_device(self.slot_last)
        pre = self._pre_step()
        code = self._fault_code()
        out_h, acc_h, _, bad_h = self._fetch(*self._call(
            self._decode_key("spec_fused", self.spec_len), self._spec_step,
            last, code))
        if bad_h:
            return self._degraded_step(pre)
        return out_h, acc_h.astype(np.float64)

    def _spec_step(self, last: torch.Tensor, code: int):
        """The fused speculative program; it advances both caches and
        returns the (out, accepted, finished_eos, guard flag) bundle."""
        k = self.spec_len
        # 1) the draft proposes autoregressively, k steps at t = 1: the
        # extra step writes the KV of the window's last token, so a full
        # accept leaves the two caches in step
        draft_steps = ssm_step_buffers(self.draft_cache, k)
        tok, props = last, []
        for j in range(k):
            logits, self.draft_cache = decode_step(
                self.draft_cfg, self.draft_params, self.draft_cache,
                tok[:, None], _step_slice(draft_steps, j))
            tok = greedy(logits[:, -1])
            props.append(tok)
        window = torch.stack([last] + props[:-1], dim=1)          # [slots, k]
        # 2) the target verifies the window in one decode step (TLP = k),
        # keeping its SSM state after each token
        steps = ssm_step_buffers(self.cache, k)
        logits, self.cache = decode_step(self.cfg, self.params, self.cache,
                                         window, steps)
        logits = _inject_fault(logits, code)
        # 3) accept the longest matching prefix, rewind both caches
        out, accepted = accept_speculative(window, greedy(logits))
        self._rewind(accepted, steps, draft_steps)
        in_window = (torch.arange(k, device=self.device)[None, :]
                     < accepted[:, None])
        finished_eos = ((out == self.eos_token) & in_window).any(dim=1)
        return out, accepted, finished_eos, _nonfinite(logits)

    def _speculative_iteration_host(self) -> tuple[np.ndarray, np.ndarray]:
        """The reference's host loop, the oracle of the fused iteration:
        one fetch per draft step, one for the verify, the accept on the
        host."""
        k = self.spec_len
        proposals = [self.slot_last.copy()]
        last = self._rows_to_device(self.slot_last)[:, None]
        draft_steps = ssm_step_buffers(self.draft_cache, k)
        for j in range(k):
            logits, self.draft_cache = self._call(
                self._decode_key("draft", 1), decode_step, self.draft_cfg,
                self.draft_params, self.draft_cache, last,
                _step_slice(draft_steps, j))
            nxt = greedy(logits[:, -1])
            proposals.append(np.asarray(self._fetch(nxt)))
            last = nxt[:, None]
        window = np.stack(proposals[:k], axis=1)                  # [slots, k]
        steps = ssm_step_buffers(self.cache, k)
        logits, self.cache = self._call(
            self._decode_key("verify", k), decode_step, self.cfg, self.params,
            self.cache, self._rows_to_device(window), steps)
        target = np.asarray(self._fetch(greedy(logits)))          # [slots, k]
        accepted = np.zeros(self.max_slots, np.int64)
        out = np.zeros((self.max_slots, k), np.int32)
        for s in range(self.max_slots):
            n = 0
            while n < k - 1 and window[s, n + 1] == target[s, n]:
                n += 1
            accepted[s] = n + 1                        # +1: the free token
            out[s, :n + 1] = target[s, :n + 1]
        self._rewind(self._rows_to_device(accepted.astype(np.int32)), steps,
                     draft_steps)
        return out, accepted.astype(np.float64)

    def step(self) -> None:
        if self._sanitizer is None:
            with self._mesh_scope():
                return self._step_impl()
        stats0 = len(self.stats)
        with self._sanitizer.scope(self), self._mesh_scope():
            self._step_impl()
        self._sanitizer.after_step(self, stepped=len(self.stats) > stats0)

    def sanitize_report(self):
        """The sanitizer's counters (`debug.sanitize.SanitizeReport`), or
        None when the engine was built without ``sanitize=True``."""
        return None if self._sanitizer is None else self._sanitizer.report

    def _trace_scheduler(self) -> None:
        """This iteration's scheduling decision with its inputs (the AI
        estimate and the α it was compared with), not just the verdict."""
        ev = self.scheduler.events[-1]
        self.tracer.emit("scheduler", self.iteration,
                         ai_estimate=ev.ai_estimate, alpha=ev.alpha,
                         assignment=ev.assignment, flipped=ev.rescheduled,
                         rlp=ev.rlp, tlp=ev.tlp)

    def _step_impl(self) -> None:
        t0 = time.perf_counter()
        transfers0, copies0 = self.host_transfers, self._model_copies()
        results0, preempted0 = len(self.results), self.preemptions
        self._degraded_this_step = False
        if self.tracer.enabled:
            # events below (the page manager's too) default to this step
            self.tracer.iteration = self.iteration
        if self.faults is not None and self.faults.crash_now(self.iteration):
            # a process death: no clean-up, no results, no journal
            # finalisation — what recovery must cope with
            if self.tracer.enabled:
                self.tracer.emit("fault", self.iteration, fault="crash")
            raise EngineCrashError(
                f"injected crash at iteration {self.iteration}",
                self.iteration)
        if self.faults is not None:
            delay = self.faults.step_delay(self.iteration)
            if delay > 0:
                if self.tracer.enabled:
                    self.tracer.emit("fault", self.iteration,
                                     fault="latency", delay_s=delay)
                time.sleep(delay)
        self._expire_deadlines()
        admitted = self._admit()
        self._age_deferral()
        if self._defer_age and self._should_preempt() and self._preempt_one():
            # pages freed: admit again at once, so that the head waits at
            # most `preempt_after` iterations
            admitted += self._admit()
            if self._deferred_head is None:
                self._defer_age = 0
        arrived, self._arrived_this_step = self._arrived_this_step, 0
        active = self.active_slots
        if not active:
            # still an iteration: counted, watched and checked
            self.host_transfers += self._model_copies() - copies0
            self.scheduler.observe_counts(0, admitted)
            if self.tracer.enabled:
                self._trace_scheduler()
            self.iteration += 1
            self._watchdog(admitted > 0 or len(self.results) > results0
                           or self.preemptions > preempted0)
            self._check_invariants()
            if self.tracer.enabled:
                self.tracer.span(
                    "iteration", t0,
                    fc_variant=self.scheduler.fc_assignment,
                    rlp=self.scheduler.rlp, tlp=self.scheduler.tlp,
                    ai_estimate=self.scheduler.ai_estimate, new_tokens=0,
                    degraded=0, decode_slots=0, prefill_slots=0,
                    queued=len(self.queue), arrivals=arrived,
                    transfers=self.host_transfers - transfers0, idle=True)
            return

        speculating = self._speculating
        prefilling = self._prefilling_slots() if self.stream_chunks else []
        if prefilling and not speculating:
            # serve() at TLP = 1: decodes and prefill chunks in ONE wave
            # (it maps its own pages)
            decoding = [s for s in active if s not in prefilling]
            out, accepted = self._mixed_wave_iteration(prefilling, decoding)
        else:
            if prefilling:
                # speculative serve(): advance the prefill frontier first,
                # so that a slot whose prompt completes now rides the
                # speculative iteration below, as after offline admission
                self._chunk_wave(prefilling)
            decoding = [s for s in self.active_slots
                        if int(self.slot_offset[s])
                        >= int(self.slot_prompt[s])]
            out = np.zeros((self.max_slots, 1), np.int32)
            accepted = np.zeros(self.max_slots)
            if decoding:
                if self.kv is not None:
                    # map the pages of the KV rows this iteration writes
                    # (positions pos..pos+tlp-1); cannot fail: admission
                    # reserved prompt + budget + window
                    tlp = self.spec_len if speculating else 1
                    for s in decoding:
                        self.kv.ensure(s, self._slot_pos(s) + tlp)
                    self._sync_tables()
                out, accepted = self._decode_all()

        # host-side bookkeeping: append up to `accepted` tokens per slot,
        # stopping at eos or at the budget
        finished = np.zeros(self.max_slots, bool)
        new_tokens = 0
        for s in decoding:
            req = self.slot_req[s]
            if req is None:      # finished at once by this iteration's wave
                continue
            n_acc = int(accepted[s])
            for j in range(n_acc):
                tok = int(out[s, j])
                self.slot_tokens[s].append(tok)
                new_tokens += 1
                if tok == self.eos_token or (
                        len(self.slot_tokens[s]) >= self.slot_budget[s]):
                    self._finish_slot(
                        s, "eos" if tok == self.eos_token else "length")
                    finished[s] = True
                    break
            else:
                self.slot_last[s] = self.slot_tokens[s][-1]
                if self.kv is not None and speculating and (
                        n_acc < self.spec_len):
                    # the rewind returned the position to the accepted
                    # prefix; pages past it hold only the rejected tail
                    self.kv.rewind(s, self._slot_pos(s))

        if self.journal is not None:
            self._journal_commits()

        # park inactive slots at pos = 1 in both caches so their garbage
        # decode never creeps past the capacity (fixed-shape mask, as the
        # reference)
        inactive = np.array([r is None for r in self.slot_req])
        if inactive.any():
            mask = self._rows_to_device(inactive)
            one = torch.ones((), dtype=torch.int32, device=self.device)
            for cache in (self.cache, self.draft_cache):
                if cache is not None:
                    cache["pos"] = torch.where(mask, one, cache["pos"])

        # the PAPI runtime scheduling step (§5.2.2)
        self.scheduler.observe_counts(finished, admitted)
        if self.tracer.enabled:
            self._trace_scheduler()
        self.iteration += 1
        self._watchdog(admitted > 0 or new_tokens > 0 or len(prefilling) > 0
                       or len(self.results) > results0
                       or self.preemptions > preempted0)
        self._check_invariants()
        self.host_transfers += self._model_copies() - copies0
        pool = {}
        if self.kv is not None:
            ps = self.kv.stats(sum(self._tokens_written(s)
                                   for s in self.active_slots))
            pool = dict(kv_pages_used=ps.mapped, kv_pages_free=ps.free,
                        kv_page_watermark=ps.watermark,
                        kv_fragmentation=ps.fragmentation)
        self.stats.append(IterStats(
            iteration=self.iteration,
            rlp=self.scheduler.rlp,
            tlp=self.scheduler.tlp,
            ai_estimate=self.scheduler.ai_estimate,
            fc_variant=self.scheduler.fc_assignment,
            new_tokens=new_tokens,
            wall_s=time.perf_counter() - t0,
            accepted=(float(np.mean(accepted[decoding])) if decoding
                      else 0.0),
            transfers=self.host_transfers - transfers0,
            admitted=admitted,
            preemptions=self.preemptions - preempted0,
            deferral_age=self._defer_age,
            degraded=int(self._degraded_this_step),
            arrivals=arrived,
            queued=len(self.queue),
            prefill_slots=len(prefilling),
            decode_slots=len(decoding),
            **pool,
        ))
        if self.tracer.enabled:
            if self.kv is not None:
                self.tracer.emit("pool", used=pool["kv_pages_used"],
                                 free=pool["kv_pages_free"],
                                 watermark=pool["kv_page_watermark"],
                                 fragmentation=pool["kv_fragmentation"])
            st = self.stats[-1]
            self.tracer.span(
                "iteration", t0, fc_variant=st.fc_variant, rlp=st.rlp,
                tlp=st.tlp, ai_estimate=st.ai_estimate,
                new_tokens=st.new_tokens, degraded=st.degraded,
                decode_slots=st.decode_slots,
                prefill_slots=st.prefill_slots, queued=st.queued,
                arrivals=st.arrivals, transfers=st.transfers)


__all__ = ["AllocatorInvariantError", "EngineCrashError", "EngineStallError",
           "IterStats", "PapiEngine", "ServeRequest", "ServeResult",
           "TokenEvent", "check_decoder"]
