"""Serving launcher of the port: the PAPI engine on a synthetic request
trace with random weights made from ``--seed``.

    python -m repro_torch.launch.serve --arch qwen2-0.5b --attn-pim \\
        [--kv paged --page-size 16]
    python -m repro_torch.launch.serve --arch zamba2-1.2b --attn-pim
    python -m repro_torch.launch.serve --arch mamba2-1.3b
    python -m repro_torch.launch.serve --arch mamba2-1.3b \\
        --spec-len 4 --draft-arch mamba2-1.3b
    python -m repro_torch.launch.serve --arch qwen2-0.5b --attn-pim \\
        --spec-len 4 --draft-arch qwen2-0.5b
    python -m repro_torch.launch.serve --arch olmoe-1b-7b --attn-pim

``--arch`` takes every assigned decoder: qwen2-0.5b, granite-8b,
command-r-plus-104b, deepseek-67b (dense), granite-moe-1b-a400m,
olmoe-1b-7b (MoE), qwen2-vl-7b (the VLM backbone, M-RoPE), mamba2-1.3b
(SSM) and zamba2-1.2b (hybrid), or ``<arch>-smoke`` for the reduced twin.
hubert-xlarge is encoder-only and refused, as the reference's engine
refuses it.

Requests follow `repro.launch.serve`: ``--requests`` draws from
`core.traces.generate_trace(--task)` (default general-qa, 16 requests),
the engine runs at capacity 256, prefill window 32 and α 6.0, and prompts
are capped at capacity − 64 − max(spec_len, 1) − 1 tokens (the output
cap and the speculative window) with budgets capped at 64, from the same
seed in the same order.  ``--capacity``, ``--prefill-len``,
``--max-prompt`` and ``--alpha`` override those.

``--spec-len k --draft-arch ARCH`` decodes speculatively (TLP = k) with a
draft of ARCH whose weights come from ``--seed + 1``, as in the reference;
the launcher then prints the mean tokens accepted per window.

``--arrivals RATE`` serves the same requests live through
`PapiEngine.serve`: they arrive on a seeded Poisson schedule (RATE
requests per iteration expected), drawn from the same generator after the
prompts, as `repro.launch.serve` draws it; long prompts prefill a chunk
per iteration beside the running decodes.  The launcher then prints each
request's queue delay, TTFT and TPOT and the p50 / p99 summary.

The failure model, as the reference's: ``--deadline S`` bounds every
request's wall clock from submit (an expired request finishes as
"timeout" with its tokens so far); ``--fault kind[:prob]`` (repeatable,
kinds admit / nan / kernel / latency / crash; ``--fault-seed``) injects the
reference's deterministic fault schedule, and the launcher then prints the
``resilience:`` line (preemptions, degraded steps, faults fired); an
injected crash ends the run with exit code 1.  ``--log-level`` wires the
``repro_torch.serving`` logger to stderr (deferral DEBUG, preemption and
unhappy finishes INFO, degraded steps WARNING, stalls ERROR).

Durability, as the reference's: ``--journal PATH`` write-ahead-journals
every submit / admission / token commit / preemption / cancel / finish
to PATH (checksummed records, a torn tail truncated on reopen), and
``--resume PATH`` starts the engine from the journal or snapshot a
crashed run left: every unfinished request re-admits as ``prompt +
committed tokens`` (deadlines keep their remaining budget, finished
requests never re-run) and the launcher serves those instead of a fresh
trace.  Crash a run with ``--journal wal.j --fault crash:0.05``, then
recover it with ``--journal wal.j --resume wal.j``.

Observability: ``--trace PATH`` records the engine's typed event trace
(`serving.telemetry`: iteration spans, scheduler decisions, per-program
timings — CUDA events on the card, wall clock on the CPU —, preemptions,
faults, pool samples) and writes it on exit as ``--trace-format chrome``
(Perfetto) or ``jsonl``; summarize it with ``tools/trace_report.py``.
``--metrics-out PATH`` writes the ``papi_engine_*`` Prometheus snapshot
(and turns tracing on).  ``--sanitize`` runs every step under the
sanitizer (`debug.sanitize`: PyTorch's sync-debug mode on the card, one
host transfer per steady iteration) and prints its report.

The SSM (mamba2) and hybrid (zamba2) families reject prompts longer than
``--prefill-len`` and refuse ``--kv paged``, as the reference does.  They
speculate on the dense slab (``--spec-len k --draft-arch
mamba2-1.3b|zamba2-1.2b``): a partial accept rewinds the SSM state to the
accepted prefix, so the streams equal the TLP = 1 streams.

Mesh serving (§5.3): ``--mesh DP,TP`` spawns DP x TP ranks
(`launch.mesh.spawn_world`), one process each (rank r at data r // TP,
model r % TP), and serves the same trace on every rank.  The tensor axis
splits the weights: FC-PIM banks, one Attn-PIM unit per KV-head shard
(``--attn-pim``; ``--kv paged`` always splits by KV head), the
vocab-split embedding, an MoE layer's experts, the Mamba2 heads and their
SSM state.  The data axis splits the slot batch (the
reference's "batch" rule): each data group holds and computes its own
``--max-slots / DP`` slots, and the tokens are gathered over it once an
iteration, so the scheduler still sees the whole batch.  Every rank
builds the full weights from ``--seed`` and keeps its block.  The
backend is gloo on the CPU, NCCL with a card per rank, and gloo through
host copies when the ranks share one card; rank 0 prints the usual lines
and the mesh line, and alone writes the journal, the trace and the
metrics.  Any DP and TP whose product is the world are served, on
every decoder family:

    python -m repro_torch.launch.serve --arch qwen2-0.5b --mesh 2,2 \
        [--attn-pim | --kv paged]
    python -m repro_torch.launch.serve --arch mamba2-1.3b --mesh 2,2
    python -m repro_torch.launch.serve --arch olmoe-1b-7b --mesh 1,2 \
        --attn-pim

Runs on the card (``--device cpu`` for the plain PyTorch path).  Prints
the per-iteration scheduler decisions — RLP, TLP, the AI estimate and the
chosen FC path — and, under ``--kv paged``, the page pool's watermark, as
`repro.launch.serve` does.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import logging
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.traces import generate_trace
from repro_torch.models import init_params
from repro_torch.serving import (EngineCrashError, PapiEngine, ServeRequest,
                                 Tracer, export_prometheus, latency_summary,
                                 parse_fault_specs, write_trace)
from repro_torch.launch.mesh import (make_serving_mesh, parse_mesh,
                                     spawn_world)
from repro_torch.serving.engine import check_decoder

# a mesh run's wall-clock limit (the world is killed past it)
MESH_TIMEOUT_S = 3600.0

# the generation budget's cap
MAX_NEW = 64


def default_max_prompt(capacity: int, spec_len: int = 1) -> int:
    """The reference's prompt cap: the slab less the output cap and the
    speculative window."""
    return capacity - MAX_NEW - max(spec_len, 1) - 1


def make_requests(task: str, n: int, vocab: int, seed: int,
                  max_prompt: int, rng: np.random.Generator | None = None,
                  deadline_s: float | None = None) -> list[ServeRequest]:
    """The reference launcher's requests: lengths from
    `generate_trace(task, n, seed)`, prompt tokens from one
    ``default_rng(seed)`` (or `rng`) drawn request by request, prompts
    capped at `max_prompt`, budgets at `MAX_NEW`, each with `deadline_s`."""
    rng = np.random.default_rng(seed) if rng is None else rng
    reqs = []
    for i, req in enumerate(generate_trace(task, n, seed)):
        prompt = rng.integers(3, vocab, size=min(req.input_len, max_prompt))
        reqs.append(ServeRequest(i, prompt.tolist(),
                                 max_new_tokens=min(req.output_len, MAX_NEW),
                                 deadline_s=deadline_s))
    return reqs


def arrival_schedule(reqs: list[ServeRequest], rate: float,
                     rng: np.random.Generator) -> list[list[ServeRequest]]:
    """The reference launcher's live schedule: request i arrives at
    iteration ``cumsum(floor(Exponential(1 / rate)))[i]``, the gaps drawn
    at once from `rng`; one list of arrivals per iteration."""
    if not reqs:
        return [[]]
    arrive = np.cumsum(np.floor(
        rng.exponential(1.0 / max(rate, 1e-9), len(reqs))).astype(int))
    sched: list[list[ServeRequest]] = [[] for _ in range(int(arrive[-1]) + 1)]
    for r, it in zip(reqs, arrive):
        sched[int(it)].append(r)
    return sched


def serve_live(eng: PapiEngine, sched, max_iterations: int = 2000) -> list:
    """Stream `sched` through `eng.serve`, printing each request's line as
    it finishes and then the latency percentiles."""
    results, streamed = [], 0
    for ev in eng.serve(sched, max_iterations=max_iterations):
        if not ev.finished:
            streamed += 1
            continue
        res = ev.result
        results.append(res)
        line = (f"req {res.req_id:3d}: {len(res.tokens):3d} tokens "
                f"({res.finished_reason}), queue {res.queue_delay_iters} "
                f"iters, ttft {res.ttft_iters} iters")
        if res.ttft_s is not None:
            line += f" / {res.ttft_s * 1e3:.0f}ms"
        if res.tpot_s is not None:
            line += f", tpot {res.tpot_s * 1e3:.1f}ms"
        print(line)
    summ = latency_summary(results)
    print(f"\nstreamed {streamed} tokens live over {summ['n']} requests; "
          "latency percentiles:")
    for field in ("queue_delay_iters", "ttft_iters", "ttft_s", "tpot_s"):
        st = summ[field]
        unit = "iters" if field.endswith("iters") else "s"
        print(f"  {field:17s} p50 {st['p50']:9.3f}  p99 {st['p99']:9.3f}  "
              f"({unit})")
    print()
    return results


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--task", default="general-qa",
                    help="request trace: general-qa or creative-writing")
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=256,
                    help="KV slab length per slot")
    ap.add_argument("--prefill-len", type=int, default=32,
                    help="prefill window; longer prompts are chunked")
    ap.add_argument("--max-prompt", type=int, default=None,
                    help="prompt cap; default capacity - 64 - "
                         "max(spec_len, 1) - 1")
    ap.add_argument("--alpha", type=float, default=6.0)
    ap.add_argument("--spec-len", type=int, default=1,
                    help="speculation length (TLP); above 1 with "
                         "--draft-arch")
    ap.add_argument("--draft-arch", default=None,
                    help="draft model for speculative decoding (weights "
                         "from --seed + 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attn-pim", action="store_true",
                    help="every decode-path attention through the Attn-PIM "
                         "kernel (plain decode and chunk waves)")
    ap.add_argument("--kv", choices=("dense", "paged"), default="dense",
                    help="KV-cache layout: 'dense' per-slot slabs, or "
                         "'paged' Attn-PIM bank-row pages with block tables "
                         "and page-budgeted admission (long contexts share "
                         "one pooled budget instead of uniform slots)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (--kv paged; one Attn-PIM "
                         "bank row)")
    ap.add_argument("--max-blocks", type=int, default=None,
                    help="block-table width (--kv paged): caps per-request "
                         "context at max_blocks*page_size tokens; default = "
                         "the whole pool")
    ap.add_argument("--arrivals", type=float, default=None, metavar="RATE",
                    help="serve the requests live through PapiEngine.serve "
                         "on a seeded Poisson schedule, RATE requests per "
                         "iteration expected; prints queue delay, TTFT and "
                         "TPOT per request and their p50 / p99")
    ap.add_argument("--deadline", type=float, default=None, metavar="SECONDS",
                    help="per-request wall-clock budget from submit(); an "
                         "expired request finishes as 'timeout' with its "
                         "tokens so far")
    ap.add_argument("--fault", action="append", default=[],
                    metavar="KIND[:PROB]",
                    help="inject a deterministic fault schedule "
                         "(repeatable): kinds admit / nan / kernel / latency "
                         "/ crash, per-iteration probability PROB (default "
                         "1.0), e.g. '--fault nan:0.2 --fault admit:0.5'")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the fault schedule (a pure function of "
                         "(seed, iteration))")
    ap.add_argument("--log-level", default=None,
                    metavar="DEBUG|INFO|WARNING|ERROR",
                    help="wire the 'repro_torch.serving' logger to stderr "
                         "at this level")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="write-ahead request journal: checksummed records "
                         "(submit/admit/token commit/finish/cancel/preempt) "
                         "appended to PATH, a torn tail truncated on "
                         "reopen; a crashed run recovers with --resume")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="re-admit every unfinished request of the journal "
                         "or engine snapshot at PATH (finished ones never "
                         "re-run; deadlines keep their remaining budget) "
                         "and serve them instead of a fresh trace")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record the engine's typed event trace and write "
                         "it to PATH on exit (summarize with "
                         "tools/trace_report.py)")
    ap.add_argument("--trace-format", choices=("chrome", "jsonl"),
                    default="chrome",
                    help="trace serialization: 'chrome' opens in Perfetto, "
                         "'jsonl' is the raw typed events")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a Prometheus snapshot of the papi_engine_* "
                         "counters and gauges on exit (implies tracing)")
    ap.add_argument("--sanitize", action="store_true",
                    help="run under the host-sync sanitizer: sync-debug "
                         "mode 'error' around every step on the card, and "
                         "exactly the engine's transfer budget per steady "
                         "iteration (one, plus one per MoE layer of each "
                         "forward)")
    ap.add_argument("--mesh", default=None, metavar="DP,TP",
                    help="serve on DP x TP ranks: the slot batch split "
                         "over the DP (data) axis, the weights over the TP "
                         "(tensor) axis, e.g. '2,2'; MoE, SSM and hybrid "
                         "models take TP = 1")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    check_decoder(cfg)     # before building weights the engine would refuse
    if args.mesh:
        dp, tp = parse_mesh(args.mesh)
        codes = spawn_world(_serve_rank, dp * tp, device=device.type,
                            timeout_s=MESH_TIMEOUT_S,
                            args=(argv, dp, tp), threads=2)
        code = max(codes)
    else:
        code = _serve(args, device)
    if code:
        raise SystemExit(code)


def _serve_rank(rank: int, device: torch.device, argv, dp: int,
                tp: int) -> int:
    """One rank of ``--mesh``: the whole launcher over this rank's block of
    the weights; rank 0 prints, the others run silent."""
    args = _parser().parse_args(argv)
    mesh = make_serving_mesh(dp, tp, device=device)
    quiet = (contextlib.redirect_stdout(io.StringIO()) if rank
             else contextlib.nullcontext())
    with quiet:
        return _serve(args, device, mesh)


def _build_engine(args, cfg, device, mesh, tracer) -> PapiEngine:
    """The engine over weights made from the seed; under a mesh it keeps
    this rank's block of them and the full weights go out of scope."""
    gen = torch.Generator(device=device).manual_seed(args.seed)
    draft = None
    if args.draft_arch:
        dcfg = get_config(args.draft_arch)
        dgen = torch.Generator(device=device).manual_seed(args.seed + 1)
        draft = (dcfg, init_params(dcfg, dgen))
    return PapiEngine(cfg, init_params(cfg, gen), max_slots=args.max_slots,
                     cache_capacity=args.capacity,
                     prefill_len=args.prefill_len, alpha=args.alpha,
                     spec_len=args.spec_len, draft=draft,
                     attn_pim=args.attn_pim, kv_layout=args.kv,
                     page_size=args.page_size, max_blocks=args.max_blocks,
                     faults=parse_fault_specs(args.fault,
                                              seed=args.fault_seed),
                     tracer=tracer, sanitize=args.sanitize,
                     journal=args.journal, mesh=mesh, device=device)


def _serve(args, device: torch.device, mesh=None) -> int:
    """The launcher's run on one device or one rank; returns the exit
    code (1 after an injected crash)."""
    rank0 = mesh is None or mesh.rank == 0
    if args.log_level and rank0:
        logging.basicConfig(
            level=getattr(logging, args.log_level.upper()),
            format="%(asctime)s %(levelname)-7s %(name)s: %(message)s")
    cfg = get_config(args.arch)
    tracer = Tracer() if (args.trace or args.metrics_out) else None
    eng = _build_engine(args, cfg, device, mesh, tracer)
    if mesh is not None:
        how = (f"{mesh.backend}, one card each" if mesh.backend == "nccl"
               else f"gloo on one shared {mesh.device}, collectives staged "
                    "through host copies" if mesh.staged
               else f"gloo on {mesh.device}")
        ranks = mesh.shape["data"] * mesh.shape["model"]
        print(f"mesh: {dict(mesh.shape)} over {ranks} ranks ({how})")
    if args.resume:
        info = eng.restore(args.resume)
        print(f"resumed {info['resumed']} unfinished request(s) from "
              f"{args.resume} ({info['finished']} already finished"
              + (f", {info['torn_bytes']} torn byte(s) discarded"
                 if info["torn_bytes"] else "") + ")")
    max_prompt = (default_max_prompt(args.capacity, args.spec_len)
                  if args.max_prompt is None else args.max_prompt)
    rng = np.random.default_rng(args.seed)
    # a resumed run serves the recovered queue only: the crashed run
    # journaled this trace's submits already, and a fresh trace would
    # collide with the recovered req_ids
    reqs = [] if args.resume else make_requests(
        args.task, args.requests, cfg.vocab_size, args.seed, max_prompt,
        rng=rng, deadline_s=args.deadline)
    t0 = time.perf_counter()
    try:
        if args.arrivals is not None:
            results = serve_live(eng, arrival_schedule(reqs, args.arrivals,
                                                       rng))
        else:
            for r in reqs:
                eng.submit(r)
            results = eng.run(max_iterations=2000)
    except EngineCrashError as exc:
        print(f"\nengine crashed (injected) at iteration {exc.iteration}"
              + (f"; recover with --resume {args.journal}" if args.journal
                 else "; run with --journal PATH to make crashes "
                      "recoverable"))
        return 1
    wall = time.perf_counter() - t0

    by_reason: dict[str, int] = {}
    for r in results:
        by_reason[r.finished_reason] = by_reason.get(r.finished_reason, 0) + 1
    tok = sum(len(r.tokens) for r in results)
    print(f"completed {len(results)} requests in {eng.iteration} iterations "
          f"{dict(sorted(by_reason.items()))} on {device}")
    if eng.preemptions or eng.degraded_steps or args.fault:
        fired = dict(eng.faults.counts) if eng.faults is not None else {}
        print(f"resilience: {eng.preemptions} preemptions, "
              f"{eng.degraded_steps} degraded steps, faults fired {fired}")
    print(f"tokens: {tok}  wall: {wall:.2f}s  tok/s: {tok / max(wall, 1e-9):.1f}")
    print(f"reschedules: {eng.scheduler.num_reschedules}")
    rep = eng.sanitize_report()
    if rep is not None:
        print(f"sanitize: {rep.steady_iterations}/{rep.iterations} steady "
              f"iterations at {rep.transfers_per_steady_iter:.2f} "
              f"transfers/iter (budget {rep.transfer_budget}), "
              f"{rep.programs} programs, {rep.recompiles} steady-state "
              "builds")
    if args.draft_arch and args.spec_len > 1:
        acc = [s.accepted for s in eng.stats if s.new_tokens]
        mean = float(np.mean(acc)) if acc else 0.0
        print(f"speculation: spec_len {args.spec_len}, draft "
              f"{args.draft_arch}, mean accepted per window {mean:.2f} "
              f"over {len(acc)} iterations")
    if eng.kv is not None:
        st = eng.kv.stats()
        frag = max((s.kv_fragmentation for s in eng.stats), default=0.0)
        print(f"kv pages: watermark {st.watermark}/{st.num_pages} "
              f"({st.page_size} tokens/page), peak fragmentation "
              f"{frag:.1%}")
    print("\niter  rlp tlp    AI  fc_path  new_toks  accepted")
    for s in eng.stats:
        print(f"{s.iteration:5d} {s.rlp:4d} {s.tlp:3d} {s.ai_estimate:5.1f}  "
              f"{s.fc_variant:7s} {s.new_tokens:5d}  {s.accepted:8.2f}")
    if tracer is not None and rank0:
        _report_trace(args, tracer)
    return 0


def _report_trace(args, tracer: Tracer) -> None:
    """Write the trace and the Prometheus snapshot the flags asked for,
    and print the telemetry line."""
    if args.trace:
        write_trace(tracer, args.trace, args.trace_format)
    if args.metrics_out:
        with open(args.metrics_out, "w") as fh:
            fh.write(export_prometheus(tracer))
    table = tracer.program_table()
    prog_s = sum(t["total_s"] for t in table.values())
    print(f"\ntelemetry: {tracer.emitted} events ({tracer.dropped} dropped), "
          f"{tracer.counters.get('scheduler_flip', 0)} scheduler flips, "
          f"{len(table)} program keys ({prog_s:.2f}s in programs)"
          + (f" -> {args.trace}" if args.trace else "")
          + (f", metrics -> {args.metrics_out}" if args.metrics_out else ""))
    if args.trace:
        print(f"  summarize: python tools/trace_report.py {args.trace}")


if __name__ == "__main__":
    main()
