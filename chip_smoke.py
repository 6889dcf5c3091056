"""Chip smoke test of the PyTorch / CUDA port (`src/repro_torch`).

    python3 chip_smoke.py            # on a machine with one NVIDIA H100

Phases (any failed check makes the script exit non-zero, after all ran):
  1. print the card's name and power limit; TF32 off for f32 matmuls;
  2. build the four CUDA kernels (fc_gemv, decode_attention,
     paged_decode_attention, ssd_scan) from the repository's sources (nvcc,
     sm_90a, one nvcc per source, started together);
  3. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes (tolerance 1e-4 in f32, 2e-2 in bf16, as
     |err| <= tol + tol*|ref|) and time kernel, plain version, library
     yardstick (torch.matmul / scaled_dot_product_attention, timed only)
     and the memory/compute bound: fc_gemv at qwen2-0.5b's and zamba2-1.2b's
     shared-block widths and ragged ones, a weight at an odd offset (the
     element path, bit-equal to an aligned copy), every FC group of both
     models bit-equal to single launches and to a second run in one CUDA
     launch, and timed as the model launches them (4 grouped calls per
     qwen2 layer or zamba2 application, beside 7 torch.matmul calls and the
     bound, with the planner's cluster and column tile); decode_attention
     at qwen2's GQA (g=7) and
     zamba2's MHA (g=1, nkv=32), and at lens on the tile and split edges
     of its split-S plan (0, 1, a tile -1/0/+1, NS tiles -1/0/+1, 2048, and
     at t=64 a window whose last split is masked for the early rows);
     each time is printed with the call's split count NS and its CUDA
     launches (split pass, plus the merge when NS > 1); 3c: the paged
     kernel over a shuffled page pool (page 16 and 32), also bit-equal to
     the dense kernel on the same contents, blind to table entries past
     each length, zeros for lens == 0, and at the split-edge lens over
     pages of 7, 16 and 32; 3d: ssd_scan at mamba2-1.3b's and zamba2-1.2b's shapes
     (two chunks), at one chunk and three, from a zero and a random initial
     state, y and final state (y 1e-4 in f32, 5e-2 in bf16; the state
     1e-4), two calls bit-equal, and timed with each of its two CUDA
     launches (the C·Bᵀ pass, the scan), both bounds (every product in f32;
     the kernel's precision) and the precision of each product; the
     speculative verify window's shapes ride along: fc_gemv at m = 32 (8
     slots x spec_len 4, checked and timed) and both attention kernels at
     t = 4 (the main geometry and the split edges); zamba2-1.2b's verify
     (phase 4o) too: fc_gemv at each shared-block group at m = 32 and
     decode_attention at t = 4, nkv 32, g 1;
     serve()'s mixed wave rides along: fc_gemv at m = 256 and 512 (8 slots
     x a prefill window of 32 or 64) for each qwen2 group, checked and timed,
     and both attention kernels at t = 64 with lens past the 2048-token
     capacity (decode rows near a slot's end), f32 and bf16, the paged one
     over 2048-token tables and bit-equal to the dense kernel;
     3e: the reference's α calibration (`calibrate_alpha_measured`) on one
     qwen2-0.5b layer's and one zamba2-1.2b application's FC work (7
     torch.matmul calls against 4 fc_gemv launches, weights rotated past
     the L2) at m = 1..128, with the wall-clock columns it compared, the
     same work's device time and the crossover each gives;
     3f: the other families' shapes: fc_gemv at each FC group of one
     layer of olmoe-1b-7b, granite-8b, qwen2-vl-7b, deepseek-67b,
     command-r-plus-104b and gpt3-175b (its gelu MLP: K up to 49152; f32
     m = 8; bf16 m = 8, 32, 512), both attention
     kernels at hd 128 with each model's GQA geometry (t = 1, 4, 64), the
     paged kernel bit-equal to the dense one; each layer's FC groups and
     the attention at t = 1 and 64 timed beside torch.matmul / SDPA and
     the bound;
  4. serve 8 requests with full-width bf16 qwen2-0.5b (24 layers, random
     seeded weights) through `PapiEngine(attn_pim=True)`: every request
     must finish, both FC variants must run, both kernels must launch
     during `run()` (fc_gemv 4 times per layer of each pim step), steady
     iterations must take one host transfer;
     4b: the same 8 requests through `PapiEngine(kv_layout="paged")`: the
     same token streams, both FC variants, the paged kernel launched and
     the dense attention kernel not, one transfer per steady iteration,
     the pool drained at the end;
     4c: a 2100-token prompt that the dense engine (2048-token slots)
     rejects completes on the paged engine, its chunk waves and decodes
     past position 2048 through the paged kernel;
     4d: full-width bf16 mamba2-1.3b (48 layers) serves 8 ragged prompts
     in a 512-token window (each row's SSM state stopped at its prompt's
     end) and rejects a 600-token one: ssd_scan launched 48 times per
     admission wave, no FC or attention kernel;
     4e: full-width bf16 zamba2-1.2b (38 layers, attn_pim) on the same
     requests: ssd_scan 38 per wave, fc_gemv (4 per shared-block
     application of each pim step) and decode_attention launched, both FC
     variants run;
     4f: speculative decoding (spec_len 4, attn_pim) of phase 4's 8
     requests, dense and paged, at α 4 and 99, with the perfect draft (the
     target) and a seed-1 draft cut to 6 layers: every request finishes,
     one transfer per speculative iteration, fc_gemv launched 4 per layer
     for each draft step and the verify (m = 32) of every iteration that
     ran "pim", Attn-PIM called once per target layer at t = 4 and 4 times
     per draft layer at t = 1 per iteration, paged streams equal dense streams, the pool drains; prints
     accepted per window, tokens/s and the tokens equal to phase 4's;
     4g: the TLP register at α 12: spec_len 1 runs "pim" (m = 8),
     `set_spec_len(4)` flips to "pu" (m = 32) at once, and "pim" returns as
     RLP decays; prints the scheduler's events;
     4h: `PapiEngine.serve()` (continuous batching) on phase 4's requests
     arriving on the launcher's seeded Poisson schedule at 0.5 a step,
     dense and paged, α 4 and 99: every request finishes, mixed iterations
     (prefill and decode slots both live) exist, each iteration takes one
     fetch for its wave or decode step plus one for an admitted prompt that
     fits the window (a mixed iteration no more than a decode one),
     fc_gemv launched 4 x 24 times at m = 512 for each mixed wave that ran
     "pim", Attn-PIM at t = 64 once per layer and wave, paged streams equal
     dense ones, the pool drains; prints tokens/s, TTFT and TPOT p50/p99 in
     seconds and iterations, and the tokens equal to phase 4's;
     4i: speculative `serve()` (spec_len 4, the perfect draft, α 99), dense
     and paged: every request finishes, one fetch per speculative iteration
     plus one per chunk wave that completes a prompt, chunk waves under
     "pu" (no fc_gemv at m = 512); prints accepted per window;
     every run of phases 4-4i also checks that no step degraded and no
     request was preempted;
     4j: the failure model.  Phase 4's requests through `serve()` on a
     paged pool of 20 usable pages (2-3 reservations at once) with
     `preempt_after=3` and `debug_invariants=True`, α 4 and 99: requests
     are preempted and requeued, all 8 finish "length", every token index
     comes once, the pool drains.  A nan / kernel fault window on the dense
     path and on a speculative run (the perfect draft): `degraded` equals
     the injector's count, one WARNING each, one transfer a healthy
     iteration and two a degraded one; the re-run keeps the kernels, so the
     dense streams equal the fault-free run's in bf16; prints the bf16
     tokens of the speculative run equal to the fault-free run's.  `cancel()` mid-stream and a deadline that passes
     while a request is queued, through `serve()`; `stall_limit` raising
     `EngineStallError` with its snapshot;
     4k: durability.  Phase 4's requests with a journal and a crash fault
     at iteration 20, dense and paged, and at 8 speculative (spec_len 4,
     the perfect draft); a fresh engine `restore()`s from the same file and
     completes: every request finishes exactly once across the durable
     and the post-crash results, each recovered stream begins with its
     journaled tokens, the extended journal replays to no unfinished
     request; prints the restore and re-admission walls and the bf16
     tokens equal to the uncrashed run's (bf16 recovery is not claimed
     bit-identical); a snapshot of the crashed engine restores too;
     4l: phase 4's run (eos off) untraced and traced, dense and paged:
     equal streams, one transfer per steady iteration traced, the program
     table's keys and counts equal those of the same schedule on the CPU
     (the smoke twin), tokens/s traced against untraced, the per-key mean
     ms (CUDA event pairs: stream time from start to stop); a chrome and a
     jsonl trace pass `tools/trace_report.py --validate` (subprocesses);
     and after 4d, mamba2-1.3b's requests traced: the SSM decode step's
     per-key table;
     4m: the sanitizer: phase 4's run dense and paged and the perfect-draft
     speculative run with ``sanitize=True``: no `SanitizeError`, 1.0
     transfers per steady iteration; a deliberate ``.item()`` inside a
     sanitized step raises, and the sync-debug mode is back after;
     the journal's cost: phase 4's dense run with no journal, ``flush``
     and ``fsync`` (tokens/s, bytes, records);
     4n: the other decoder families at full width, bf16, random weights
     from seed 0, one model resident at a time: olmoe-1b-7b (MoE) at 4 of
     16 layers, granite-8b at 8 of 36, qwen2-vl-7b (M-RoPE) at 7 of 28,
     deepseek-67b (untied head) at 8 layers, command-r-plus-104b
     (layernorm) at 4 and gpt3-175b (gelu MLP, qkv biases, layernorm) at 2
     of 96.
     Phase 4's requests dense and paged, under "pu" (alpha 0) and "pim"
     (alpha 99): every request finishes, fc_gemv launched (a multiple of
     the FC groups x layers) exactly when "pim" ran, the attention kernel
     of the layout launched, the engine's transfer budget per steady
     iteration (one, plus one per MoE layer: olmoe's 4 count copies),
     olmoe once more under the sanitizer, the pool drains, paged streams
     equal dense ones; prints tokens/s, the median
     steady iteration, the bf16 tokens under pim equal to pu's, the
     weights and the peak memory while serving;
     4o: phase 4d's requests served speculatively (spec_len 4, the dense
     slab) on full-width bf16 mamba2-1.3b and zamba2-1.2b (attn_pim), the
     targets cut to half their depth (24 and 18 layers) and first served
     at TLP = 1 at that depth, with the perfect draft and a cut draft (the
     first 6 layers): every request
     finishes, one transfer per speculative iteration, ssd_scan launched
     once per layer of the target and the draft per admission wave; on
     zamba2 fc_gemv 4 per application at m = 32 in each "pim" verify and
     4 per draft application and step at m = 8, decode_attention once per
     application at t = 4 and per draft application and step at t = 1;
     prints accepted per window (and the partial accepts), tokens/s
     against the cut target's TLP = 1 run, the bf16 tokens equal to it and the
     peak memory; then one verify window (8 slots, t = 4) keeping the
     per-token SSM states plus the rewind, against one keeping the last
     state only: device busy and the memory allocated beyond the cache;
  5. trace five steady iterations per KV layout and FC variant with
     torch.profiler (device busy share, top kernels, FC-PIM's, Attn-PIM's
     and the finite-logits guard's device time and CUDA launches per
     iteration; one transfer each), then the guard alone at the plain
     step's, the verify's and a mixed wave's logits shapes; 5b: one admission
     wave of each SSM model (busy share, ssd_scan's share over both of its
     CUDA kernels); 5c: three steady speculative iterations per layout and
     FC variant, qwen2 and its perfect draft cut to 4 of 24 layers (the
     same, with calls by m and by window t); 5d: three
     mixed waves (4 decode rows, 4 prompts mid-prefill) at α 99 per layout
     (the same, per wave); 5e: what keeping the pre-step SSM state costs on
     full-width mamba2: a decode step's device time (it writes its new
     state into fresh tensors) and the memory reserved around it, against
     the copy that keeping a copy would pay; 5f: five steady granite-8b
     (8 of 36 layers) iterations at alpha 99 (busy share, FC-PIM's device time against the
     byte bound of every layer's FC weights);
  6. parity at full width, 2 layers, f32: one decode step's logits with the
     kernels (pim FC + Attn-PIM) against the plain path (pu + plain
     attention) within 1e-3, over a dense slab and over a paged cache;
     6b: prefill and one decode step of mamba2 (2 layers) and zamba2 (7
     layers) with ssd_scan, pim FC and Attn-PIM against the plain path;
     6c: lossless speculation in f32 (2 layers, the kernels on): the
     seed-1 draft's spec_len 4 streams equal the spec_len 1 streams, dense
     and paged (else the first divergence and the logit margin there);
     6d: f32, 2 layers, the kernels on: the `serve()` streams of phase 4h's
     schedule equal the offline `run()` streams, dense and paged (else the
     first divergence and the margin there); and one mixed wave whose
     decode rows sit within the window of the capacity (lens past the
     slab) against the plain path within 1e-3, dense and paged;
     6e: f32, 2 layers, the kernels on: preempted streams (paged, paged
     speculative) and streams under nan / kernel faults (dense, paged,
     speculative) equal the unconstrained fault-free dense run's; on
     2-layer f32 mamba2 (ssd_scan in admission) the faulted streams equal
     the fault-free ones: the SSM state of a poisoned step was restored;
     6f: f32, 2 layers, the kernels on: crash at iteration 20 and restore:
     the union of the durable and post-crash streams equals the uncrashed
     run token for token, dense and paged, spec_len 1 and 2;
     6g: f32, 2 layers, the kernels on: olmoe-1b-7b, qwen2-vl-7b,
     command-r-plus-104b and deepseek-67b through run() and serve(),
     dense and paged (olmoe also spec_len 2 with the perfect draft): the
     streams equal the plain path's run() token for token;
     6h: f32, full width, mamba2 2 layers and zamba2 7, the kernels on:
     a prompt padded into the 512-token window gives the first-decode
     logits of the prompt alone within 1e-3; the cut draft's spec_len 4
     streams (a partial accept seen) equal the spec_len 1 streams, else
     the first divergence and the margin there;
  6i. mesh serving on the tensor axis, ``--mesh 1,2`` with both ranks on
     this one card (NCCL refuses two ranks on a device: gloo, every
     collective staged through a host copy, counted as a host transfer),
     in one spawned world (`launch.mesh.spawn_world`): first a one-rank
     NCCL world (make_serving_mesh, an all_reduce and an all_gather on the
     card); each rank's FC banks (column: q/k/v, gate/up; row: o, down,
     reduced over the ranks) at qwen2-0.5b's and granite-8b's widths
     (bf16, m = 8) against the plain unsharded product, both sharded
     Attn-PIM wrappers at qwen2's (1 KV head a rank) and granite's (4 a
     rank, g = 4) geometry, t = 1, 4 and 64, bit-equal to the unsharded
     kernel's rows for the rank's heads and within tolerance of the plain
     version; full-width qwen2-0.5b (8 of 24 layers) in the engine: f32 dense
     (default rules: the slab split by sequence, plain attention),
     attn_pim (sanitized), paged (Attn-PIM over pages) and speculative
     (attn_pim, spec_len 4, the perfect draft) streams equal
     the one-rank engine's token for token, both FC variants ran, steady
     iterations at the engine's transfer budget, each kernel launched on
     each rank; bf16 attn_pim: the share of equal tokens and the
     first-step logit distance; granite-8b (full width, depth cut to 8)
     bf16 attn_pim; each rank's bytes of weights and KV and tokens/s
     beside the one-rank engine's (no claim); the shard shapes' kernel
     times, the card alone;
  6j. mesh serving on the data axis (the slot batch split over "data", as
     the reference's "batch" rule), every rank on this one card over
     gloo, collectives staged through host copies: a (2, 2) world of four
     ranks serves 6i's f32 full-width qwen2-0.5b (8 layers) cases (dense,
     attn_pim sanitized, paged, speculative spec_len 4 with the perfect
     draft) on 8 slots, and a (2, 1) world serves f32 full-width
     mamba2-1.3b (depth cut to 8) dense and olmoe-1b-7b (cut to 4)
     attn_pim (sanitized) and paged; on every rank the streams, finish
     reasons and FC variants equal the one-rank engine's (6i's runs, and
     the family runs here), steady iterations sit at the transfer budget
     (the fetch's gather over "data" adds one staged copy), each rank
     holds half the slots of the slab or SSM state and the whole paged
     pools, and each run launches its kernels on every rank (`ssd_scan`
     on mamba2, `fc_gemv` and the attention kernel of its layout
     elsewhere); each rank's bytes of weights and KV / SSM state and
     tokens/s beside the one-rank engine's (no claim);
  6k. the MoE, SSM and hybrid families under a tensor split, every rank on
     this one card over gloo: first, the card alone, fc_gemv at a tp = 2
     rank's FC groups of olmoe-1b-7b, granite-moe-1b-a400m and zamba2's
     shared block (f32 and bf16, m = 8; timed beside torch.matmul),
     decode_attention over a rank's KV heads (olmoe 8 of 16 at hd 128,
     zamba2 16 of 32 at hd 64) and ssd_scan at a rank's heads (mamba2 nh
     32 and 16, zamba2 32) against their plain versions, the scan timed;
     then a (1, 2) world serves f32 full-width olmoe-1b-7b (depth cut to
     4: dense, attn_pim sanitized, paged), mamba2-1.3b (cut to 8: plain,
     and spec_len 4 with the perfect draft) and zamba2-1.2b (cut to 12,
     two shared-block applications: attn_pim), and a (2, 2) world
     mamba2's plain case: on every rank the streams, finish reasons and FC
     variants equal the one-rank engine's, steady iterations sit at the
     transfer budget (the experts' combine, the Mamba2 norm and w_out
     sums), each rank holds half the weights (a little more: the router,
     norms, B and C stay whole) and 1/tp of the KV / SSM state (1/4 at
     (2, 2)), and each run launches its kernels on every rank;
  6l. the weights and the KV sequence over "data" (`launch.steps`'
     `choose_rules` tables of the FULL-depth configs, applied to the
     depth-cut models), one world of 4 ranks at (2, 2) on this card over
     gloo, f32 with TF32 off: first, the card alone, fc_gemv at a rank's
     2D blocks of a deepseek-67b layer (K 4096; f32 against the plain
     version, bf16 timed beside torch.matmul, the bound and the whole
     layer); then deepseek-67b (depth cut to 2 of 95) under the 2D
     weight-stationary decode table (the weights' "fsdp" dim and the KV
     sequence over "data", the batch whole): `PapiEngine(mesh=, rules=)`
     serves 6i's 6 requests on 8 slots of 512 at alpha 4 (both FC
     variants), every rank's streams and FC variants equal the one-rank
     engine's, fc_gemv launched on every rank, each weight the rank's 2D
     block by shape, steady transfers at the budget; `build_step`'s
     decode cell fn, one step over 8 drawn rows, logits within 1e-4 of
     one rank's and the collectives a step = `collectives_per_forward`;
     a bf16 pass for the report only (the logits' distance, the equal
     tokens); the FSDP prefill (`build_step`'s prefill cell fn: 4 prompts
     of a 512-token window, each layer's weights gathered at its entry):
     the last logits and each data group's cache block within 1e-4;
     long_500k on zamba2-1.2b (cut to 12 of 38) at the full 524288
     positions (16 GiB of f32 KV, 4 GiB a rank), the KV and SSM state
     drawn from seeds, 4 decode steps from 524280: logits and SSM state
     within 1e-4 of one rank's, the written positions on the rank that
     holds them, the step walls; then mamba2-1.3b/8 and zamba2-1.2b/12
     (Attn-PIM, the KV heads over "model") in the engine under the
     long-context tables, streams equal 6k's one-rank runs, ssd_scan and
     decode_attention launched on every rank;
  7. training, on the train path the reference lowers (no kernel: plain
     matmuls, the plain blocked attention, the differentiable plain SSD
     scan); bf16, random weights from seed 0, batch 8 x seq 512 as two
     microbatches of 4 (accum 2), remat, AdamW (lr 3e-4, warmup 5):
     7a: full-width qwen2-0.5b (8 of 24 layers) through `run_training`, 30
     steps: every loss finite, the mean of the last 5 below the mean of the
     first 5 minus 0.2; an async checkpoint at step 20, then `resume=True`
     from it to step 30: `resumed_from == 20` and the 10 losses within
     2e-2 relative of the uninterrupted run's steps 20-29; prints the
     median step wall over steps 5-29, tokens/s and the peak memory, and
     two steps traced with torch.profiler (device busy share, CUDA
     launches, the top kernels);
     7b: 5 steps each of full-width hubert-xlarge (frames and mask,
     bidirectional, gelu; 12 of 48 layers), mamba2-1.3b (12 of 48) and
     zamba2-1.2b (9 of 38, one shared application) at chunk 256, and
     granite-moe-1b-a400m (6 of 24; its aux loss > 0), depth cut to a
     quarter to keep the script in its limit:
     finite losses and gradient norms, the step wall and the peak memory;
     the models that do not fit one card with AdamW named with their
     reckoned bytes;
     7c: f32 (TF32 off), the qwen2 and mamba2 smoke twins: the first
     step's gradients and 3 `make_train_step` steps (accum 2, remat) on
     the card against the same on the CPU from the same weights, losses,
     gradient norms, gradients and parameters within 1e-4;
     7d: the four kernels' launch counts read 0 across 7a-7c and 7e, and
     `fc_gemv` on a tensor that requires grad raises ("no backward");
     7e: the launcher, `repro_torch.launch.train.main(["--arch",
     "qwen2-0.5b", "--steps", "4", ...])`, prints its ``done: 4 steps``
     line;
     7f: the train cell over the data axis (`launch.steps.build_step`,
     ZeRO-3: each rank holds its blocks of every "fsdp" weight and of both
     AdamW moments and its rows of the batch, rank r drawing the
     pipeline's shard r), f32 with TF32 off, one world of 4 ranks on this
     card over gloo: a (2, 1) mesh trains full-width qwen2-0.5b (4 of 24
     layers) 3 steps on batch 8 x seq 256, then 2 more: every rank's loss
     equal, losses within 1e-5 relative and the gathered parameters after
     3 steps within 1e-4 of the one-rank step on the card, each rank's
     bytes of weights and moments beside one rank's, the collectives a
     step measured beside `collectives_per_train_step`'s reckoning; the
     other (2, 1) mesh the smoke twins of olmoe-1b-7b (the aux loss over
     the global batch's groups), mamba2-1.3b, hubert-xlarge (unequal
     masked counts per rank) and qwen2-vl-7b, 3 steps each against the
     one-rank step; the qwen2 checkpoint saved over the mesh at step 3
     restores onto the (4, 1) mesh and onto one rank, and 2 more steps
     equal the uninterrupted run's; then the tensor split of training
     (tp > 1: the residual over the sequence on "model", the heads, FFN
     and vocabulary over "model", a vocab-split cross-entropy, ZeRO-3
     over "data") in the same world: the full-width qwen2-0.5b (4 of 24
     layers) at (2, 2) (7 of its 14 heads a rank) and (1, 4) (its heads
     whole, the FFN and the vocabulary split), and the qwen2-vl-7b and
     hubert-xlarge smoke twins at (2, 2), 3 steps each on the same
     global batches: every rank's loss equal, losses within 1e-5
     relative, the first step's gathered gradients within 1e-5 of the
     largest and the gathered parameters within 1e-4 of the one-rank
     step's, each rank's bytes of weights and moments beside one rank's,
     the collectives a step on every rank equal to the reckoning, the
     step wall beside one rank's; the four kernels' launch counts read 0
     on every rank;
  8. print the `kernels` JSON line, the card line, and last the device JSON.

Exits non-zero without printing a result when no CUDA device is present or
when run outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import logging
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
if not (SRC / "repro_torch" / "__init__.py").exists():
    sys.exit("chip_smoke.py: src/repro_torch not found next to this script; "
             "run it from a checkout of the repository")
sys.path.insert(0, str(SRC))

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device available")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import calibration as cal  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as attn_mod  # noqa: E402
from repro_torch.kernels import fc_gemv as fc_mod  # noqa: E402
from repro_torch.kernels import paged_decode_attention as paged_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.kernels.ops import fc_layer_runners  # noqa: E402
from repro_torch.data import DataConfig, make_batch, to_device  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.serve import arrival_schedule  # noqa: E402
from repro_torch.models import (attn_impl, decode_step, fc_variant,  # noqa: E402
                                forward_train, model_spec,
                                init_cache, init_paged_cache, init_params,
                                mixed_step, prefill, prefill_to_pages,
                                prefill_to_slots, rewind_ssm, ssd_impl,
                                ssm_step_buffers)
from repro_torch.debug import SanitizeError  # noqa: E402
from repro_torch.serving import (EngineCrashError,  # noqa: E402
                                 EngineStallError, FaultInjector, Journal,
                                 PapiEngine, ServeRequest, Tracer,
                                 latency_summary, read_records, recover,
                                 write_trace)
from repro_torch.serving.engine import _nonfinite  # noqa: E402
from repro_torch.distributed.sharding import (axis_rules,  # noqa: E402
                                              block_range, local_block,
                                              serve_rules)
from repro_torch.launch.mesh import (make_serving_mesh,  # noqa: E402
                                     spawn_world)
from repro_torch.models.linear import papi_linear_group  # noqa: E402
from repro_torch.models.model import (param_shapes,  # noqa: E402
                                      param_shardings)
from repro_torch.configs import SHAPES  # noqa: E402
from repro_torch.distributed.sharding import batch_block  # noqa: E402
from repro_torch.launch.steps import choose_rules  # noqa: E402
from repro_torch.models.model import (cache_shapes,  # noqa: E402
                                      cache_shardings,
                                      collectives_per_forward, flatten_tree,
                                      init_leaf, unflatten_tree)
from repro_torch.models.weights import shard_params  # noqa: E402
from repro_torch.training import (AdamWConfig, CheckpointManager,  # noqa: E402
                                  TrainConfig, init_adamw, make_train_step,
                                  run_training)
from repro_torch.training.tree import leaves, unflatten  # noqa: E402
from repro_torch.configs import ShapeCell  # noqa: E402
from repro_torch.launch.mesh import local_mesh  # noqa: E402
from repro_torch.launch.steps import (build_step,  # noqa: E402
                                      draw_train_batch)
from repro_torch.models.model import collectives_per_train_step  # noqa: E402
from repro_torch.models.weights import unshard_params  # noqa: E402
from repro_torch.training import AdamWState  # noqa: E402

DEV = torch.device("cuda")


class _WarningCount(logging.Handler):
    """Counts the engine's WARNING records (one per degraded step); it
    also keeps them off stderr."""

    def __init__(self) -> None:
        super().__init__(logging.WARNING)
        self.n = 0

    def emit(self, record) -> None:
        self.n += 1


WARNINGS = _WarningCount()
logging.getLogger("repro_torch.serving").addHandler(WARNINGS)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the JAX package's own SSD tolerances (tests/test_kernels.py)
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# the FC groups of one qwen2-0.5b layer and of one zamba2-1.2b shared-block
# application, as the model launches them under "pim": (K, [N of each
# weight]) for q/k/v, o, gate/up and down
FC_GROUPS = [(896, [896, 128, 128]), (896, [896]), (896, [4864, 4864]),
             (4864, [896])]
ZAMBA_FC_GROUPS = [(2048, [2048, 2048, 2048]), (2048, [2048]),
                   (2048, [8192, 8192]), (8192, [2048])]
# the rows of serve()'s mixed wave: max_slots x prefill_len at the
# launcher's defaults (8 x 32) and at phase 4h's engine (8 x 64)
MIXED_MS = (256, 512)
L2_BYTES = 50 * 2 ** 20
FAILURES: list[str] = []


def check(ok: bool, what: str) -> None:
    print(("ok    " if ok else "FAIL  ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"nvidia-smi failed: {out.stderr.strip()}")


def peak_rates() -> tuple[float, float, float]:
    """(bytes/s, bf16 FLOP/s, f32 FLOP/s) published for this card: H100
    SXM 3.35 TB/s, 989 TFLOP/s bf16 dense, 67 TFLOP/s f32 (PCIe part:
    2.0 TB/s, 756, 51)."""
    name = torch.cuda.get_device_name(0)
    if "PCIe" in name:
        return 2.0e12, 756e12, 51e12
    return 3.35e12, 989e12, 67e12


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    bw, bf16, f32 = peak_rates()
    t_b = nbytes / bw
    t_o = flops / (bf16 if dtype == torch.bfloat16 else f32)
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def time_ms(fn, argsets, reps: int = 5) -> float:
    """Device time per call of fn, median over `reps` batches.  Each batch
    runs fn once per argument set (enough sets to exceed L2, as the main
    path finds its weights cold) between two CUDA events, queued behind a
    device-side sleep twice as long as a whole warm batch took, host and
    device (at least 10 ms), so that the host's launch overhead never
    shows as device time."""
    for a in argsets[:3]:
        fn(*a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in argsets:
        fn(*a)
    torch.cuda.synchronize()
    # ~2e9 sleep cycles a second at the card's 1.98 GHz boost clock
    cycles = int(max(2 * (time.perf_counter() - t0), 0.01) * 2e9)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(cycles)            # the host runs ahead
        s, e = torch.cuda.Event(True), torch.cuda.Event(True)
        s.record()
        for a in argsets:
            fn(*a)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / len(argsets))
    return statistics.median(times)


def max_err(got, want, tol=None) -> tuple[float, bool, float]:
    tol = TOL[got.dtype] if tol is None else tol
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return err.max().item(), bool((err <= tol + tol * want.abs()).all()), tol


# ---------------------------------------------------------------------------
def fc_plan_note(K: int, ns: list[int]) -> str:
    """The launch plan of an FC-PIM call, for the lines that time it."""
    p = fc_mod.plan(K, ns, attn_mod.sm_count(DEV))
    return (f"cluster {p.cluster} x {p.k_slice} rows, {p.col_tile}-column "
            "tiles, 1 CUDA launch")


def fc_group_bound(m: int, K: int, ns: list[int]) -> tuple[float, str]:
    """The least time of one grouped call in bf16: every weight, x and
    every output moved once, against 2 m K N operations per weight."""
    nbytes = sum(K * n + m * n for n in ns) * 2 + m * K * 2
    return bound(nbytes, sum(2 * m * K * n for n in ns), torch.bfloat16)


def _fc_group_times(gen, groups: list, label: str, m: int = 8,
                    reps: int = 5) -> dict:
    """Kernel (one grouped call per group), plain (one fc_gemv_ref per
    weight), torch.matmul (one per weight) and bound time of one pass over
    `groups` at m rows (max_slots = 8 at TLP 1; 32 for a verify window of
    spec_len 4), bf16."""
    ms = plain = lib = bnd = 0.0
    by = "bytes"
    for K, ns in groups:
        gbytes = K * sum(ns) * 2
        copies = min(400, max(2, math.ceil(2 * L2_BYTES / gbytes)))
        x = torch.randn(m, K, generator=gen, device=DEV).to(torch.bfloat16)
        args = [(x, *[torch.randn(K, n, generator=gen, device=DEV).to(
            torch.bfloat16) for n in ns]) for _ in range(copies)]
        k_ms = time_ms(lambda x, *ws: fc_mod.fc_gemv_group(x, list(ws)), args,
                       reps)
        p_ms = time_ms(lambda x, *ws: [fc_mod.fc_gemv_ref(x, w) for w in ws],
                       args, reps)
        l_ms = time_ms(lambda x, *ws: [torch.matmul(x, w) for w in ws], args,
                       reps)
        b_ms, b_by = fc_group_bound(m, K, ns)
        print(f"      fc_gemv bf16 m={m} K={K} N={ns} ({label}; "
              f"{fc_plan_note(K, ns)}): kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, torch.matmul x{len(ns)} {l_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
        ms += k_ms
        plain += p_ms
        lib += l_ms
        bnd += b_ms
        by = b_by if b_by == "operations" else by
        del args
    print(f"      fc_gemv bf16 m={m}, {label} ({len(groups)} CUDA launches): "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.matmul "
          f"{lib:.4f} ms, bound {bnd:.4f} ms", flush=True)
    return {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bnd,
            "bound_by": by}


def phase_fc_gemv() -> dict:
    gen = torch.Generator(device=DEV).manual_seed(1)
    shapes = list(dict.fromkeys((K, n) for K, ns in FC_GROUPS for n in ns))
    cases = [(K, N, m) for K, N in shapes for m in (1, 8, 13, 32)]
    cases += [(K, n, 8) for K, n in dict.fromkeys(
        (K, n) for K, ns in ZAMBA_FC_GROUPS for n in ns)]
    # ragged: N % 8 != 0, K < 16, clusters of 4 and 8 ranks whose last K
    # slice is short, and m past one pass of 64 rows
    cases += [(100, 37, 13), (129, 64, 64), (1, 40, 8), (1000, 200, 13),
              (5000, 37, 8), (896, 4864, 130)]          # 130: three passes
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for K, N, m in cases:
            x = torch.randn(m, K, generator=gen, device=DEV).to(dtype)
            w = (torch.randn(K, N, generator=gen, device=DEV)
                 / math.sqrt(K)).to(dtype)
            got = fc_mod.fc_gemv(x, w)
            torch.cuda.synchronize()
            err, ok, tol = max_err(got, fc_mod.fc_gemv_ref(x, w))
            if dtype == torch.bfloat16 and (K, N) in shapes:
                worst = max(worst, err)
            check(ok and got.shape == (m, N),
                  f"fc_gemv {str(dtype)[6:]} m={m} K={K} N={N}: "
                  f"max_abs_err {err:.3e} (tol {tol})")
        # a weight whose rows are not 16-byte aligned (the element path)
        flat = torch.randn(896 * 896 + 1, generator=gen, device=DEV).to(dtype)
        w = flat[1:].view(896, 896)
        x = torch.randn(8, 896, generator=gen, device=DEV).to(dtype)
        got, aligned = fc_mod.fc_gemv(x, w), fc_mod.fc_gemv(x, w.clone())
        torch.cuda.synchronize()
        err, ok, tol = max_err(got, fc_mod.fc_gemv_ref(x, w))
        check(ok and torch.equal(got, aligned),
              f"fc_gemv {str(dtype)[6:]} m=8 K=896 N=896, weight at an odd "
              f"offset: max_abs_err {err:.3e} (tol {tol}), bit-equal to an "
              "aligned copy")
        # a group gives the bits of single launches, and of itself again
        for K, ns in FC_GROUPS + ZAMBA_FC_GROUPS:
            if len(ns) == 1:
                continue
            for m in (1, 8, 13):
                x = torch.randn(m, K, generator=gen, device=DEV).to(dtype)
                ws = [(torch.randn(K, n, generator=gen, device=DEV)
                       / math.sqrt(K)).to(dtype) for n in ns]
                before = fc_mod.LAUNCHES
                group = fc_mod.fc_gemv_group(x, ws)
                one = fc_mod.LAUNCHES - before
                singles = [fc_mod.fc_gemv(x, w) for w in ws]
                again = fc_mod.fc_gemv_group(x, ws)
                torch.cuda.synchronize()
                check(one == 1 and all(
                    torch.equal(y, z) and torch.equal(y, u)
                    for y, z, u in zip(group, singles, again)),
                      f"fc_gemv_group {str(dtype)[6:]} m={m} K={K} N={ns}: "
                      f"{one} launch, bit-equal to single launches and to "
                      "a second run")
        # zamba2's speculative verify under "pim" (phase 4o): each group of
        # the shared block at m = 8 slots x spec_len 4
        for K, ns in ZAMBA_FC_GROUPS:
            x = torch.randn(32, K, generator=gen, device=DEV).to(dtype)
            ws = [(torch.randn(K, n, generator=gen, device=DEV)
                   / math.sqrt(K)).to(dtype) for n in ns]
            ys = fc_mod.fc_gemv_group(x, ws)
            torch.cuda.synchronize()
            errs = [max_err(y, fc_mod.fc_gemv_ref(x, w))
                    for y, w in zip(ys, ws)]
            check(all(ok for _, ok, _ in errs)
                  and all(y.shape == (32, n) for y, n in zip(ys, ns)),
                  f"fc_gemv_group {str(dtype)[6:]} m=32 K={K} N={ns} (the "
                  f"zamba2-1.2b verify window): max_abs_err "
                  f"{max(e for e, _, _ in errs):.3e} (tol {errs[0][2]})")
        # serve()'s mixed wave under "pim": every projection at m =
        # max_slots x prefill_len (8 x 32 at the launcher's defaults, 8 x 64
        # at phase 4h's engine), m_rows(m) = 64 rows a pass over the weights
        for K, ns in FC_GROUPS:
            for m in MIXED_MS:
                x = torch.randn(m, K, generator=gen, device=DEV).to(dtype)
                ws = [(torch.randn(K, n, generator=gen, device=DEV)
                       / math.sqrt(K)).to(dtype) for n in ns]
                ys = fc_mod.fc_gemv_group(x, ws)
                torch.cuda.synchronize()
                errs = [max_err(y, fc_mod.fc_gemv_ref(x, w))
                        for y, w in zip(ys, ws)]
                if dtype == torch.bfloat16:
                    worst = max([worst] + [e for e, _, _ in errs])
                check(all(ok for _, ok, _ in errs)
                      and all(y.shape == (m, n) for y, n in zip(ys, ns)),
                      f"fc_gemv_group {str(dtype)[6:]} m={m} K={K} N={ns} "
                      f"(the mixed wave, {-(-m // fc_mod.m_rows(m))} passes "
                      f"over the weights): max_abs_err "
                      f"{max(e for e, _, _ in errs):.3e} (tol {errs[0][2]})")
    # timing at the decode path's m = max_slots = 8, bf16: one qwen2 layer's
    # FC groups (the row), one application of zamba2's shared block (printed)
    result = _fc_group_times(gen, FC_GROUPS, "one qwen2-0.5b layer")
    _fc_group_times(gen, ZAMBA_FC_GROUPS,
                    "one zamba2-1.2b shared-block application")
    # the speculative verify window: 8 slots x spec_len 4
    _fc_group_times(gen, FC_GROUPS, "one qwen2-0.5b layer, verify window",
                    m=32)
    _fc_group_times(gen, ZAMBA_FC_GROUPS, "one zamba2-1.2b shared-block "
                    "application, verify window", m=32)
    for m in MIXED_MS:
        _fc_group_times(gen, FC_GROUPS, "one qwen2-0.5b layer, mixed wave",
                        m=m)
    return {"max_abs_err": worst, **result}


def _attn_inputs(gen, dtype, t, lens, b=8, nkv=2, g=7, hd=64, S=2048):
    q = torch.randn(b, nkv, t * g, hd, generator=gen, device=DEV).to(dtype)
    k = torch.randn(b, S, nkv, hd, generator=gen, device=DEV).to(dtype)
    v = torch.randn(b, S, nkv, hd, generator=gen, device=DEV).to(dtype)
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=DEV)


def _sdpa_args(q, k, v, lens, t):
    """The same function as one scaled_dot_product_attention call: heads =
    KV heads, the t*g query rows carry the window-causal mask."""
    b, nkv, tg, hd = q.shape
    S = k.shape[1]
    g = tg // t
    row = torch.arange(tg, device=DEV) // g
    limit = lens.long()[:, None] - (t - 1) + row[None, :]
    mask = torch.arange(S, device=DEV)[None, None, :] < limit[:, :, None]
    return (q, k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
            mask[:, None])


def _sdpa(q, k, v, mask):
    return torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                            attn_mask=mask)


# (label, t, lens, KV geometry) of the dense attention kernel's main-path
# calls: qwen2-0.5b's GQA decode (t=1), chunk waves (t=64) and speculative
# verify windows (t=4) in 2048-token slots, and zamba2-1.2b's MHA shared
# block (g=1, nkv=32) decoding (t=1) and verifying (t=4, phase 4o) in
# 1024-token slots, lens up to the longest prompt plus its budget
ATTN_CASES = [
    ("qwen2-0.5b", 1, [1, 32, 33, 2048, 100, 513, 1000, 7],
     dict(nkv=2, g=7, S=2048)),
    ("qwen2-0.5b", 64, [64, 65, 96, 2048, 128, 513, 1000, 200],
     dict(nkv=2, g=7, S=2048)),
    ("qwen2-0.5b", 4, [4, 5, 36, 2048, 100, 513, 1000, 7],
     dict(nkv=2, g=7, S=2048)),
    ("zamba2-1.2b", 1, [1, 12, 33, 512, 100, 300, 576, 64],
     dict(nkv=32, g=1, S=1024)),
    ("zamba2-1.2b", 4, [4, 15, 36, 515, 103, 303, 579, 67],
     dict(nkv=32, g=1, S=1024)),
]


# lens of a qwen2-0.5b chunk wave (t=64) whose decode rows sit near the end
# of their 2048-token slots: a decode row at position p has lens = p + 64,
# up to 2047 + 64 = 2111, past the capacity; the kernels clamp to it, as the
# plain version's mask does
CAPACITY_EDGE_LENS = [2049, 2110, 2111, 2048, 65, 513, 1000, 200]


def plan_note(b, nkv, rows) -> str:
    """The split plan of an Attn-PIM call, for the lines that time it."""
    ns = attn_mod.num_splits(b, nkv, rows, attn_mod.sm_count(DEV))
    return (f"NS={ns}, {attn_mod.cuda_launches(ns)} CUDA launch"
            f"{'es' if ns > 1 else ''} per call")


def split_edge_lens(t, b=10, S=2048) -> list[int]:
    """Lens on the tile and split edges of the split-S plan of a
    qwen2-geometry call (b requests, t*7 rows): 0, 1, a tile -1/0/+1, NS
    tiles -1/0/+1 (one tile per split), 2048 = S; at t > 1 the last one is
    a length whose last split lies past the window's row-0 limit."""
    ns = attn_mod.num_splits(b, 2, t * 7, attn_mod.sm_count(DEV))
    lens = [0, 1, 31, 32, 33, ns * 32 - 1, ns * 32, ns * 32 + 1, S, S]
    if t > 1:
        for n in range(ns * 32 + 1, S + 1):
            nkb = -(-n // 32)
            if (ns - 1) * nkb // ns * 32 >= n - (t - 1):
                lens[-1] = n
                break
    return lens[:b]


def phase_decode_attention() -> dict:
    gen = torch.Generator(device=DEV).manual_seed(2)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for arch, t, lens, geo in ATTN_CASES:
            q, k, v, ln = _attn_inputs(gen, dtype, t, lens, **geo)
            got = attn_mod.decode_attention(q, k, v, ln, q_rows=t)
            torch.cuda.synchronize()
            err, ok, tol = max_err(
                got, attn_mod.decode_attention_ref(q, k, v, ln, t))
            if dtype == torch.bfloat16:
                worst = max(worst, err)
            check(ok and bool(torch.isfinite(got).all()),
                  f"decode_attention {str(dtype)[6:]} {arch} t={t} "
                  f"nkv={geo['nkv']} g={geo['g']} S={geo['S']} lens={lens}: "
                  f"max_abs_err {err:.3e} (tol {tol})")
    zero = attn_mod.decode_attention(
        *(_attn_inputs(gen, torch.bfloat16, 1, [0, 5, 0, 9, 1, 2, 3, 4])))
    check(bool((zero[0] == 0).all() and (zero[2] == 0).all()),
          "decode_attention lens == 0 returns zeros")
    for dtype in (torch.float32, torch.bfloat16):
        for t in (1, 4, 64):
            lens = split_edge_lens(t)
            q, k, v, ln = _attn_inputs(gen, dtype, t, lens, b=len(lens))
            got = attn_mod.decode_attention(q, k, v, ln, q_rows=t)
            again = attn_mod.decode_attention(q, k, v, ln, q_rows=t)
            torch.cuda.synchronize()
            err, ok, tol = max_err(
                got, attn_mod.decode_attention_ref(q, k, v, ln, t))
            check(ok and bool(torch.isfinite(got).all())
                  and bool((got[0] == 0).all()) and torch.equal(got, again),
                  f"decode_attention {str(dtype)[6:]} split edges t={t} "
                  f"({plan_note(len(lens), 2, 7 * t)}) lens={lens}: "
                  f"max_abs_err {err:.3e} (tol {tol}), lens 0 -> zeros, "
                  "two calls bit-equal")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, ln = _attn_inputs(gen, dtype, 64, CAPACITY_EDGE_LENS)
        got = attn_mod.decode_attention(q, k, v, ln, q_rows=64)
        torch.cuda.synchronize()
        err, ok, tol = max_err(
            got, attn_mod.decode_attention_ref(q, k, v, ln, 64))
        if dtype == torch.bfloat16:
            worst = max(worst, err)
        check(ok and bool(torch.isfinite(got).all()),
              f"decode_attention {str(dtype)[6:]} qwen2-0.5b t=64 lens past "
              f"the capacity S=2048 lens={CAPACITY_EDGE_LENS}: max_abs_err "
              f"{err:.3e} (tol {tol})")
    result = {"max_abs_err": worst}
    for arch, t, lens, geo in ATTN_CASES:
        sets = [_attn_inputs(gen, torch.bfloat16, t, lens, **geo)
                for _ in range(12)]
        k_ms = time_ms(lambda q, k, v, ln: attn_mod.decode_attention(
            q, k, v, ln, q_rows=t), sets)
        p_ms = time_ms(lambda q, k, v, ln: attn_mod.decode_attention_ref(
            q, k, v, ln, t), sets)
        l_ms = time_ms(_sdpa, [_sdpa_args(*s, t) for s in sets])
        q = sets[0][0]
        nkv, g = geo["nkv"], geo["g"]
        kv_bytes = sum(lens) * 2 * nkv * 64 * 2         # K and V, bf16
        io_bytes = 2 * q.numel() * 2
        flops = 4 * sum(lens) * nkv * t * g * 64        # qk and pv
        b_ms, b_by = bound(kv_bytes + io_bytes, flops, torch.bfloat16)
        print(f"      decode_attention bf16 {arch} t={t} b=8 nkv={nkv} g={g} "
              f"S={geo['S']}: kernel {k_ms:.4f} ms "
              f"({plan_note(8, nkv, t * g)}), plain {p_ms:.4f} ms, "
              f"sdpa {l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        if arch == "qwen2-0.5b" and t == 1:
            result.update(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                          bound_ms=b_ms, bound_by=b_by)
        del sets
    return result


def _paged_pool(gen, dtype, lens, page, b=8, nkv=2, hd=64, S=2048):
    """A shuffled page pool for `lens` (the main path's geometry: page 0 =
    garbage, max_blocks = S*b/page) and two tables over it: `clean` maps
    each request's live blocks and leaves the rest on page 0; `dirty` also
    points the entries past each length at other live pages."""
    num_pages = b * S // page + 1
    max_blocks = num_pages - 1
    kp = torch.randn(num_pages, page, nkv, hd, generator=gen,
                     device=DEV).to(dtype)
    vp = torch.randn(num_pages, page, nkv, hd, generator=gen,
                     device=DEV).to(dtype)
    perm = torch.randperm(num_pages - 1, generator=gen, device=DEV) + 1
    clean = torch.zeros(b, max_blocks, dtype=torch.int32, device=DEV)
    at = 0
    for i, n in enumerate(lens):
        used = -(-n // page)
        clean[i, :used] = perm[at:at + used].to(torch.int32)
        at += used
    dirty = clean.clone()
    for i, n in enumerate(lens):
        used = -(-n // page)
        fill = torch.randint(1, num_pages, (max_blocks - used,),
                             generator=gen, device=DEV)
        dirty[i, used:] = fill.to(torch.int32)
    return kp, vp, clean, dirty


def phase_paged_attention() -> dict:
    gen = torch.Generator(device=DEV).manual_seed(4)
    lens_by_t = {1: [1, 32, 33, 2048, 100, 513, 1000, 7],
                 64: [64, 65, 96, 2048, 128, 513, 1000, 200],
                 4: [4, 5, 36, 2048, 100, 513, 1000, 7]}
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for page in (16, 32):
            for t, lens in lens_by_t.items():
                kp, vp, clean, dirty = _paged_pool(gen, dtype, lens, page)
                q = torch.randn(8, 2, t * 7, 64, generator=gen,
                                device=DEV).to(dtype)
                ln = torch.tensor(lens, dtype=torch.int32, device=DEV)
                got = paged_mod.paged_decode_attention(q, kp, vp, ln, clean,
                                                       q_rows=t)
                torch.cuda.synchronize()
                err, ok, tol = max_err(got, paged_mod.paged_decode_attention_ref(
                    q, kp, vp, ln, clean, t))
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
                name = f"paged_decode_attention {str(dtype)[6:]} page={page} t={t}"
                check(ok and bool(torch.isfinite(got).all()),
                      f"{name}: max_abs_err {err:.3e} (tol {tol})")
                blocks = clean[:, :2048 // page]          # the dense layout
                dense = attn_mod.decode_attention(
                    q, paged_mod.gather_kv_pages(kp, blocks).contiguous(),
                    paged_mod.gather_kv_pages(vp, blocks).contiguous(), ln,
                    q_rows=t)
                kp0, vp0 = kp.clone(), vp.clone()
                kp0[0] = float("nan")                     # poison page 0
                vp0[0] = float("nan")
                blind = [paged_mod.paged_decode_attention(
                    q, a, b, ln, tab, q_rows=t)
                    for a, b, tab in ((kp, vp, dirty), (kp0, vp0, clean))]
                torch.cuda.synchronize()
                check(torch.equal(got, dense),
                      f"{name}: bit-equal to the dense kernel")
                check(all(torch.equal(got, x) for x in blind),
                      f"{name}: table entries past each length never read")
    for dtype in (torch.float32, torch.bfloat16):
        for page in (7, 16, 32):
            for t in (1, 4, 64):
                lens = split_edge_lens(t)
                b = len(lens)
                kp, vp, clean, dirty = _paged_pool(gen, dtype, lens, page, b=b)
                q = torch.randn(b, 2, t * 7, 64, generator=gen,
                                device=DEV).to(dtype)
                ln = torch.tensor(lens, dtype=torch.int32, device=DEV)
                got = paged_mod.paged_decode_attention(q, kp, vp, ln, clean,
                                                       q_rows=t)
                torch.cuda.synchronize()
                err, ok, tol = max_err(got, paged_mod.paged_decode_attention_ref(
                    q, kp, vp, ln, clean, t))
                blocks = clean[:, :-(-2048 // page)]      # the dense layout
                dense = attn_mod.decode_attention(
                    q, paged_mod.gather_kv_pages(kp, blocks).contiguous(),
                    paged_mod.gather_kv_pages(vp, blocks).contiguous(), ln,
                    q_rows=t)
                kp[0] = float("nan")                      # poison page 0
                vp[0] = float("nan")
                blind = [paged_mod.paged_decode_attention(
                    q, kp, vp, ln, tab, q_rows=t) for tab in (clean, dirty)]
                torch.cuda.synchronize()
                check(ok and bool(torch.isfinite(got).all())
                      and bool((got[0] == 0).all()) and torch.equal(got, dense)
                      and all(torch.equal(got, x) for x in blind),
                      f"paged_decode_attention {str(dtype)[6:]} split edges "
                      f"page={page} t={t} ({plan_note(b, 2, 7 * t)}) "
                      f"lens={lens}: max_abs_err {err:.3e} (tol {tol}), "
                      "bit-equal to the dense kernel, table entries past "
                      "each length never read, lens 0 -> zeros")
                del kp, vp, clean, dirty
    for dtype in (torch.float32, torch.bfloat16):
        for page in (16, 32):
            # tables of 2048 // page entries: a capacity of S = 2048
            kp, vp, clean, _ = _paged_pool(gen, dtype, CAPACITY_EDGE_LENS,
                                           page)
            tab = clean[:, :2048 // page].contiguous()
            q = torch.randn(8, 2, 64 * 7, 64, generator=gen,
                            device=DEV).to(dtype)
            ln = torch.tensor(CAPACITY_EDGE_LENS, dtype=torch.int32,
                              device=DEV)
            got = paged_mod.paged_decode_attention(q, kp, vp, ln, tab,
                                                   q_rows=64)
            dense = attn_mod.decode_attention(
                q, paged_mod.gather_kv_pages(kp, tab).contiguous(),
                paged_mod.gather_kv_pages(vp, tab).contiguous(), ln,
                q_rows=64)
            torch.cuda.synchronize()
            err, ok, tol = max_err(got, paged_mod.paged_decode_attention_ref(
                q, kp, vp, ln, tab, 64))
            if dtype == torch.bfloat16:
                worst = max(worst, err)
            check(ok and bool(torch.isfinite(got).all())
                  and torch.equal(got, dense),
                  f"paged_decode_attention {str(dtype)[6:]} page={page} t=64 "
                  f"lens past the capacity 2048 lens={CAPACITY_EDGE_LENS}: "
                  f"max_abs_err {err:.3e} (tol {tol}), bit-equal to the "
                  "dense kernel")
            del kp, vp, clean
    kp, vp, clean, _ = _paged_pool(gen, torch.bfloat16, [0, 5, 0, 9, 1, 2,
                                                         3, 4], 16)
    q = torch.randn(8, 2, 7, 64, generator=gen, device=DEV).to(torch.bfloat16)
    zero = paged_mod.paged_decode_attention(
        q, kp, vp, torch.tensor([0, 5, 0, 9, 1, 2, 3, 4], dtype=torch.int32,
                                device=DEV), clean)
    check(bool((zero[0] == 0).all() and (zero[2] == 0).all()),
          "paged_decode_attention lens == 0 returns zeros")

    result = {"max_abs_err": worst}
    for t, lens in lens_by_t.items():
        sets = []
        for _ in range(12):
            kp, vp, clean, _ = _paged_pool(gen, torch.bfloat16, lens, 16)
            q = torch.randn(8, 2, t * 7, 64, generator=gen,
                            device=DEV).to(torch.bfloat16)
            sets.append((q, kp, vp, torch.tensor(lens, dtype=torch.int32,
                                                  device=DEV), clean))
        k_ms = time_ms(lambda q, k, v, ln, tab: paged_mod.paged_decode_attention(
            q, k, v, ln, tab, q_rows=t), sets)
        p_ms = time_ms(lambda q, k, v, ln, tab:
                       paged_mod.paged_decode_attention_ref(q, k, v, ln, tab,
                                                            t), sets)
        # the library yardstick runs over views gathered beforehand (the
        # first 2048 positions of each request); the gather is not timed
        lib_sets = [_sdpa_args(
            q, paged_mod.gather_kv_pages(k, tab[:, :128]),
            paged_mod.gather_kv_pages(v, tab[:, :128]), ln, t)
            for q, k, v, ln, tab in sets]
        l_ms = time_ms(_sdpa, lib_sets)
        del lib_sets
        q = sets[0][0]
        kv_bytes = sum(lens) * 2 * 64 * 2 * 2          # K and V, nkv=2, bf16
        io_bytes = 2 * q.numel() * 2                    # q and out
        table_bytes = sum(-(-n // 16) for n in lens) * 4 + 8 * 4
        flops = 4 * sum(lens) * 2 * t * 7 * 64          # qk and pv
        b_ms, b_by = bound(kv_bytes + io_bytes + table_bytes, flops,
                           torch.bfloat16)
        print(f"      paged_decode_attention bf16 t={t} b=8 page=16 "
              f"num_pages=1025 max_blocks=1024: kernel {k_ms:.4f} ms "
              f"({plan_note(8, 2, 7 * t)}), plain {p_ms:.4f} ms, sdpa over pre-gathered views (gather not "
              f"timed) {l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        if t == 1:
            result.update(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                          bound_ms=b_ms, bound_by=b_by)
        del sets
    return result


# ---------------------------------------------------------------------------
# (b, nh, l, hp, n, chunk) of the SSM main paths' scans: mamba2-1.3b and
# zamba2-1.2b at a 512-token prefill window (two 256-row chunks)
SSD_SHAPES = {"mamba2-1.3b": (8, 64, 512, 64, 128, 256),
              "zamba2-1.2b": (8, 64, 512, 64, 64, 256)}


def _ssd_inputs(gen, b, nh, l, hp, n, x_dtype, bc_dtype, slow=False):
    """dtx, lt, B, C and a random initial state.  The decays are those of
    tests/test_kernels.py (dt = softplus(N(0,1) - 1), A in [-7.4, -1]:
    the state forgets a 256-row chunk), or with `slow` the model's init
    laws (dt ~ logU[1e-3, 0.1], A in [-16, -1]: the state carries across
    chunks)."""
    dtx = (0.5 * torch.randn(b, nh, l, hp, generator=gen,
                             device=DEV)).to(x_dtype)
    if slow:
        lo, hi = math.log(1e-3), math.log(0.1)
        dt = torch.exp(lo + (hi - lo) * torch.rand(b, nh, l, generator=gen,
                                                   device=DEV))
        A = -(1.0 + 15.0 * torch.rand(nh, generator=gen, device=DEV))
    else:
        dt = torch.nn.functional.softplus(
            torch.randn(b, nh, l, generator=gen, device=DEV) - 1.0)
        A = -torch.exp(2.0 * torch.rand(nh, generator=gen, device=DEV))
    lt = (dt * A[None, :, None]).contiguous()
    B = (0.5 * torch.randn(b, l, n, generator=gen, device=DEV)).to(bc_dtype)
    C = (0.5 * torch.randn(b, l, n, generator=gen, device=DEV)).to(bc_dtype)
    s0 = 0.5 * torch.randn(b, nh, hp, n, generator=gen, device=DEV)
    return dtx, lt, B, C, s0


def ssd_work(b, nh, l, hp, n, cs) -> tuple[int, int, int, int]:
    """(bytes, C·Bᵀ ops, y ops, state ops) of one main-path call (dtx
    f32, B/C and y bf16, the zero initial state read, the final state
    written): C·Bᵀ once per (batch, chunk) and lower triangle only; y: its
    product with dtx (j <= i) and the inter-chunk term; the state update."""
    nc = l // cs
    tri = cs * (cs + 1) // 2
    nbytes = (b * nh * l * hp * 4 + b * nh * l * 4 + 2 * b * l * n * 2
              + b * nh * l * hp * 2 + 2 * b * nh * hp * n * 4)
    return (nbytes, b * nc * tri * n * 2,
            b * nh * nc * (tri * hp * 2 + cs * n * hp * 2),
            b * nh * nc * cs * hp * n * 2)


def ssd_bound(b, nh, l, hp, n, cs) -> tuple[float, str]:
    """The least time of one main-path call with every operation in f32 on
    CUDA cores (the plain version's precision): bytes over the memory rate
    against all operations over the f32 rate."""
    nbytes, cb, y, st = ssd_work(b, nh, l, hp, n, cs)
    return bound(nbytes, cb + y + st, torch.float32)


def ssd_tc_bound(b, nh, l, hp, n, cs) -> tuple[float, str]:
    """The least time of one main-path call at the kernel's precision:
    bytes over the memory rate against C·Bᵀ over the bf16 rate plus the y
    products (TF32) and the state update (3xTF32 with B exact in bf16: two
    TF32 products) over the TF32 rate, half the bf16 one; all on the same
    tensor cores, so their times add."""
    bw, bf16, _ = peak_rates()
    nbytes, cb, y, st = ssd_work(b, nh, l, hp, n, cs)
    t_b, t_o = nbytes / bw, cb / bf16 + (y + 2 * st) / (bf16 / 2)
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


# the precision of each product of the kernel, as phase 3d prints it
SSD_PRECISION = ("C·Bᵀ: bf16 mma, exact products, f32 sums (f32 B/C: CUDA "
                 "cores); y = (C·Bᵀ∘L)·dtx + (e^cum∘C)·Sᵀ: TF32 mma, f32 "
                 "sums, where y is bf16 (all-f32 mix: f32 CUDA cores); state "
                 "update: 3xTF32 mma (f32 accuracy) where y is bf16, else f32 "
                 "CUDA cores")


def ssd_launch_ms(kern, sets) -> dict:
    """Device ms per call of each CUDA kernel of the scan (torch.profiler
    over one pass of `sets`).  A capture that holds no device time at all
    is the profiler failing to trace (seen once on the card, between two
    good captures in one process), not the scan: it is taken once more."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(2):
        with torch.profiler.profile(activities=acts) as prof:
            for a in sets:
                kern(*a)
            torch.cuda.synchronize()
        if any(getattr(evt, "self_device_time_total", 0) > 0
               for evt in prof.key_averages()):
            break
    out = {}
    for evt in prof.key_averages():
        for name in ("ssd_cb_kernel", "ssd_scan_kernel"):
            dev = getattr(evt, "self_device_time_total", 0)
            if name in evt.key and dev > 0:
                out[name] = out.get(name, 0.0) + dev / 1e3 / len(sets)
    return out


def phase_ssd_scan() -> dict:
    """Phase 3d: ssd_scan against its plain version on the card."""
    gen = torch.Generator(device=DEV).manual_seed(7)
    f32, bf16 = torch.float32, torch.bfloat16
    # (x, B/C, y) dtypes: all f32; the bf16 model's mix; all bf16
    mixes = ((f32, f32, f32), (f32, bf16, bf16), (bf16, bf16, bf16))
    cases = [(arch, shape, False) for arch, shape in SSD_SHAPES.items()]
    cases += [(arch + " slow decay", shape, True)
              for arch, shape in SSD_SHAPES.items()]
    cases += [("one chunk l < chunk", (8, 64, 100, 64, 128, 256), False),
              ("three chunks slow decay", (2, 64, 768, 64, 64, 256), True)]
    # the row's max_abs_err: every bf16-y case at the main paths' shapes,
    # both decay laws
    main_shapes, worst = set(SSD_SHAPES.values()), 0.0
    for label, (b, nh, l, hp, n, ch), slow in cases:
        for xd, bcd, yd in mixes:
            for init in (False, True):
                dtx, lt, B, C, s0 = _ssd_inputs(gen, b, nh, l, hp, n, xd, bcd,
                                                slow)
                kw = dict(chunk=ch, init_state=s0 if init else None,
                          out_dtype=yd)
                y, st = ssd_mod.ssd_scan(dtx, lt, B, C, **kw)
                torch.cuda.synchronize()
                want_y, want_st = ssd_mod.ssd_scan_ref(dtx, lt, B, C, **kw)
                tol = SSD_TOL[yd]
                ey, oky, _ = max_err(y, want_y, tol)
                # the state is f32 in both versions, from the same inputs
                es, oks, _ = max_err(st, want_st, SSD_TOL[f32])
                if yd == bf16 and (b, nh, l, hp, n, ch) in main_shapes:
                    worst = max(worst, ey)
                check(oky and oks and bool(torch.isfinite(y).all()),
                      f"ssd_scan {label} b={b} l={l} n={n} x/BC/y "
                      f"{str(xd)[6:]}/{str(bcd)[6:]}/{str(yd)[6:]} "
                      f"init={'random' if init else 'zero'}: max_abs_err y "
                      f"{ey:.3e} (tol {tol}), state {es:.3e} (tol "
                      f"{SSD_TOL[f32]})")
                del dtx, lt, B, C, s0, y, st, want_y, want_st
    result = {"max_abs_err": worst, "library_ms": None}
    print(f"      ssd_scan precision: {SSD_PRECISION}", flush=True)
    for arch, (b, nh, l, hp, n, ch) in SSD_SHAPES.items():
        sets = []
        for _ in range(3):               # 137 MB a set: past the L2
            dtx, lt, B, C, _ = _ssd_inputs(gen, b, nh, l, hp, n, f32, bf16)
            sets.append((dtx, lt, B, C, torch.zeros(b, nh, hp, n,
                                                    device=DEV)))

        def kern(dtx, lt, B, C, s0):
            return ssd_mod.ssd_scan(dtx, lt, B, C, chunk=ch, init_state=s0,
                                    out_dtype=bf16)

        def plain(dtx, lt, B, C, s0):
            return ssd_mod.ssd_scan_ref(dtx, lt, B, C, chunk=ch,
                                        init_state=s0, out_dtype=bf16)

        y1, s1 = kern(*sets[0])
        y2, s2 = kern(*sets[0])
        torch.cuda.synchronize()
        check(torch.equal(y1, y2) and torch.equal(s1, s2),
              f"ssd_scan {arch} shapes: two calls bit-equal in y and state")
        k_ms, p_ms = time_ms(kern, sets), time_ms(plain, sets)
        per = ssd_launch_ms(kern, sets)
        f_ms, f_by = ssd_bound(b, nh, l, hp, n, ch)
        b_ms, b_by = ssd_tc_bound(b, nh, l, hp, n, ch)
        print(f"      ssd_scan {arch} shapes b={b} nh={nh} l={l} hp={hp} "
              f"n={n} cs={ch} (dtx f32, B/C/y bf16; "
              f"{ssd_mod.cuda_launches()} CUDA launches a call): kernel "
              f"{k_ms:.4f} ms (of it, by the profiler: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in per.items())
              + f"), plain {p_ms:.4f} ms, no single PyTorch call, bound at "
              f"the kernel's precision {b_ms:.4f} ms ({b_by}), with every "
              f"product in f32 {f_ms:.4f} ms ({f_by})", flush=True)
        check(set(per) == {"ssd_cb_kernel", "ssd_scan_kernel"},
              f"ssd_scan {arch} shapes: the profiler sees both CUDA kernels "
              f"({sorted(per)})")
        if arch == "mamba2-1.3b":
            result.update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by)
        del sets, y1, y2, s1, s2
    return result


# ---------------------------------------------------------------------------
PROMPT_LENS = [24, 150, 40, 70, 12, 97, 33, 64]       # 150/97/70 chunk


MODS = {"fc_gemv": fc_mod, "decode_attention": attn_mod,
        "paged_decode_attention": paged_mod, "ssd_scan": ssd_mod}


def zero_counts() -> None:
    for mod in MODS.values():
        mod.LAUNCHES = 0
    fc_mod.LAUNCHES_BY_M.clear()
    attn_mod.LAUNCHES_BY_ROWS.clear()
    paged_mod.LAUNCHES_BY_ROWS.clear()


def read_counts() -> dict:
    return {name: mod.LAUNCHES for name, mod in MODS.items()}


def check_healthy(eng, label: str) -> None:
    """A run with no fault and no pool pressure: no step was degraded and
    no request preempted."""
    check(eng.degraded_steps == eng.preemptions == 0
          and not any(s.degraded or s.preemptions for s in eng.stats),
          f"{label}: degraded {eng.degraded_steps}, preemptions "
          f"{eng.preemptions}")


def _serve(cfg, params, label: str, **kw) -> tuple[dict, dict]:
    """Serve the main path's 8 requests through one engine, with the
    kernels' launch counts set to 0 just before `run()` and read just
    after.  Returns ({req_id: tokens}, launches)."""
    eng = PapiEngine(cfg, params, max_slots=8, cache_capacity=2048,
                     prefill_len=64, alpha=4, attn_pim=True, device=DEV, **kw)
    rng = np.random.default_rng(0)
    for i, plen in enumerate(PROMPT_LENS):
        eng.submit(ServeRequest(i, rng.integers(3, cfg.vocab_size,
                                                size=plen).tolist(),
                                max_new_tokens=8 + 8 * i))
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(max_iterations=500)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()

    reasons = sorted(r.finished_reason for r in results)
    check(len(results) == 8 and all(r in ("eos", "length") for r in reasons),
          f"{label}: 8 requests finished ({reasons})")
    check_healthy(eng, label)
    toks = [t for r in results for t in r.tokens]
    check(all(0 <= t < cfg.vocab_size for t in toks) and len(toks) > 0,
          f"{label}: {len(toks)} tokens within the vocabulary")
    variants = {s.fc_variant for s in eng.stats}
    check({"pu", "pim"} <= variants, f"{label}: FC variants {variants}")
    paged = eng.kv is not None
    attn = "paged_decode_attention" if paged else "decode_attention"
    other = "decode_attention" if paged else "paged_decode_attention"
    check(launches["fc_gemv"] > 0 and launches[attn] > 0
          and launches[other] == 0 and launches["ssd_scan"] == 0,
          f"{label}: launches {launches}")
    check(launches["fc_gemv"] % (4 * cfg.num_layers) == 0,
          f"{label}: fc_gemv launched {launches['fc_gemv']} times, 4 per "
          f"layer ({cfg.num_layers}) of each pim step")
    steady = [s for s in eng.stats if s.admitted == 0]
    check(bool(steady) and all(s.transfers == 1 for s in steady),
          f"{label}: {len(steady)} steady iterations, one host transfer "
          "each")
    if paged:
        alloc = eng.kv.alloc
        alloc.check()
        check(alloc.mapped_count == 0 and alloc.reserved_unmapped == 0
              and alloc.free_count == alloc.num_pages,
              f"{label}: pool drained (watermark {alloc.watermark} of "
              f"{alloc.num_pages} pages)")
    per = {v: [s.wall_s * 1e3 for s in steady if s.fc_variant == v]
           for v in ("pu", "pim")}
    print(f"      {label}: {len(toks)} tokens in {eng.iteration} "
          f"iterations, {wall:.3f} s, {len(toks) / wall:.1f} tok/s; "
          + ", ".join(f"median steady iteration under {v} "
                      f"{statistics.median(x):.2f} ms ({len(x)} its)"
                      for v, x in per.items() if x), flush=True)
    return {r.req_id: r.tokens for r in results}, launches


def phase_main_path() -> tuple[dict, dict, dict]:
    """Phases 4 and 4b: the dense main path, then the paged one on the
    same requests; the streams must be equal."""
    cfg = get_config("qwen2-0.5b")
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0))
    dense, launches = _serve(cfg, params, "main path")
    paged, paged_launches = _serve(cfg, params, "paged main path",
                                   kv_layout="paged", page_size=16)
    check(paged == dense, "paged main path: the 8 token streams equal the "
          "dense main path's")
    launches["paged_decode_attention"] = paged_launches[
        "paged_decode_attention"]
    return launches, params, dense


def phase_long_context(params) -> None:
    """Phase 4c: a context no dense slot holds."""
    cfg = get_config("qwen2-0.5b")
    prompt = np.random.default_rng(6).integers(3, cfg.vocab_size,
                                               size=2100).tolist()
    kw = dict(max_slots=8, cache_capacity=2048, prefill_len=64, alpha=4,
              attn_pim=True, eos_token=cfg.vocab_size, device=DEV)
    dense = PapiEngine(cfg, params, **kw)
    dense.submit(ServeRequest(0, prompt, max_new_tokens=32))
    got = dense.run(max_iterations=10)
    check([r.finished_reason for r in got] == ["rejected"],
          "long context: the dense engine (2048-token slots) rejects a "
          "2100-token prompt")
    eng = PapiEngine(cfg, params, kv_layout="paged", page_size=16, **kw)
    eng.submit(ServeRequest(0, prompt, max_new_tokens=32))
    paged_mod.LAUNCHES = attn_mod.LAUNCHES = 0
    t0 = time.perf_counter()
    got = eng.run(max_iterations=100)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = got[0].tokens if got else []
    waves = -(-(len(prompt) - 64) // 64)
    check(len(got) == 1 and got[0].finished_reason == "length"
          and len(toks) == 32 and all(0 <= t < cfg.vocab_size for t in toks),
          f"long context: the paged engine completes it ({len(toks)} tokens, "
          f"{got[0].finished_reason if got else 'nothing'})")
    layers = cfg.num_layers
    check(paged_mod.LAUNCHES == layers * (waves + 31)
          and attn_mod.LAUNCHES == 0,
          f"long context: {paged_mod.LAUNCHES} paged kernel launches "
          f"({waves} chunk waves at t=64 + 31 decode steps, {layers} "
          f"layers), to position {len(prompt) + 31}")
    eng.kv.alloc.check()
    check(eng.kv.alloc.mapped_count == 0, "long context: pool drained")
    check_healthy(eng, "long context")
    print(f"      long context: 2100-token prompt + 32 tokens in "
          f"{wall:.3f} s, page watermark {eng.kv.alloc.watermark}",
          flush=True)


GUARD = "finite_guard"     # the engine's profiler range around the guard


def _dev_time(evt) -> float:
    dev = getattr(evt, "self_device_time_total", None)
    return getattr(evt, "self_cuda_time_total", 0) if dev is None else dev


def _kernels(prof) -> list:
    """(device us, name, count) of every CUDA kernel in a trace; the
    device-side copies of host ranges (the serve waves', the guard's) are
    spans, not kernels."""
    kern = []
    for evt in prof.key_averages():
        dev = _dev_time(evt)
        if (dev > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not evt.key.startswith("serve_wave_")
                and evt.key != GUARD):
            kern.append((dev, evt.key, evt.count))
    return kern


def _guard_in_trace(prof, iters: int) -> str:
    """The finite-logits guard's device time and CUDA launches per
    iteration of a trace: the kernels launched inside its range."""
    us, n = 0.0, 0
    for e in prof.events():
        if e.name != GUARD or e.device_type != torch.autograd.DeviceType.CPU:
            continue
        stack = list(e.cpu_children)
        while stack:
            x = stack.pop()
            for k in getattr(x, "kernels", []):
                us += k.duration
                n += 1
            stack.extend(x.cpu_children)
    if not n:
        return "finite-logits guard: not measured (no kernels under its range)"
    return (f"finite-logits guard {us / iters / 1e3:.4f} ms in "
            f"{n / iters:g} CUDA launches each")


def phase_trace(params) -> None:
    """Where a steady decode iteration's time goes, per KV layout and FC
    variant: five iterations of 8 live requests under torch.profiler;
    device busy share = kernel time / host wall time, and the kernels that
    take the most."""
    cfg = get_config("qwen2-0.5b")
    rng = np.random.default_rng(5)
    for layout, variant, alpha in (("dense", "pu", 0.0), ("dense", "pim", 99.0),
                                   ("paged", "pu", 0.0), ("paged", "pim", 99.0)):
        eng = PapiEngine(cfg, params, max_slots=8, cache_capacity=2048,
                         prefill_len=64, alpha=alpha, attn_pim=True,
                         kv_layout=layout, device=DEV)
        for i in range(8):
            eng.submit(ServeRequest(i, rng.integers(
                3, cfg.vocab_size, size=32).tolist(), max_new_tokens=32))
        for _ in range(3):
            eng.step()                      # admission + warm decode steps
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                eng.step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        ran = {s.fc_variant for s in eng.stats[-6:-1]}
        kern = _kernels(prof)
        busy = sum(k[0] for k in kern)
        if not kern:
            print(f"      trace {layout} {variant}: profiler saw no device time "
                  "(not measured)", flush=True)
            continue
        top = sorted(kern, reverse=True)[:6]
        attn = [k for k in kern if "attn_split" in k[1]
                or "attn_merge" in k[1]]
        fc = [k for k in kern if "fc_gemv" in k[1]]
        quiet = eng.stats[-5:]
        check(all(s.transfers == 1 and not s.degraded for s in quiet),
              f"trace {layout} {variant}: one transfer per traced iteration "
              f"(the guard's flag rides it): {[s.transfers for s in quiet]}")
        print(f"      trace {layout} {variant} (ran {sorted(ran)}): 5 steady "
              f"iterations {wall_us / 5e3:.2f} ms each, device busy "
              f"{busy / 5e3:.2f} ms each ({busy / wall_us:.1%}); FC-PIM "
              f"{sum(k[0] for k in fc) / 5e3:.4f} ms in "
              f"{sum(k[2] for k in fc) // 5} CUDA launches each; Attn-PIM "
              f"{sum(k[0] for k in attn) / 5e3:.4f} ms in "
              f"{sum(k[2] for k in attn) // 5} CUDA launches each; "
              f"{_guard_in_trace(prof, 5)}; top: "
              + "; ".join(f"{name[:40]} {dev / 5e3:.3f} ms x{cnt // 5}"
                          for dev, name, cnt in top), flush=True)


def phase_parity() -> None:
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), num_layers=2,
                              dtype="float32")
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(3))
    rng = np.random.default_rng(3)
    slots, P, page = 8, 64, 16
    toks = torch.tensor(rng.integers(3, cfg.vocab_size, size=(slots, P)),
                        dtype=torch.int32, device=DEV)
    lens = torch.tensor(rng.integers(1, P + 1, size=slots), dtype=torch.int32,
                        device=DEV)
    src = torch.arange(slots, dtype=torch.int32, device=DEV)
    dense = init_cache(cfg, slots, 256, DEV)
    # a paged cache of 256 positions per slot on shuffled pages
    paged = init_paged_cache(cfg, slots, slots * 256 // page + 1, page,
                             256 // page, DEV)
    paged["block_tables"] = torch.tensor(
        rng.permutation(slots * 256 // page) + 1, dtype=torch.int32,
        device=DEV).reshape(slots, 256 // page)
    batch = {"tokens": toks, "prompt_lens": lens}
    first, dense = prefill_to_slots(cfg, params, batch, dense, src)
    first_p, paged = prefill_to_pages(cfg, params, batch, paged, src)
    check(torch.equal(first, first_p), "parity f32 2 layers: paged prefill "
          "first tokens equal the dense prefill's")
    for layout, cache in (("dense", dense), ("paged", paged)):
        out = {}
        for fcv, impl in (("pu", "xla"), ("pim", "pim")):
            c = {k: v.clone() for k, v in cache.items()}
            with fc_variant(fcv), attn_impl(impl):
                out[fcv], _ = decode_step(cfg, params, c, first[:, None])
        torch.cuda.synchronize()
        err = (out["pim"] - out["pu"]).abs().max().item()
        agree = (out["pim"].argmax(-1) == out["pu"].argmax(-1)).float().mean()
        check(err <= 1e-3, f"parity f32 2 layers, {layout} cache: decode "
              f"logits kernels vs plain max_abs_err {err:.3e} (tol 1e-3), "
              f"greedy agreement {agree.item():.3f}")


# ---------------------------------------------------------------------------
# the SSM families: 8 ragged prompts up to the 512-token window, and one of
# 600 tokens that the engine rejects (no chunk waves for SSM state)
SSM_PROMPT_LENS = [12, 512, 100, 37, 256, 480, 64, 300]
SSM_ENGINE = dict(max_slots=8, cache_capacity=1024, prefill_len=512, alpha=4)


def _ssm_prompts(cfg) -> list:
    """Phase 4d's 9 prompts: SSM_PROMPT_LENS and the 600-token one as
    request 3, seed 8."""
    rng = np.random.default_rng(8)
    reqs = [rng.integers(3, cfg.vocab_size, size=n).tolist()
            for n in SSM_PROMPT_LENS]
    reqs.insert(3, rng.integers(3, cfg.vocab_size, size=600).tolist())
    return reqs


def _submit_ssm(eng, cfg) -> None:
    """Phase 4d's 9 requests, budgets 8 + 7 (i % 9)."""
    for i, prompt in enumerate(_ssm_prompts(cfg)):
        eng.submit(ServeRequest(i, prompt, max_new_tokens=8 + 7 * (i % 9)))


def _serve_ssm(arch: str, params, attn_pim: bool,
               cfg=None) -> tuple[dict, dict]:
    """Phases 4d / 4e: serve the SSM requests at full width (and depth
    unless `cfg` cuts it), with every kernel's launch count set to 0 just
    before `run()` and read just after.  Returns (launches, {"waves": n,
    "tokens": n, "wall_s": s, "streams": {req_id: tokens}})."""
    cfg = cfg or get_config(arch)
    label = (f"{arch} path" if cfg.num_layers == get_config(arch).num_layers
             else f"{arch}/{cfg.num_layers} path")
    eng = PapiEngine(cfg, params, attn_pim=attn_pim, device=DEV,
                     **SSM_ENGINE)
    _submit_ssm(eng, cfg)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(max_iterations=500)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    # one prefill per admitting iteration: the 8 admitted requests fit the
    # 8 slots, so no iteration runs a second wave
    waves = sum(1 for s in eng.stats if s.admitted > 0)

    got = {r.req_id: r for r in results}
    check_healthy(eng, label)
    check(len(got) == 9 and got[3].finished_reason == "rejected"
          and got[3].tokens == [],
          f"{label}: the 600-token prompt is rejected (prefill_len 512)")
    others = [r for i, r in got.items() if i != 3]
    check(len(others) == 8 and all(r.finished_reason in ("eos", "length")
                                   for r in others),
          f"{label}: the other 8 requests finished "
          f"({sorted(r.finished_reason for r in others)})")
    toks = [t for r in others for t in r.tokens]
    check(len(toks) > 0 and all(0 <= t < cfg.vocab_size for t in toks),
          f"{label}: {len(toks)} tokens within the vocabulary")
    check(waves >= 1 and launches["ssd_scan"] == cfg.num_layers * waves,
          f"{label}: ssd_scan launched {launches['ssd_scan']} times in "
          f"{waves} admission wave(s), {cfg.num_layers} per wave")
    if cfg.family == "ssm":
        check(launches["fc_gemv"] == launches["decode_attention"]
              == launches["paged_decode_attention"] == 0,
              f"{label}: no FC or attention kernel launched ({launches})")
    else:
        check(launches["fc_gemv"] > 0 and launches["decode_attention"] > 0
              and launches["paged_decode_attention"] == 0,
              f"{label}: fc_gemv and decode_attention launched ({launches})")
        apps = cfg.num_attention_applications()
        check(launches["fc_gemv"] % (4 * apps) == 0,
              f"{label}: fc_gemv launched {launches['fc_gemv']} times, 4 per "
              f"shared-block application ({apps}) of each pim step")
        variants = {s.fc_variant for s in eng.stats}
        check({"pu", "pim"} <= variants, f"{label}: FC variants {variants}")
    steady = [s for s in eng.stats if s.admitted == 0]
    check(bool(steady) and all(s.transfers == 1 for s in steady),
          f"{label}: {len(steady)} steady iterations, one host transfer "
          "each")
    per = {v: [s.wall_s * 1e3 for s in steady if s.fc_variant == v]
           for v in ("pu", "pim")}
    print(f"      {label}: {len(toks)} tokens in {eng.iteration} "
          f"iterations, {wall:.3f} s, {len(toks) / wall:.1f} tok/s; "
          + ", ".join(f"median steady iteration under {v} "
                      f"{statistics.median(x):.2f} ms ({len(x)} its)"
                      for v, x in per.items() if x), flush=True)
    return launches, {"waves": waves, "tokens": len(toks), "wall_s": wall,
                      "streams": {r.req_id: r.tokens for r in results}}


SSM_ARCHES = (("mamba2-1.3b", False), ("zamba2-1.2b", True))   # attn_pim


def phase_ssm_paths() -> tuple[dict, dict, dict]:
    """Phases 4d (mamba2-1.3b) and 4e (zamba2-1.2b, attn_pim) at full
    width, bf16, random weights from seed 0.  Returns (launches, params,
    run info) by arch."""
    launches, params_by_arch, info = {}, {}, {}
    for arch, attn_pim in SSM_ARCHES:
        params = init_params(get_config(arch),
                             torch.Generator(device=DEV).manual_seed(0))
        launches[arch], info[arch] = _serve_ssm(arch, params, attn_pim)
        params_by_arch[arch] = params
    return launches, params_by_arch, info


def _cut(cfg, params, n: int):
    """The model cut to its first n layers (a hybrid keeps its shared
    block): the cut draft of phases 4o and 6h."""
    def take(tree):
        return {k: take(v) if isinstance(v, dict) else v[:n]
                for k, v in tree.items()}
    return dataclasses.replace(cfg, num_layers=n), dict(
        params, layers=take(params["layers"]))


def _record_accepts(eng) -> list:
    """Keep each speculative window's accepted counts (device tensors, no
    sync) beside the live slots, by wrapping the engine's rewind; read
    them with `_accepts` after the run."""
    seen, rewind = [], eng._rewind

    def record(accepted, *rest):
        seen.append((accepted.clone(), list(eng.active_slots)))
        return rewind(accepted, *rest)
    eng._rewind = record
    return seen


def _accepts(seen) -> list[int]:
    """The accepted count of every live slot of every window."""
    return [a for acc, live in seen
            for s, a in enumerate(acc.tolist()) if s in live]


# the cut drafts of phase 4o: the first shared-block segment of zamba2 (6
# layers), as many of mamba2's 48
SSM_CUT = 6


def _serve_ssm_spec(cfg, params, draft, label, attn_pim, plain) -> dict:
    """One speculative run of phase 4o (spec_len 4, the dense slab) on
    phase 4d's requests, the launch counts set to 0 just before `run()`
    and read just after."""
    dcfg = draft[0]
    eng = PapiEngine(cfg, params, attn_pim=attn_pim, spec_len=SPEC_LEN,
                     draft=draft, device=DEV, **SSM_ENGINE)
    _submit_ssm(eng, cfg)
    seen = _record_accepts(eng)
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = eng.run(max_iterations=500)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = read_counts()
    by_m = dict(fc_mod.LAUNCHES_BY_M)
    attn_by_t = dict(attn_mod.LAUNCHES_BY_ROWS)
    waves = sum(1 for s in eng.stats if s.admitted > 0)

    got = {r.req_id: r for r in results}
    check_healthy(eng, label)
    check(len(got) == 9 and got[3].finished_reason == "rejected"
          and all(r.finished_reason in ("eos", "length")
                  for i, r in got.items() if i != 3),
          f"{label}: 8 requests finished, the 600-token one rejected "
          f"({sorted(r.finished_reason for r in got.values())})")
    streams = {i: r.tokens for i, r in got.items() if i != 3}
    toks = sum(len(t) for t in streams.values())
    steady = [s for s in eng.stats if s.admitted == 0]
    check(bool(steady) and all(s.transfers == 1 for s in steady),
          f"{label}: {len(steady)} speculative iterations without "
          "admission, one host transfer each")
    L, Ld = cfg.num_layers, dcfg.num_layers
    check(waves >= 1 and launches["ssd_scan"] == (L + Ld) * waves,
          f"{label}: ssd_scan launched {launches['ssd_scan']} times in "
          f"{waves} admission wave(s): {L} for the target and {Ld} for the "
          "draft per wave")
    ran = _ran_variants(eng)
    n_pim = ran.count("pim")
    if cfg.family == "ssm":
        check(launches["fc_gemv"] == launches["decode_attention"]
              == launches["paged_decode_attention"] == 0,
              f"{label}: no FC or attention kernel launched ({launches})")
    else:
        apps = cfg.num_attention_applications()
        dapps = dcfg.num_attention_applications()
        check(n_pim > 0 and by_m.get(8 * SPEC_LEN, 0) == 4 * apps * n_pim
              and launches["fc_gemv"] == 4 * n_pim * (apps
                                                      + SPEC_LEN * dapps),
              f"{label}: fc_gemv launched {launches['fc_gemv']} times "
              f"({by_m} by m) in {n_pim} pim iterations of {len(ran)}: 4 x "
              f"{apps} applications at m = {8 * SPEC_LEN} (the verify) and "
              f"4 x {dapps} x {SPEC_LEN} draft steps at m = 8")
        check(attn_by_t.get(SPEC_LEN, 0) == apps * len(ran)
              and attn_by_t.get(1, 0) == dapps * SPEC_LEN * len(ran)
              and launches["paged_decode_attention"] == 0,
              f"{label}: decode_attention calls by window t {attn_by_t}: "
              f"{apps} at t = {SPEC_LEN} (the verify) and "
              f"{dapps * SPEC_LEN} at t = 1 (the draft) per iteration, over "
              f"{len(ran)} iterations")
    acc = _accepts(seen)
    same, total = _same_tokens(streams, plain["streams"])
    tlp1 = plain["tokens"] / plain["wall_s"]
    print(f"      {label} [{CARD}]: {toks} tokens in {eng.iteration} "
          f"iterations ({n_pim} pim), {wall:.3f} s, {toks / wall:.1f} tok/s "
          f"against {tlp1:.1f} at TLP = 1 ({toks / wall / tlp1:.2f}x); "
          f"accepted per window {statistics.mean(acc):.3f} "
          f"({sum(1 < a < SPEC_LEN for a in acc)} partial of {len(acc)}); "
          f"{same} of {total} bf16 tokens equal the TLP = 1 run's; peak "
          f"memory {peak / 2 ** 30:.2f} GiB", flush=True)
    return launches


def _verify_cost(cfg, params) -> None:
    """Phase 4o: one verify window (8 slots, t = spec_len) of the full
    model with the per-token SSM states kept and a rewind to a partial
    prefix, against the same window keeping only the last state: device
    busy of one call (torch.profiler) and the memory it allocates beyond
    the cache."""
    cache = init_cache(cfg, 8, SSM_ENGINE["cache_capacity"], DEV)
    window = torch.randint(3, cfg.vocab_size, (8, SPEC_LEN), device=DEV,
                           dtype=torch.int32)
    n = torch.tensor([1, 2, 3, 4, 4, 3, 2, 1], dtype=torch.int32, device=DEV)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def kept():
        c = dict(cache)
        steps = ssm_step_buffers(c, SPEC_LEN)
        decode_step(cfg, params, c, window, steps)
        rewind_ssm(c, steps, n)

    def last_only():
        decode_step(cfg, params, dict(cache), window)

    out = []
    for name, fn in (("per-token states + rewind", kept),
                     ("last state only", last_only)):
        fn()                                                  # warm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        kern = _kernels(prof)
        busy = (f"{sum(k[0] for k in kern) / 1e3:.3f} ms busy" if kern
                else "device time not measured")
        out.append(f"{name} {busy}, {extra / 2 ** 30:.2f} GiB allocated "
                   "beyond the cache")
    nbytes = sum(x.numel() * x.element_size() for x in cache["ssm"])
    print(f"      verify window {cfg.name} [{CARD}] (8 slots, t = "
          f"{SPEC_LEN}, {nbytes / 2 ** 30:.2f} GiB of SSM state): "
          + "; ".join(out), flush=True)
    del cache


# 4o's target depth (half of each model's; zamba2 three shared-block
# applications), with its own TLP = 1 run at that depth: the script's limit
SSM_SPEC_DEPTH = {"mamba2-1.3b": 24, "zamba2-1.2b": 18}


def phase_ssm_spec(params_by_arch, info) -> dict:
    """Phase 4o: phase 4d's requests served speculatively (spec_len 4, the
    dense slab) on full-width bf16 mamba2-1.3b and zamba2-1.2b (attn_pim)
    cut to `SSM_SPEC_DEPTH` layers, against the cut target's TLP = 1 run,
    with the perfect draft (the target) and a cut draft (its first 6
    layers); then one verify window's cost.  Returns the launches summed
    over the six runs."""
    del info            # 4d / 4e ran at full depth
    total = {}
    for arch, attn_pim in SSM_ARCHES:
        cfg, params = _cut(get_config(arch), params_by_arch[arch],
                           SSM_SPEC_DEPTH[arch])
        ln, plain = _serve_ssm(arch, params, attn_pim, cfg)
        for k, v in ln.items():
            total[k] = total.get(k, 0) + v
        for name, draft in (("perfect draft", (cfg, params)),
                            (f"cut draft ({SSM_CUT} layers)",
                             _cut(cfg, params, SSM_CUT))):
            ln = _serve_ssm_spec(cfg, params, draft,
                                 f"spec {arch}/{cfg.num_layers} {name}",
                                 attn_pim, plain)
            for k, v in ln.items():
                total[k] = total.get(k, 0) + v
        _verify_cost(cfg, params)
    return total


def phase_wave_trace(params_by_arch) -> None:
    """Phase 5b: one admission wave (8 ragged prompts in the 512-token
    window through `prefill_to_slots`) of each SSM model under
    torch.profiler: device busy share and ssd_scan's share of the wave's
    device time."""
    rng = np.random.default_rng(9)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for arch, params in params_by_arch.items():
        cfg = get_config(arch)
        P = SSM_ENGINE["prefill_len"]
        toks = torch.tensor(rng.integers(3, cfg.vocab_size, size=(8, P)),
                            dtype=torch.int32, device=DEV)
        batch = {"tokens": toks, "prompt_lens": torch.tensor(
            SSM_PROMPT_LENS, dtype=torch.int32, device=DEV)}
        src = torch.arange(8, dtype=torch.int32, device=DEV)
        cache = init_cache(cfg, 8, SSM_ENGINE["cache_capacity"], DEV)
        prefill_to_slots(cfg, params, batch, cache, src)     # warm
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            prefill_to_slots(cfg, params, batch, cache, src)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kern = _kernels(prof)
        if not kern:
            print(f"      wave trace {arch}: profiler saw no device time "
                  "(not measured)", flush=True)
            continue
        busy = sum(k[0] for k in kern)
        # ssd_scan's two CUDA kernels (the C·Bᵀ pass and the scan)
        parts = {name: (sum(k[0] for k in kern if name in k[1]),
                        sum(k[2] for k in kern if name in k[1]))
                 for name in ("ssd_cb_kernel", "ssd_scan_kernel")}
        ssd = sum(dev for dev, _ in parts.values())
        top = sorted(kern, reverse=True)[:6]
        print(f"      wave trace {arch}: one admission wave {wall_us / 1e3:.2f}"
              f" ms wall, device busy {busy / 1e3:.2f} ms "
              f"({busy / wall_us:.1%}); ssd_scan {ssd / 1e3:.2f} ms "
              f"({ssd / busy:.1%} of device time: "
              + ", ".join(f"{name} {dev / 1e3:.2f} ms x{cnt}"
                          for name, (dev, cnt) in parts.items())
              + "); top: "
              + "; ".join(f"{name[:40]} {dev / 1e3:.3f} ms x{cnt}"
                          for dev, name, cnt in top), flush=True)


def phase_ssm_parity() -> None:
    """Phase 6b: full width, f32, reduced depth (mamba2 2 layers; zamba2 7:
    one shared application and one remainder layer).  The prefill's logits
    and one decode step's, with the kernels (ssd_scan, pim FC, Attn-PIM)
    against the plain path (plain scan, pu, plain attention); both decode
    the plain path's first tokens."""
    rng = np.random.default_rng(10)
    for arch, depth in (("mamba2-1.3b", 2), ("zamba2-1.2b", 7)):
        cfg = dataclasses.replace(get_config(arch), num_layers=depth,
                                  dtype="float32")
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(3))
        P = SSM_ENGINE["prefill_len"]
        toks = torch.tensor(rng.integers(3, cfg.vocab_size, size=(8, P)),
                            dtype=torch.int32, device=DEV)
        batch = {"tokens": toks, "prompt_lens": torch.tensor(
            SSM_PROMPT_LENS, dtype=torch.int32, device=DEV)}
        out, first = {}, None
        for impl, fcv, attn in (("plain", "pu", "xla"),
                                ("kernel", "pim", "pim")):
            cache = init_cache(cfg, 8, 1024, DEV)
            with ssd_impl(impl):
                logits0, cache = prefill(cfg, params, batch, cache)
                if first is None:
                    first = logits0.argmax(-1).to(torch.int32)
                with fc_variant(fcv), attn_impl(attn):
                    logits1, _ = decode_step(cfg, params, cache,
                                             first[:, None])
            out[impl] = (logits0, logits1)
        torch.cuda.synchronize()
        for step, (k, p) in enumerate(zip(out["kernel"], out["plain"])):
            err = (k - p).abs().max().item()
            agree = (k.argmax(-1) == p.argmax(-1)).float().mean().item()
            what = "prefill" if step == 0 else "decode step"
            check(err <= 1e-3 and bool(torch.isfinite(k).all()),
                  f"parity f32 {arch} {depth} layers, {what} logits: kernels "
                  f"vs plain max_abs_err {err:.3e} (tol 1e-3), greedy "
                  f"agreement {agree:.3f}")
        del params


def _ssm_margin(cfg, params, seq: list) -> float:
    """The top-1 minus top-2 logit after `seq` on the plain path: its
    tokens as one decode window from a fresh cache (any length, where the
    chunked scan wants one the chunk divides)."""
    cache = init_cache(cfg, 1, len(seq) + 1, DEV)
    with ssd_impl("plain"), fc_variant("pu"), attn_impl("xla"):
        logits, _ = decode_step(cfg, params, cache, torch.tensor(
            [seq], dtype=torch.int32, device=DEV))
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def phase_ssm_spec_parity() -> None:
    """Phase 6h: f32, full width, mamba2 2 layers and zamba2 7 (one shared
    application and a remainder layer), the kernels on (ssd_scan, pim FC
    at alpha 99, Attn-PIM).  Phase 4d's prompts that the scan takes alone
    (one chunk of at most 256 rows, or whole chunks), padded into the
    512-token window:
    the first decode step's logits equal those of each prompt prefilled in
    a window of its own length within 1e-3.  Then the cut draft's spec_len
    4 streams (a partial accept seen) equal the spec_len 1 streams, else
    the first divergence and the plain path's margin there."""
    rng = np.random.default_rng(11)
    for arch, depth, cut in (("mamba2-1.3b", 2, 1), ("zamba2-1.2b", 7, 6)):
        cfg = dataclasses.replace(get_config(arch), num_layers=depth,
                                  dtype="float32")
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(3))
        P = SSM_ENGINE["prefill_len"]
        attn_pim = cfg.family == "hybrid"
        with fc_variant("pim"), attn_impl("pim" if attn_pim else "xla"):
            errs = []
            cs = cfg.ssm.chunk_size
            for n in [n for n in SSM_PROMPT_LENS if n <= cs or n % cs == 0]:
                prompt = rng.integers(3, cfg.vocab_size, size=n)
                logits = []
                for window in (P, n):
                    toks = torch.zeros((1, window), dtype=torch.int32,
                                       device=DEV)
                    toks[0, :n] = torch.from_numpy(prompt).to(DEV)
                    cache = init_cache(cfg, 1, 1024, DEV)
                    first, cache = prefill_to_slots(
                        cfg, params, {"tokens": toks, "prompt_lens":
                                      torch.tensor([n], dtype=torch.int32,
                                                   device=DEV)},
                        cache, torch.zeros(1, dtype=torch.int32, device=DEV))
                    out, _ = decode_step(cfg, params, cache, first[:, None])
                    logits.append(out[0, 0])
                errs.append((n, (logits[0] - logits[1]).abs().max().item()))
        worst = max(e for _, e in errs)
        check(worst <= 1e-3,
              f"f32 {arch} {depth} layers: first-decode logits of a prompt "
              f"padded into the {P}-token window against the prompt alone, "
              "max_abs_err by prompt length "
              + ", ".join(f"{n}: {e:.2e}" for n, e in errs) + " (tol 1e-3)")

        draft = _cut(cfg, params, cut)
        out, seen = {}, None
        for k in (1, SPEC_LEN):
            eng = PapiEngine(cfg, params, attn_pim=attn_pim, spec_len=k,
                             draft=draft if k > 1 else None,
                             eos_token=cfg.vocab_size, device=DEV,
                             **{**SSM_ENGINE, "alpha": 99})
            _submit_ssm(eng, cfg)
            if k > 1:
                seen = _record_accepts(eng)
            out[k] = {r.req_id: r.tokens for r in eng.run(500)}
            check_healthy(eng, f"f32 {arch} spec_len {k}")
        acc = _accepts(seen)
        partial = sum(1 < a < SPEC_LEN for a in acc)
        same, total = _same_tokens(out[SPEC_LEN], out[1])
        ok = out[SPEC_LEN] == out[1]
        note = ""
        if not ok:
            prompts = _ssm_prompts(cfg)
            i = next(i for i in out[1] if out[1][i] != out[SPEC_LEN].get(i))
            a, b = out[1][i], out[SPEC_LEN].get(i, [])
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            note = (f"; first divergence: request {i} token {j}, margin "
                    f"{_ssm_margin(cfg, params, prompts[i] + a[:j]):.3e}")
        check(ok and partial > 0,
              f"lossless f32 {arch} {depth} layers: spec_len {SPEC_LEN} "
              f"(cut draft, {cut} layers; mean accepted "
              f"{statistics.mean(acc):.3f}, {partial} partial accepts of "
              f"{len(acc)}) streams equal the spec_len 1 streams ({same} of "
              f"{total} tokens){note}")
        del params, draft


# ---------------------------------------------------------------------------
ALPHA_MS = [1, 2, 4, 8, 16, 32, 64, 128]


def phase_alpha() -> dict:
    """Phase 3e: the reference's offline α calibration (§5.2.1) on the
    card.  `calibrate_alpha_measured` times one layer's FC work on both
    paths at each m (host wall clock around callables that block on the
    device, median of 5 after a warm-up): run_pu = one torch.matmul per
    weight (7), run_pim = one fc_gemv launch per group (4), weights rotated
    past the L2.  Beside it, the same work's device time (CUDA events, the
    host ahead of the device) and the crossover that time gives."""
    gen = torch.Generator(device=DEV).manual_seed(11)
    out = {}
    for label, groups in (("qwen2-0.5b layer", FC_GROUPS),
                          ("zamba2-1.2b shared-block application",
                           ZAMBA_FC_GROUPS)):
        gbytes = sum(K * sum(ns) for K, ns in groups) * 2
        copies = max(2, math.ceil(2 * L2_BYTES / gbytes))
        run_pu, run_pim = fc_layer_runners(
            groups, max_m=max(ALPHA_MS), dtype=torch.bfloat16, device=DEV,
            generator=gen, copies=copies)
        alphas, walls = [], []
        for _ in range(3):              # three calibrations: their spread
            rec = {"pu": {}, "pim": {}}

            def recorded(fn, key, rec=rec):
                def run(m):
                    t0 = time.perf_counter()
                    fn(m)
                    rec[key].setdefault(m, []).append(
                        time.perf_counter() - t0)
                return run

            alphas.append(cal.calibrate_alpha_measured(
                recorded(run_pu, "pu"), recorded(run_pim, "pim"),
                ms=ALPHA_MS))
            # the medians of what calibrate_alpha_measured timed (warm-up
            # dropped), each taken inside its call
            walls.append({k: [statistics.median(v[m][1:]) * 1e3
                              for m in ALPHA_MS] for k, v in rec.items()})
        alpha, wall = alphas[0], walls[0]
        # device time of the same work, one layer's weight copy per call
        xs = {K: torch.randn(max(ALPHA_MS), K, generator=gen,
                             device=DEV).to(torch.bfloat16)
              for K, _ in groups}
        sets = [[[torch.randn(K, n, generator=gen, device=DEV).to(
            torch.bfloat16) for n in ns] for K, ns in groups]
            for _ in range(copies)]
        dev = {"pu": [], "pim": []}
        for m in ALPHA_MS:
            def pu(ws_layer, m=m):
                for (K, _), ws in zip(groups, ws_layer):
                    for w in ws:
                        torch.matmul(xs[K][:m], w)

            def pim(ws_layer, m=m):
                for (K, _), ws in zip(groups, ws_layer):
                    fc_mod.fc_gemv_group(xs[K][:m], ws)
            args = [(ws,) for ws in sets]
            dev["pu"].append(time_ms(pu, args))
            dev["pim"].append(time_ms(pim, args))
        alpha_dev = cal._crossover_alpha(ALPHA_MS, dev["pim"], dev["pu"])
        print(f"      alpha, {label} (bf16, {copies} weight copies): "
              "m | wall ms pu (7 torch.matmul) | wall ms pim (4 fc_gemv) | "
              "device ms pu | device ms pim", flush=True)
        for i, m in enumerate(ALPHA_MS):
            print(f"        {m:4d} | {wall['pu'][i]:.4f} | "
                  f"{wall['pim'][i]:.4f} | {dev['pu'][i]:.4f} | "
                  f"{dev['pim'][i]:.4f}", flush=True)
        print(f"      alpha, {label}: calibrate_alpha_measured (wall) "
              f"{alpha} (the first of three calibrations: {alphas}; their "
              "wall ms at m = 8, pu / pim: "
              + ", ".join(f"{w['pu'][3]:.4f} / {w['pim'][3]:.4f}"
                          for w in walls)
              + f"); the device-time crossover {alpha_dev}", flush=True)
        check(alpha in [0.5] + [m + 0.5 for m in ALPHA_MS],
              f"alpha {label}: {alpha} is a crossover of the grid")
        out[label] = (alpha, alpha_dev)
        del sets, xs, run_pu, run_pim
    return out


# ---------------------------------------------------------------------------
SPEC_LEN = 4


def _spec_engine(cfg, params, draft, **kw):
    base = dict(max_slots=8, cache_capacity=2048, prefill_len=64, alpha=4,
                attn_pim=True, spec_len=SPEC_LEN, draft=draft, device=DEV)
    return PapiEngine(cfg, params, **{**base, **kw})


def _submit_main(eng, cfg) -> None:
    """Phase 4's 8 requests (PROMPT_LENS, budgets 8 + 8 i, seed 0)."""
    rng = np.random.default_rng(0)
    for i, plen in enumerate(PROMPT_LENS):
        eng.submit(ServeRequest(i, rng.integers(3, cfg.vocab_size,
                                                size=plen).tolist(),
                                max_new_tokens=8 + 8 * i))


def _same_tokens(got: dict, want: dict) -> tuple[int, int]:
    """(tokens equal position by position, tokens in `want`)."""
    same = sum(sum(a == b for a, b in zip(got.get(i, []), t))
               for i, t in want.items())
    return same, sum(len(t) for t in want.values())


def _ran_variants(eng) -> list[str]:
    """The FC variant each decoding iteration ran: the scheduler's
    assignment when the step began (its events: the initial schedule, then
    one per iteration; set_tlp adds a flip between two)."""
    ran, cur, it = [], eng.scheduler.events[0].assignment, 0
    for ev in eng.scheduler.events[1:]:
        if ev.iteration == it:          # a set_tlp flip before step it+1
            cur = ev.assignment
            continue
        ran.append(cur)
        cur, it = ev.assignment, ev.iteration
    return ran


def _serve_spec(cfg, params, draft, label, plain, **kw) -> dict:
    """One speculative run of phase 4f with the launch counts set to 0
    just before `run()` and read just after."""
    eng = _spec_engine(cfg, params, draft, **kw)
    _submit_main(eng, cfg)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(max_iterations=500)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    by_m = dict(fc_mod.LAUNCHES_BY_M)
    paged = eng.kv is not None
    attn_by_t = dict((paged_mod if paged else attn_mod).LAUNCHES_BY_ROWS)

    streams = {r.req_id: r.tokens for r in results}
    reasons = sorted(r.finished_reason for r in results)
    check(len(results) == 8 and all(r in ("eos", "length") for r in reasons),
          f"{label}: 8 requests finished ({reasons})")
    check_healthy(eng, label)
    toks = [t for r in results for t in r.tokens]
    check(all(0 <= t < cfg.vocab_size for t in toks),
          f"{label}: {len(toks)} tokens within the vocabulary")
    spec_its = [s for s in eng.stats if s.admitted == 0]
    check(bool(spec_its) and all(s.transfers == 1 for s in spec_its),
          f"{label}: {len(spec_its)} speculative iterations without "
          "admission, one host transfer each")
    ran = _ran_variants(eng)
    n_pim = ran.count("pim")
    L, Ld = cfg.num_layers, draft[0].num_layers
    # each pim iteration: k draft steps at m = 8, one verify at m = 8 k,
    # 4 grouped launches per layer each
    check(launches["fc_gemv"] == 4 * (Ld * SPEC_LEN + L) * n_pim
          and by_m.get(8 * SPEC_LEN, 0) == 4 * L * n_pim,
          f"{label}: fc_gemv launched {launches['fc_gemv']} times ({by_m} "
          f"by m) in {n_pim} pim iterations of {len(ran)}: 4 x ({SPEC_LEN} "
          f"draft steps x {Ld} layers + the verify at m = {8 * SPEC_LEN} x "
          f"{L})")
    attn = "paged_decode_attention" if paged else "decode_attention"
    other = "decode_attention" if paged else "paged_decode_attention"
    check(attn_by_t.get(SPEC_LEN, 0) == L * len(ran)
          and attn_by_t.get(1, 0) == Ld * SPEC_LEN * len(ran)
          and launches[other] == 0 and launches["ssd_scan"] == 0,
          f"{label}: {attn} calls by window t {attn_by_t}: {L} at t = "
          f"{SPEC_LEN} (the verify) and {Ld * SPEC_LEN} at t = 1 (the "
          f"draft) per iteration, over {len(ran)} iterations")
    if paged:
        alloc = eng.kv.alloc
        alloc.check()
        check(alloc.mapped_count == 0 and alloc.reserved_unmapped == 0
              and alloc.free_count == alloc.num_pages,
              f"{label}: pool drained (watermark {alloc.watermark} of "
              f"{alloc.num_pages} pages)")
    acc = [s.accepted for s in eng.stats]
    same, total = _same_tokens(streams, plain)
    print(f"      {label}: {len(toks)} tokens in {eng.iteration} iterations "
          f"({n_pim} pim), {wall:.3f} s, {len(toks) / wall:.1f} tok/s; mean "
          f"accepted per window {statistics.mean(acc):.3f}; {same} of "
          f"{total} tokens equal the TLP = 1 run's; median iteration "
          f"{statistics.median(s.wall_s for s in spec_its) * 1e3:.2f} ms",
          flush=True)
    return {"streams": streams, "launches": launches,
            "accepted": statistics.mean(acc), "tok_s": len(toks) / wall}


# phase 4f's dense alpha 4 perfect-draft streams: phase 4j's fault-free twin
SPEC_STREAMS: dict = {}
# the seed-1 draft's depth in phase 4f (the script's limit)
SPEC_DRAFT_CUT = 6


def phase_spec(params, plain: dict) -> dict:
    """Phase 4f: speculative serving (spec_len 4, attn_pim) of phase 4's
    8 requests at full width, bf16: dense and paged, at alpha 4 (pu at m =
    32) and 99 (pim: fc_gemv at m = 32), with the perfect draft (the target
    itself) and a seed-1 draft of the same config cut to its first
    `SPEC_DRAFT_CUT` layers.  Returns the launches summed over the runs."""
    cfg = get_config("qwen2-0.5b")
    seed1 = _cut(cfg, init_params(cfg, torch.Generator(device=DEV)
                                  .manual_seed(1)), SPEC_DRAFT_CUT)
    runs = {}
    for layout in ("dense", "paged"):
        for alpha in (4, 99):
            for name, d in (("perfect draft", (cfg, params)),
                            ("seed-1 draft", seed1)):
                label = f"spec {layout} alpha={alpha} {name}"
                runs[layout, alpha, name] = _serve_spec(
                    cfg, params, d, label, plain, alpha=alpha,
                    kv_layout=layout, page_size=16)
    SPEC_STREAMS.update(runs["dense", 4, "perfect draft"]["streams"])
    for alpha in (4, 99):
        for name in ("perfect draft", "seed-1 draft"):
            check(runs["paged", alpha, name]["streams"]
                  == runs["dense", alpha, name]["streams"],
                  f"spec alpha={alpha} {name}: paged streams equal dense "
                  "streams")
    for layout in ("dense", "paged"):
        acc = runs[layout, 99, "perfect draft"]["accepted"]
        check(acc > 3.0, f"spec {layout}: the perfect draft accepts {acc:.3f} "
              f"of {SPEC_LEN} per window")
    check(any(r["launches"]["fc_gemv"] > 0 for k, r in runs.items()
              if k[1] == 99), "spec alpha=99: fc_gemv launched")
    del seed1
    total = {}
    for r in runs.values():
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def phase_tlp_register(params) -> None:
    """Phase 4g: the paper's dynamic flip driven by TLP.  alpha 12 on 8
    slots: at spec_len 1 the FC work has m = 8 <= 12 ("pim"); mid-run
    `set_spec_len(4)` makes m = 32 > 12 ("pu"), a reschedule the scheduler
    logs at once; as RLP decays to 3 (m = 12) it flips back."""
    cfg = get_config("qwen2-0.5b")
    eng = _spec_engine(cfg, params, (cfg, params), alpha=12, spec_len=1)
    _submit_main(eng, cfg)
    for _ in range(3):
        eng.step()                  # admission, then two decode steps
    before = fc_mod.LAUNCHES
    eng.set_spec_len(SPEC_LEN)
    flip = eng.scheduler.events[-1]
    results = eng.run(max_iterations=500)
    torch.cuda.synchronize()
    ran = _ran_variants(eng)
    print("      TLP register: scheduler events (iteration rlp tlp AI "
          "assignment rescheduled): " + "; ".join(
              f"{e.iteration} {e.rlp} {e.tlp} {e.ai_estimate:g} "
              f"{e.assignment}{' FLIP' if e.rescheduled else ''}"
              for e in eng.scheduler.events), flush=True)
    check(eng.spec_len == SPEC_LEN and flip.rescheduled and flip.tlp == SPEC_LEN
          and flip.assignment == "pu" and flip.ai_estimate == 8 * SPEC_LEN,
          f"TLP register: set_spec_len({SPEC_LEN}) at RLP 8 flips pim -> pu "
          f"at once (event: rlp {flip.rlp} tlp {flip.tlp} AI "
          f"{flip.ai_estimate} {flip.assignment}, rescheduled "
          f"{flip.rescheduled})")
    check(ran[:3] == ["pim", "pim", "pim"] or ran[1:3] == ["pim", "pim"],
          f"TLP register: the spec_len 1 iterations ran pim ({ran[:3]})")
    check(ran[3] == "pu" and fc_mod.LAUNCHES > before,
          f"TLP register: the first speculative iteration ran pu, and pim "
          f"ran again as RLP decayed ({ran})")
    check(len(results) == 8 and all(r.finished_reason in ("eos", "length")
                                    for r in results),
          "TLP register: 8 requests finished")
    check_healthy(eng, "TLP register")


SPEC_TRACE_DEPTH = 4


def phase_spec_trace(params) -> None:
    """Phase 5c: three steady speculative iterations (perfect draft,
    spec_len 4, 8 live requests) per KV layout and FC variant under
    torch.profiler: wall, device busy, FC-PIM and Attn-PIM device time and
    launches (by m and by window t) per iteration.  The model and its
    draft are cut to `SPEC_TRACE_DEPTH` of qwen2's 24 layers, to keep the
    script inside its time limit."""
    cfg, params = _cut(get_config("qwen2-0.5b"), params, SPEC_TRACE_DEPTH)
    rng = np.random.default_rng(5)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for layout, variant, alpha in (("dense", "pu", 0.0), ("dense", "pim", 99.0),
                                   ("paged", "pu", 0.0), ("paged", "pim", 99.0)):
        eng = _spec_engine(cfg, params, (cfg, params), alpha=alpha,
                           kv_layout=layout)
        for i in range(8):
            eng.submit(ServeRequest(i, rng.integers(
                3, cfg.vocab_size, size=32).tolist(), max_new_tokens=64))
        for _ in range(3):
            eng.step()                      # admission + warm iterations
        torch.cuda.synchronize()
        zero_counts()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                eng.step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_m = dict(fc_mod.LAUNCHES_BY_M)
        by_t = dict((paged_mod if layout == "paged"
                     else attn_mod).LAUNCHES_BY_ROWS)
        kern = _kernels(prof)
        if not kern:
            print(f"      spec trace {layout} {variant}: profiler saw no device "
                  "time (not measured)", flush=True)
            continue
        busy = sum(k[0] for k in kern)
        attn = [k for k in kern if "attn_split" in k[1]
                or "attn_merge" in k[1]]
        fc = [k for k in kern if "fc_gemv" in k[1]]
        top = sorted(kern, reverse=True)[:5]
        ran = {s.fc_variant for s in eng.stats[-4:-1]}
        print(f"      spec trace {layout} {variant} (ran {sorted(ran)}; "
              f"accepted {[s.accepted for s in eng.stats[-3:]]}): 3 "
              f"iterations {wall_us / 3e3:.2f} ms each, device busy "
              f"{busy / 3e3:.2f} ms each ({busy / wall_us:.1%}); FC-PIM "
              f"{sum(k[0] for k in fc) / 3e3:.4f} ms in "
              f"{sum(k[2] for k in fc) // 3} CUDA launches each (calls by m "
              f"over 3: {by_m}); Attn-PIM {sum(k[0] for k in attn) / 3e3:.4f}"
              f" ms in {sum(k[2] for k in attn) // 3} CUDA launches each "
              f"(calls by t over 3: {by_t}); {_guard_in_trace(prof, 3)}; "
              "top: "
              + "; ".join(f"{name[:40]} {dev / 3e3:.3f} ms x{cnt // 3}"
                          for dev, name, cnt in top), flush=True)
        check(by_t.get(SPEC_LEN, 0) == 3 * cfg.num_layers,
              f"spec trace {layout} {variant}: Attn-PIM at t = {SPEC_LEN} "
              f"{by_t.get(SPEC_LEN, 0)} calls in 3 iterations")


def phase_spec_parity() -> None:
    """Phase 6c: lossless in f32.  Full width, 2 layers, the kernels on
    (pim FC at alpha 99, Attn-PIM): the seed-1 draft's spec_len 4 streams
    must equal the spec_len 1 streams, dense and paged.  On a divergence,
    the first divergent position and the TLP = 1 top-1/top-2 logit margin
    there."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), num_layers=2,
                              dtype="float32")
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(3))
    draft = (cfg, init_params(cfg, torch.Generator(device=DEV).manual_seed(1)))
    for layout in ("dense", "paged"):
        out = {}
        for k in (1, SPEC_LEN):
            eng = _spec_engine(cfg, params, draft if k > 1 else None,
                               alpha=99, spec_len=k, kv_layout=layout,
                               eos_token=cfg.vocab_size)
            _submit_main(eng, cfg)
            out[k] = ({r.req_id: r.tokens for r in eng.run(500)},
                      [s.accepted for s in eng.stats])
        same, total = _same_tokens(out[SPEC_LEN][0], out[1][0])
        ok = out[SPEC_LEN][0] == out[1][0]
        note = ""
        if not ok:
            i = next(i for i in out[1][0] if out[1][0][i] != out[SPEC_LEN][0].get(i))
            a, b = out[1][0][i], out[SPEC_LEN][0].get(i, [])
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            note = (f"; first divergence: request {i} token {j}, margin "
                    f"{_top2_margin(cfg, params, i, a[:j]):.3e}")
        check(ok, f"lossless f32 2 layers {layout}: spec_len {SPEC_LEN} "
              f"(seed-1 draft, mean accepted "
              f"{statistics.mean(out[SPEC_LEN][1]):.3f}) streams equal the "
              f"spec_len 1 streams ({same} of {total} tokens){note}")


def _top2_margin(cfg, params, req_id: int, prefix: list) -> float:
    """The TLP = 1 top-1 minus top-2 logit after request `req_id`'s prompt
    and `prefix` of its output, by one prefill over the whole sequence."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist()
               for n in PROMPT_LENS]
    seq = prompts[req_id] + list(prefix)
    cache = init_cache(cfg, 1, len(seq), DEV)
    batch = {"tokens": torch.tensor([seq], dtype=torch.int32, device=DEV),
             "prompt_lens": torch.tensor([len(seq)], dtype=torch.int32,
                                         device=DEV)}
    logits, _ = prefill(cfg, params, batch, cache)
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


# ---------------------------------------------------------------------------
# serve(): the continuous-batching front end
ARRIVAL_RATE = 0.5      # requests per iteration, as `--arrivals 0.5`
MIXED_M = 8 * 64        # a mixed wave's FC rows: max_slots x prefill_len


def _main_schedule(cfg) -> list:
    """Phase 4's 8 requests on the launcher's seeded Poisson schedule: the
    prompts from default_rng(0), then the arrival gaps from the same
    generator (`launch.serve.arrival_schedule`)."""
    rng = np.random.default_rng(0)
    reqs = [ServeRequest(i, rng.integers(3, cfg.vocab_size,
                                         size=plen).tolist(),
                         max_new_tokens=8 + 8 * i)
            for i, plen in enumerate(PROMPT_LENS)]
    return arrival_schedule(reqs, ARRIVAL_RATE, rng)


def _consume(events, label: str) -> dict:
    """{req_id: ServeResult} of a serve() run, with the streamed tokens held
    equal to each result's."""
    streams, finals = {}, {}
    for ev in events:
        if ev.finished:
            finals[ev.req_id] = ev.result
        else:
            streams.setdefault(ev.req_id, []).append(ev.token)
    check(all(streams.get(i, []) == r.tokens for i, r in finals.items()),
          f"{label}: the streamed tokens equal each result's")
    return finals


def _expected_transfers(eng, st, chunk_wave: bool) -> int:
    """The fetches iteration `st` should take: one when it admitted a
    prompt that fits the window (its first token), one for the decode or
    the mixed wave, and, when speculating, one for a chunk wave that
    completed a prompt."""
    it = st.iteration - 1
    reqs = {r.req_id: r for r in eng.results}
    short = any(eng.admit_iteration.get(i) == it
                and r.prompt_len <= eng.prefill_len for i, r in reqs.items())
    if not chunk_wave:
        return int(short) + 1
    final = any(eng.first_token_iteration.get(i) == it
                and r.prompt_len > eng.prefill_len for i, r in reqs.items())
    return int(short) + int(final) + int(st.decode_slots > 0)


def _latencies(finals) -> str:
    summ = latency_summary(finals.values())
    return ", ".join(f"{f} p50 {summ[f]['p50']:.4g} p99 {summ[f]['p99']:.4g}"
                     for f in ("ttft_s", "tpot_s", "ttft_iters",
                               "queue_delay_iters"))


def _latency_line(label, finals, wall) -> str:
    toks = sum(len(r.tokens) for r in finals.values())
    return (f"      {label}: {toks} tokens in {wall:.3f} s, "
            f"{toks / wall:.1f} tok/s; " + _latencies(finals))


def _serve_live(cfg, params, label, plain, spec: bool, **kw) -> dict:
    """One serve() run of phases 4h / 4i with the launch counts set to 0
    just before the stream starts and read just after it ends."""
    base = dict(max_slots=8, cache_capacity=2048, prefill_len=64,
                attn_pim=True, device=DEV)
    if spec:
        base.update(spec_len=SPEC_LEN, draft=(cfg, params))
    eng = PapiEngine(cfg, params, **{**base, **kw})
    sched = _main_schedule(cfg)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    finals = _consume(eng.serve(sched, max_iterations=500), label)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    by_m = dict(fc_mod.LAUNCHES_BY_M)
    paged = eng.kv is not None
    by_t = dict((paged_mod if paged else attn_mod).LAUNCHES_BY_ROWS)

    reasons = sorted(r.finished_reason for r in finals.values())
    check(len(finals) == 8 and all(r in ("eos", "length") for r in reasons),
          f"{label}: 8 requests finished ({reasons})")
    check_healthy(eng, label)
    toks = [t for r in finals.values() for t in r.tokens]
    check(all(0 <= t < cfg.vocab_size for t in toks),
          f"{label}: {len(toks)} tokens within the vocabulary")
    ran = _ran_variants(eng)
    waves = [s for s in eng.stats if s.prefill_slots]
    mixed = [s for s in waves if s.decode_slots]
    plain_its = [s for s in eng.stats
                 if s.decode_slots and not s.prefill_slots]
    check(bool(mixed), f"{label}: {len(mixed)} mixed iterations (prefill and "
          f"decode slots both live) of {len(eng.stats)}")
    bad = [(s.iteration, s.transfers, _expected_transfers(eng, s, spec))
           for s in eng.stats
           if s.transfers != _expected_transfers(eng, s, spec)]
    quiet = {k: sorted({s.transfers for s in its if not s.admitted})
             for k, its in (("mixed", mixed), ("decode", plain_its))}
    what = ("one per speculative iteration, one per chunk wave that "
            "completes a prompt" if spec else "one per wave or decode step")
    check(not bad and (spec or quiet["mixed"] in ([], [1])),
          f"{label}: transfers {what}, one per admission of a short prompt "
          f"(iterations that admit nothing: {quiet}; off: {bad})")
    L = cfg.num_layers
    wave_pim = sum(1 for s in waves if ran[s.iteration - 1] == "pim")
    if spec:
        # chunk waves run the ambient FC variant ("pu"), as admission does,
        # on the target and on the draft (here of the target's depth)
        check(by_m.get(MIXED_M, 0) == 0
              and by_t.get(64, 0) == 2 * L * len(waves),
              f"{label}: {len(waves)} chunk waves, each under pu (no fc_gemv "
              f"at m = {MIXED_M}: {by_m.get(MIXED_M, 0)}) and Attn-PIM at "
              f"t = 64 once per layer of the target and of the draft "
              f"({by_t})")
    else:
        check(by_m.get(MIXED_M, 0) == 4 * L * wave_pim
              and by_t.get(64, 0) == L * len(waves),
              f"{label}: fc_gemv at m = {MIXED_M} launched "
              f"{by_m.get(MIXED_M, 0)} times = 4 x {L} layers x {wave_pim} "
              f"mixed waves that ran pim (of {len(waves)}); Attn-PIM at "
              f"t = 64 {by_t.get(64, 0)} calls ({by_m} by m)")
    attn = "paged_decode_attention" if paged else "decode_attention"
    other = "decode_attention" if paged else "paged_decode_attention"
    check(launches[attn] > 0 and launches[other] == 0
          and launches["ssd_scan"] == 0, f"{label}: launches {launches}")
    if paged:
        alloc = eng.kv.alloc
        alloc.check()
        check(alloc.mapped_count == 0 and alloc.reserved_unmapped == 0
              and alloc.free_count == alloc.num_pages,
              f"{label}: pool drained (watermark {alloc.watermark} of "
              f"{alloc.num_pages} pages)")
    streams = {i: r.tokens for i, r in finals.items()}
    same, total = _same_tokens(streams, plain)
    line = _latency_line(label, finals, wall)
    line += (f"; {len(eng.stats)} iterations, {len(mixed)} mixed, "
             f"{len(waves)} waves"
             + ("" if spec else f" ({wave_pim} on pim)")
             + f"; {same} of {total} tokens equal phase 4's offline streams")
    if mixed and plain_its:
        line += (f"; median wall: mixed iteration "
                 f"{statistics.median(s.wall_s for s in mixed) * 1e3:.2f} ms, "
                 "decode iteration "
                 f"{statistics.median(s.wall_s for s in plain_its) * 1e3:.2f}"
                 " ms")
    if spec:
        acc = [s.accepted for s in eng.stats if s.decode_slots]
        line += f"; mean accepted per window {statistics.mean(acc):.3f}"
    print(line, flush=True)
    return {"streams": streams, "launches": launches}


def phase_serve(params, plain: dict) -> dict:
    """Phases 4h and 4i: `PapiEngine.serve` at full width, bf16, on phase
    4's requests arriving at 0.5 a step.  4h: TLP = 1, dense and paged, at
    alpha 4 and 99; 4i: spec_len 4 with the perfect draft, dense and paged
    (alpha 99).  Paged streams must equal dense ones.  Returns the launches
    summed over the runs."""
    cfg = get_config("qwen2-0.5b")
    runs = {}
    for layout in ("dense", "paged"):
        for alpha in (4, 99):
            runs[layout, alpha] = _serve_live(
                cfg, params, f"serve {layout} alpha={alpha}", plain, False,
                alpha=alpha, kv_layout=layout)
        runs[layout, "spec"] = _serve_live(
            cfg, params, f"serve spec {layout} alpha=99 perfect draft", plain,
            True, alpha=99, kv_layout=layout)
    for key in (4, 99, "spec"):
        check(runs["paged", key]["streams"] == runs["dense", key]["streams"],
              f"serve {key}: paged streams equal dense streams")
    total: dict = {}
    for r in runs.values():
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def phase_serve_trace(params) -> None:
    """Phase 5d: three mixed waves at alpha 99 under torch.profiler, per KV
    layout: 4 requests decoding and 4 prompts of 320 tokens mid-prefill
    (chunk 0 and 1 ran at admission, the traced waves take chunks 2-4).
    The engine is stepped directly with `stream_chunks` on, as serve()
    runs it."""
    cfg = get_config("qwen2-0.5b")
    rng = np.random.default_rng(12)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    L = cfg.num_layers
    for layout in ("dense", "paged"):
        eng = PapiEngine(cfg, params, max_slots=8, cache_capacity=2048,
                         prefill_len=64, alpha=99.0, attn_pim=True,
                         kv_layout=layout, device=DEV)
        eng.stream_chunks = True
        for i in range(4):
            eng.submit(ServeRequest(i, rng.integers(
                3, cfg.vocab_size, size=32).tolist(), max_new_tokens=64))
        eng.step()
        eng.step()
        for i in range(4, 8):
            eng.submit(ServeRequest(i, rng.integers(
                3, cfg.vocab_size, size=320).tolist(), max_new_tokens=16))
        eng.step()                   # admission, chunk 0 and the first wave
        torch.cuda.synchronize()
        zero_counts()
        fc_by_wave = []                 # the wrapper's fc_gemv launches
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(3):
                with torch.profiler.record_function(f"serve_wave_{i}"):
                    eng.step()
                fc_by_wave.append(fc_mod.LAUNCHES - sum(fc_by_wave))
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_m = dict(fc_mod.LAUNCHES_BY_M)
        by_t = dict((paged_mod if layout == "paged"
                     else attn_mod).LAUNCHES_BY_ROWS)
        traced = eng.stats[-3:]
        check(all(s.prefill_slots == 4 and s.decode_slots == 4
                  and s.fc_variant == "pim" for s in traced)
              and by_m.get(MIXED_M, 0) == 3 * 4 * L
              and by_t.get(64, 0) == 3 * L,
              f"serve trace {layout}: 3 mixed waves of 4 prefill and 4 decode "
              f"rows on pim; fc_gemv by m {by_m}, Attn-PIM by t {by_t}")
        kern = _kernels(prof)
        if not kern:
            print(f"      serve trace {layout}: profiler saw no device time "
                  "(not measured)", flush=True)
            continue
        busy = sum(k[0] for k in kern)
        attn = [k for k in kern if "attn_split" in k[1]
                or "attn_merge" in k[1]]
        fc = [k for k in kern if "fc_gemv" in k[1]]
        top = sorted(kern, reverse=True)[:5]
        # each wave ends in a synchronizing fetch, so a kernel of wave i
        # starts inside wave i's host range
        evts = prof.events()
        spans = sorted((e.time_range.start, e.time_range.end) for e in evts
                       if e.name.startswith("serve_wave_")
                       and e.device_type == torch.autograd.DeviceType.CPU)
        fc_starts = [e.time_range.start for e in evts
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "fc_gemv" in e.name]
        seen = [sum(lo <= t <= hi for t in fc_starts) for lo, hi in spans]
        print(f"      serve trace {layout} pim: 3 mixed waves "
              f"{wall_us / 3e3:.2f} ms each, device busy {busy / 3e3:.2f} ms "
              f"each ({busy / wall_us:.1%}); FC-PIM "
              f"{sum(k[0] for k in fc) / 3e3:.4f} ms each over the "
              f"{sum(k[2] for k in fc)} of {sum(fc_by_wave)} CUDA launches "
              f"the profiler recorded in 3 waves (m = {MIXED_M}; per wave: "
              f"wrapper {fc_by_wave}, profiler {seen}, "
              f"{len(fc_starts) - sum(seen)} outside the waves); Attn-PIM "
              f"{sum(k[0] for k in attn) / 3e3:.4f} ms in "
              f"{sum(k[2] for k in attn)} CUDA launches over 3 waves "
              f"(t = 64); {_guard_in_trace(prof, 3)} wave; top: " + "; ".join(
                  f"{name[:40]} {dev / 3e3:.3f} ms x{cnt}/3"
                  for dev, name, cnt in top),
              flush=True)


def _edge_wave_cache(cfg, layout, gen, slots=8, cap=256, page=16):
    """A cache of `cap` positions a slot (dense, or shuffled pages) filled
    with random K/V: what the wave reads is the same on both paths."""
    if layout == "dense":
        cache = init_cache(cfg, slots, cap, DEV)
    else:
        cache = init_paged_cache(cfg, slots, slots * cap // page + 1, page,
                                 cap // page, DEV)
        cache["block_tables"] = (torch.randperm(
            slots * cap // page, generator=gen, device=DEV) + 1).to(
            torch.int32).reshape(slots, cap // page)
    for key in ("k", "v"):
        cache[key].copy_(torch.randn(cache[key].shape, generator=gen,
                                     device=DEV))
    return cache


def phase_serve_parity() -> None:
    """Phase 6d, f32, full width, 2 layers, kernels on (pim FC at alpha 99,
    Attn-PIM): the serve() streams of phase 4's requests on their Poisson
    schedule equal the offline run() streams, dense and paged (else the
    first divergence and the logit margin there).  Then one mixed wave
    whose decode rows sit within the window of the capacity (lens = pos +
    64 past the 256-row slab) against the plain path, dense and paged."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), num_layers=2,
                              dtype="float32")
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(3))
    for layout in ("dense", "paged"):
        kw = dict(max_slots=8, cache_capacity=2048, prefill_len=64,
                  alpha=99, attn_pim=True, kv_layout=layout,
                  eos_token=cfg.vocab_size, device=DEV)
        offline = PapiEngine(cfg, params, **kw)
        _submit_main(offline, cfg)
        want = {r.req_id: r.tokens for r in offline.run(500)}
        eng = PapiEngine(cfg, params, **kw)
        finals = _consume(eng.serve(_main_schedule(cfg), max_iterations=500),
                          f"serve f32 2 layers {layout}")
        got = {i: r.tokens for i, r in finals.items()}
        mixed = sum(1 for s in eng.stats if s.prefill_slots and s.decode_slots)
        same, total = _same_tokens(got, want)
        note = ""
        if got != want:
            i = next(i for i in want if want[i] != got.get(i))
            a, b = want[i], got.get(i, [])
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            note = (f"; first divergence: request {i} token {j}, margin "
                    f"{_top2_margin(cfg, params, i, a[:j]):.3e}")
        check(got == want and mixed > 0,
              f"serve f32 2 layers {layout}: the serve() streams ({mixed} "
              f"mixed iterations) equal the offline run() streams ({same} of "
              f"{total} tokens){note}")

    gen = torch.Generator(device=DEV).manual_seed(13)
    P, cap = 64, 256
    # rows: decodes at 253 and 250 (their windows run past the slab), at
    # 100 and 7; chunks pinned at 64 (full) and 128 (37 tokens); an idle
    # row; a chunk that ends the slab (192 + 64 = 256)
    lens = torch.tensor([1, 1, 1, 1, 64, 37, 0, 64], dtype=torch.int32,
                        device=DEV)
    pos = torch.tensor([253, 250, 100, 7, 5, 9, 1, 3], dtype=torch.int32,
                       device=DEV)
    pin = torch.tensor([0, 0, 0, 0, 1, 1, 0, 1], dtype=torch.bool, device=DEV)
    pin_pos = torch.tensor([0, 0, 0, 0, 64, 128, 0, 192], dtype=torch.int32,
                           device=DEV)
    toks = torch.randint(3, cfg.vocab_size, (8, P), generator=gen, device=DEV,
                         dtype=torch.int32)
    live = lens > 0
    for layout in ("dense", "paged"):
        cache = _edge_wave_cache(cfg, layout, gen)
        cache["pos"] = pos.clone()
        out = {}
        for fcv, impl in (("pu", "xla"), ("pim", "pim")):
            c = {k: v.clone() for k, v in cache.items()}
            with fc_variant(fcv), attn_impl(impl):
                out[fcv], c = mixed_step(cfg, params, c, toks, lens, pin,
                                         pin_pos)
            out[fcv + "_pos"] = c["pos"]
        torch.cuda.synchronize()
        err = (out["pim"][live] - out["pu"][live]).abs().max().item()
        check(err <= 1e-3 and bool(torch.isfinite(out["pim"][live]).all())
              and torch.equal(out["pim_pos"], out["pu_pos"]),
              f"mixed wave f32 2 layers {layout}: decode rows at 253 and 250 "
              f"(lens past the {cap}-row capacity), chunks and an idle row, "
              f"kernels vs plain max_abs_err {err:.3e} (tol 1e-3)")



# ---------------------------------------------------------------------------
# the failure model: preemption, faults and the finite-logits guard,
# cancel, deadlines and the watchdog
TIGHT_PAGES = 21        # 20 usable pages of 16 tokens: phase 4's requests
                        # reserve 3-11 pages each, so 2-3 fit at once
FAULT_WINDOW = dict(seed=7, nan_p=0.25, kernel_p=0.25, start=2, stop=40)


def _indexed_streams(events, label: str) -> tuple[dict, dict]:
    """({req_id: streamed tokens}, {req_id: result}) of a serve() run,
    checking that every token index comes once and in order and that each
    stream equals its result."""
    streams, finals, ok = {}, {}, True
    for ev in events:
        if ev.finished:
            finals[ev.req_id] = ev.result
            ok &= ev.index == len(streams.get(ev.req_id, []))
        else:
            got = streams.setdefault(ev.req_id, [])
            ok &= ev.index == len(got)
            got.append(ev.token)
    ok &= all(streams.get(i, []) == r.tokens for i, r in finals.items())
    check(ok, f"{label}: every token index once and in order, the streams "
          "equal the results")
    return streams, finals


def _check_drained(eng, label: str) -> None:
    alloc = eng.kv.alloc
    alloc.check()
    check(alloc.mapped_count == 0 and alloc.reserved_unmapped == 0
          and alloc.free_count == alloc.num_pages,
          f"{label}: pool drained (watermark {alloc.watermark} of "
          f"{alloc.num_pages} pages)")


def _preempting_serve(cfg, params, label, plain, alpha) -> dict:
    """Phase 4j: phase 4's requests through serve() on a pool of
    TIGHT_PAGES pages with preempt_after=3, the launch counts set to 0 just
    before the stream and read just after."""
    eng = PapiEngine(cfg, params, max_slots=8, cache_capacity=2048,
                     prefill_len=64, alpha=alpha, attn_pim=True,
                     kv_layout="paged", page_size=16, num_pages=TIGHT_PAGES,
                     preempt_after=3, debug_invariants=True,
                     eos_token=cfg.vocab_size, device=DEV)
    sched = _main_schedule(cfg)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams, finals = _indexed_streams(eng.serve(sched, max_iterations=2000),
                                       label)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    reasons = sorted(r.finished_reason for r in finals.values())
    check(len(finals) == 8 and set(reasons) == {"length"},
          f"{label}: 8 requests finish 'length' ({reasons})")
    check(eng.preemptions >= 1 and eng.degraded_steps == 0
          and sum(s.preemptions for s in eng.stats) == eng.preemptions,
          f"{label}: {eng.preemptions} preemptions "
          f"({sorted(eng.preempted_ids)} requeued), no step degraded")
    check(launches["paged_decode_attention"] > 0
          and launches["decode_attention"] == launches["ssd_scan"] == 0
          and (alpha < 99 or launches["fc_gemv"] > 0),
          f"{label}: launches {launches}")
    _check_drained(eng, label)
    same, total = _same_tokens(streams, plain)
    pre = [s.wall_s * 1e3 for s in eng.stats if s.preemptions]
    rest = [s.wall_s * 1e3 for s in eng.stats
            if not s.preemptions and s.decode_slots]
    toks = sum(len(t) for t in streams.values())
    print(f"      {label}: {toks} tokens in {eng.iteration} iterations, "
          f"{wall:.3f} s, {toks / wall:.1f} tok/s; {eng.preemptions} "
          f"preemptions (requests {sorted(eng.preempted_ids)}), deferral age "
          f"up to {max(s.deferral_age for s in eng.stats)}, page watermark "
          f"{eng.kv.alloc.watermark} of {eng.kv.alloc.num_pages}; median wall "
          f"of a preempting iteration {statistics.median(pre):.2f} ms, of "
          f"another decoding one {statistics.median(rest):.2f} ms; "
          + _latencies(finals)
          + f"; {same} of {total} tokens equal phase 4's offline streams",
          flush=True)
    return launches


def _faulted_run(cfg, params, label, want, spec: bool) -> dict:
    """Phase 4j: phase 4's requests offline (alpha 4, as phases 4 and 4f)
    with a nan / kernel fault window; every poisoned step is re-run on the
    engine's own kernels (a CUDA tensor goes to its kernel or raises)."""
    faults = FaultInjector(**FAULT_WINDOW)
    kw = dict(spec_len=SPEC_LEN, draft=(cfg, params)) if spec else {}
    eng = PapiEngine(cfg, params, max_slots=8, cache_capacity=2048,
                     prefill_len=64, alpha=4, attn_pim=True, faults=faults,
                     device=DEV, **kw)
    _submit_main(eng, cfg)
    warned = WARNINGS.n
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(max_iterations=500)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    fired = faults.counts["nan"] + faults.counts["kernel"]
    check(WARNINGS.n - warned == fired,
          f"{label}: {WARNINGS.n - warned} WARNING records on the "
          "repro_torch.serving logger, one per degraded step")
    reasons = sorted(r.finished_reason for r in results)
    check(len(results) == 8 and all(r in ("eos", "length") for r in reasons),
          f"{label}: 8 requests finished ({reasons})")
    deg = [s for s in eng.stats if s.degraded]
    check(fired >= 1 and eng.degraded_steps == fired == len(deg)
          and eng.preemptions == 0,
          f"{label}: degraded {eng.degraded_steps} = the injector's nan "
          f"{faults.counts['nan']} + kernel {faults.counts['kernel']}")
    quiet = [s for s in eng.stats if not s.admitted]
    check(all(s.transfers == 1 + s.degraded for s in quiet),
          f"{label}: one transfer a healthy iteration, two a degraded one "
          f"({sorted({(s.degraded, s.transfers) for s in quiet})})")
    check(launches["fc_gemv"] > 0 and launches["decode_attention"] > 0,
          f"{label}: launches {launches}")
    streams = {r.req_id: r.tokens for r in results}
    same, total = _same_tokens(streams, want)
    if not spec:
        # the re-run repeats the poisoned step on the same kernels
        check(streams == want, f"{label}: the streams equal the fault-free "
              f"run's in bf16 ({same} of {total} tokens)"
              + _first_divergence(streams, want))
    ok = [s.wall_s * 1e3 for s in quiet if not s.degraded]
    print(f"      {label}: window {FAULT_WINDOW['start']}-"
          f"{FAULT_WINDOW['stop']}, {faults.counts} fired, {len(deg)} "
          f"degraded steps; {sum(len(t) for t in streams.values())} tokens "
          f"in {eng.iteration} iterations, {wall:.3f} s; median wall of a "
          f"degraded iteration {statistics.median(s.wall_s for s in deg) * 1e3:.2f}"
          f" ms, of a healthy one {statistics.median(ok):.2f} ms; {same} of "
          f"{total} bf16 tokens equal the fault-free run's (a degraded "
          "speculative iteration is one t = 1 step where the verify ran "
          f"t = {SPEC_LEN})", flush=True)
    return launches


def _cancel_and_deadline(cfg, params) -> dict:
    """Phase 4j: through serve(), request 0 is cancelled after its 4th
    token, and request 8, queued behind 8 full slots, has a 5 s deadline
    that the (patched) clock passes at the same moment."""
    eng = PapiEngine(cfg, params, max_slots=8, cache_capacity=2048,
                     prefill_len=64, alpha=4, attn_pim=True, device=DEV)
    clock = {"now": 0.0}
    eng._now = lambda: clock["now"]
    rng = np.random.default_rng(0)
    reqs = [ServeRequest(i, rng.integers(3, cfg.vocab_size,
                                         size=plen).tolist(), 32)
            for i, plen in enumerate(PROMPT_LENS)]
    late = ServeRequest(8, rng.integers(3, cfg.vocab_size, size=40).tolist(),
                        16, deadline_s=5.0)
    events = []
    zero_counts()
    for ev in eng.serve([reqs, [late]], max_iterations=500):
        events.append(ev)
        if (not ev.finished and ev.req_id == 0 and ev.index == 3):
            clock["now"] = 10.0
            check(eng.cancel(0) and len(eng.queue) == 1,
                  "cancel/deadline: cancel(0) mid-stream, request 8 queued")
    launches = read_counts()
    streams, finals = _indexed_streams(events, "cancel/deadline")
    r0, r8 = finals.get(0), finals.get(8)
    check(r0 is not None and r0.finished_reason == "cancelled"
          and len(r0.tokens) >= 4 and r0.tokens == streams[0],
          f"cancel/deadline: request 0 cancelled with its "
          f"{len(r0.tokens) if r0 else 0} tokens so far")
    check(r8 is not None and r8.finished_reason == "timeout"
          and r8.tokens == [] and 8 not in streams,
          "cancel/deadline: queued request 8 times out, never streamed")
    others = sorted(finals[i].finished_reason for i in range(1, 8)
                    if i in finals)
    check(len(others) == 7 and set(others) <= {"eos", "length"},
          f"cancel/deadline: the other 7 finish ({others})")
    print(f"      cancel/deadline: request 0 cancelled after "
          f"{len(r0.tokens) if r0 else 0} tokens, request 8 timed out "
          f"queued; {eng.iteration} iterations", flush=True)
    return launches


def _stall(cfg, params) -> None:
    """Phase 4j: a head the pool never admits raises EngineStallError
    after stall_limit iterations, with its snapshot."""
    eng = PapiEngine(cfg, params, max_slots=8, cache_capacity=2048,
                     prefill_len=64, alpha=4, attn_pim=True,
                     kv_layout="paged", page_size=16, stall_limit=5,
                     device=DEV)
    eng.kv.can_admit = lambda *_: False
    eng.submit(ServeRequest(0, list(range(3, 40)), max_new_tokens=8))
    snap = None
    try:
        eng.run(max_iterations=100)
    except EngineStallError as err:
        snap = err.snapshot
    check(snap is not None and snap["queue"] == [0]
          and snap["deferral_age"] >= 5
          and snap["pool"]["free"] == eng.kv.alloc.num_pages
          and eng.iteration == 5,
          f"stall: EngineStallError at iteration {eng.iteration} with "
          f"snapshot {snap and {k: snap[k] for k in ('queue', 'deferral_age', 'stalled_iterations')}}")


def phase_failure(params, plain: dict) -> dict:
    """Phase 4j at full width, bf16, attn_pim: preemption through serve()
    on a tight pool (alpha 4 and 99), nan / kernel fault windows on the
    dense path and a speculative run (the perfect draft), cancel and a
    deadline through serve(), and the watchdog.  Returns the launches
    summed over the runs, each with the counts set to 0 just before it."""
    cfg = get_config("qwen2-0.5b")
    runs = [_preempting_serve(cfg, params, f"preempt paged alpha={a}",
                              plain, a) for a in (4, 99)]
    runs.append(_faulted_run(cfg, params, "faults dense alpha=4", plain,
                             False))
    runs.append(_faulted_run(cfg, params,
                             "faults spec dense alpha=4 perfect draft",
                             SPEC_STREAMS, True))
    runs.append(_cancel_and_deadline(cfg, params))
    _stall(cfg, params)
    total = {}
    for r in runs:
        for k, v in r.items():
            total[k] = total.get(k, 0) + v
    return total


def _first_divergence(got: dict, want: dict) -> str:
    if got == want:
        return ""
    i = next(i for i in want if want[i] != got.get(i))
    a, b = want[i], got.get(i, [])
    j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
             min(len(a), len(b)))
    return f"; first divergence: request {i} token {j}"


def phase_failure_parity() -> None:
    """Phase 6e, f32, full width, 2 layers, the kernels on (pim FC at
    alpha 99, Attn-PIM): preempted streams (paged, and paged speculative
    with the seed-1 draft) and streams under nan / kernel faults (dense,
    paged, speculative) equal the unconstrained fault-free dense run's;
    then reduced-depth f32 mamba2, whose admission runs ssd_scan: its
    faulted stream equals its fault-free one, so the SSM state of a
    poisoned step was restored."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), num_layers=2,
                              dtype="float32")
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(3))
    draft = (cfg, init_params(cfg, torch.Generator(device=DEV).manual_seed(1)))
    base = dict(max_slots=8, cache_capacity=2048, prefill_len=64, alpha=99,
                attn_pim=True, eos_token=cfg.vocab_size, device=DEV)

    def offline(**kw):
        eng = PapiEngine(cfg, params, **{**base, **kw})
        _submit_main(eng, cfg)
        return eng, {r.req_id: r.tokens for r in eng.run(1000)}

    _, want = offline()
    tight = dict(kv_layout="paged", page_size=16, num_pages=TIGHT_PAGES,
                 preempt_after=3, debug_invariants=True)
    spec = dict(spec_len=SPEC_LEN, draft=draft)
    cases = [("preempt paged", tight), ("preempt paged spec", {**tight, **spec}),
             ("faults dense", {}), ("faults paged", dict(kv_layout="paged")),
             ("faults spec", spec)]
    for name, kw in cases:
        if name.startswith("faults"):
            kw = {**kw, "faults": FaultInjector(**FAULT_WINDOW)}
        eng, got = offline(**kw)
        what = (f"{eng.preemptions} preemptions" if "preempt" in name
                else f"{eng.degraded_steps} degraded steps")
        n = eng.preemptions if "preempt" in name else eng.degraded_steps
        same, total = _same_tokens(got, want)
        check(got == want and n >= 1,
              f"f32 2 layers {name}: {what}, {same} of {total} tokens equal "
              f"the unconstrained fault-free dense run's"
              + _first_divergence(got, want))
        if eng.kv is not None:
            _check_drained(eng, f"f32 2 layers {name}")

    mcfg = dataclasses.replace(get_config("mamba2-1.3b"), num_layers=2,
                               dtype="float32")
    mparams = init_params(mcfg, torch.Generator(device=DEV).manual_seed(3))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(3, mcfg.vocab_size, size=n).tolist()
               for n in SSM_PROMPT_LENS]
    streams = {}
    for name, faults in (("clean", None),
                         ("faults", FaultInjector(**FAULT_WINDOW))):
        eng = PapiEngine(mcfg, mparams, faults=faults,
                         eos_token=mcfg.vocab_size, device=DEV, **SSM_ENGINE)
        for i, prompt in enumerate(prompts):
            eng.submit(ServeRequest(i, prompt, max_new_tokens=24))
        zero_counts()
        streams[name] = {r.req_id: r.tokens for r in eng.run(500)}
        if faults is not None:
            waves = sum(1 for s in eng.stats if s.admitted > 0)
            check(ssd_mod.LAUNCHES == mcfg.num_layers * waves
                  and eng.degraded_steps >= 1,
                  f"f32 mamba2 2 layers faults: ssd_scan launched "
                  f"{ssd_mod.LAUNCHES} times in {waves} admission wave(s), "
                  f"{eng.degraded_steps} degraded steps "
                  f"({faults.counts})")
    same, total = _same_tokens(streams["faults"], streams["clean"])
    check(streams["faults"] == streams["clean"],
          f"f32 mamba2 2 layers: the faulted streams equal the fault-free "
          f"ones ({same} of {total} tokens; the SSM state of each poisoned "
          "step was restored)"
          + _first_divergence(streams["faults"], streams["clean"]))


def phase_ssm_state_cost(params_by_arch) -> None:
    """Phase 5e: what keeping the pre-step SSM state costs on full-width
    mamba2-1.3b (8 slots).  A decode step writes its new state into fresh
    tensors, and the caching allocator hands back the ones of two steps
    before: the step's device time (torch.profiler, 3 steps, twice) and
    the memory reserved around the steps, against the copy out and back
    that keeping a copy would pay (CUDA events)."""
    cfg = get_config("mamba2-1.3b")
    params = params_by_arch[cfg.name]
    last = torch.randint(3, cfg.vocab_size, (8, 1), device=DEV,
                         dtype=torch.int32)
    cache = init_cache(cfg, 8, 1024, DEV)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    decode_step(cfg, params, cache, last)               # warm
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    busy = []
    for _ in range(2):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                decode_step(cfg, params, cache, last)
            torch.cuda.synchronize()
        busy.append(sum(k[0] for k in _kernels(prof)) / 3e3)
    grown = torch.cuda.memory_reserved() - reserved0
    state = cache["ssm"].ssm
    nbytes = sum(x.numel() * x.element_size() for x in cache["ssm"])
    spare = [torch.empty_like(x) for x in cache["ssm"]]

    def copy_both():
        for x, y in zip(cache["ssm"], spare):
            y.copy_(x)
            x.copy_(y)
    copy_ms = time_ms(copy_both, [()], reps=5)
    print(f"      SSM state keeping (mamba2-1.3b, 8 slots, {state.shape[0]} "
          f"layers, {nbytes / 1e6:.1f} MB of state): device busy of a decode "
          f"step writing fresh state {[round(x, 3) for x in busy]} ms; "
          f"memory reserved grew {grown / 1e6:.1f} MB over 6 steps; a copy "
          f"out and back {copy_ms:.3f} ms (bound "
          f"{4 * nbytes / 3.35e12 * 1e3:.3f} ms)", flush=True)
    del cache, spare


def phase_guard_cost() -> None:
    """Phase 5: the finite-logits guard alone at the steady iteration's
    logits shapes, bf16 over qwen2-0.5b's vocabulary: plain decode [8, 1,
    V], the verify [8, 4, V], a mixed wave [8, V]; CUDA events, and the
    kernels under its profiler range; bound: the logits read once."""
    V = get_config("qwen2-0.5b").vocab_size
    gen = torch.Generator(device=DEV).manual_seed(21)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for shape in ((8, 1, V), (8, 4, V), (8, V)):
        sets = [(torch.randn(shape, generator=gen, device=DEV).to(
            torch.bfloat16),) for _ in range(4)]
        ms = time_ms(_nonfinite, sets)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(5):
                _nonfinite(*sets[0])
            torch.cuda.synchronize()
        flag = _nonfinite(*sets[0]).item()
        sets[0][0][(0,) * (len(shape) - 1) + (5,)] = float("nan")
        check(not flag and _nonfinite(*sets[0]).item(),
              f"guard {list(shape)}: finite logits pass, one NaN is caught")
        nbytes = math.prod(shape) * 2
        print(f"      guard alone {list(shape)} bf16: {ms:.4f} ms a call "
              f"(CUDA events; bound {nbytes / 3.35e12 * 1e3:.5f} ms, bytes); "
              f"profiled: {_guard_in_trace(prof, 5)}", flush=True)
        del sets


# ---------------------------------------------------------------------------
# durable and observable serving: the journal, the tracer, the sanitizer
# a crash mid-run: phase 4's run takes ~65 iterations, the perfect-draft
# speculative one ~17
CRASH_AT, SPEC_CRASH_AT = 20, 8
CARD = ""               # the card's name and power limit, set by main()


def _work_dir():
    """A scratch directory under the checkout's (ignored) build/."""
    (ROOT / "build").mkdir(exist_ok=True)
    return tempfile.TemporaryDirectory(dir=ROOT / "build")


def _crash_and_restore(cfg, params, label, want, eng_kw, at=CRASH_AT):
    """Phase 4k / 6f: phase 4's requests with a journal and a crash fault
    at iteration `at`, then a fresh engine `restore()`s from the same file and
    completes.  Checks exactly-once finishes, that each recovered stream
    begins with its journaled tokens and that the extended journal
    replays to no unfinished request.  Returns (streams, {restore_ms,
    readmit_ms, resumed, durable}, launches)."""
    with _work_dir() as d:
        wal = str(Path(d) / "run.wal")
        eng = PapiEngine(cfg, params, journal=wal,
                         faults=FaultInjector(seed=0, crash_p=1.0, start=at,
                                              stop=at + 1),
                         device=DEV, **eng_kw)
        _submit_main(eng, cfg)
        zero_counts()
        crashed = None
        try:
            eng.run(max_iterations=500)
        except EngineCrashError as err:
            crashed = err.iteration
        eng.journal.close()
        state = recover(wal, eos_token=eng.eos_token)
        durable = {rid: f.tokens for rid, f in state.finished.items()}
        committed = {r.req_id: r.done for r in state.requests}
        fresh = PapiEngine(cfg, params, journal=wal, device=DEV, **eng_kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = fresh.restore(wal)
        restore_ms = (time.perf_counter() - t0) * 1e3
        fresh.step()                        # the re-admission wave
        torch.cuda.synchronize()
        readmit_ms = fresh.stats[0].wall_s * 1e3
        after = {r.req_id: r.tokens for r in fresh.run(max_iterations=500)}
        fresh.journal.close()
        launches = read_counts()
        final = recover(wal, eos_token=eng.eos_token)
        nbytes = Path(wal).stat().st_size
    check(crashed == at and info["resumed"] == len(committed) > 0,
          f"{label}: crashed at iteration {crashed}, {info['resumed']} "
          f"request(s) resumed, {len(durable)} finished before the crash")
    check(not set(durable) & set(after)
          and sorted({**durable, **after}) == list(range(8)),
          f"{label}: every request finished exactly once")
    check(all(after[i][:len(done)] == done for i, done in committed.items()),
          f"{label}: each recovered stream begins with its journaled "
          f"tokens ({sum(len(t) for t in committed.values())} tokens)")
    check(not final.requests and sorted(final.finished) == list(range(8)),
          f"{label}: the extended journal ({final.records} records, "
          f"{nbytes} bytes) replays to no unfinished request")
    streams = {**durable, **after}
    same, total = _same_tokens(streams, want)
    return streams, dict(restore_ms=restore_ms, readmit_ms=readmit_ms,
                         same=same, total=total,
                         resumed=info["resumed"]), launches


def phase_durability(params, plain: dict) -> dict:
    """Phase 4k: crash -> restore at full width, bf16, attn_pim, alpha 4:
    dense, paged, and speculative (spec_len 4, the perfect draft); then a
    snapshot of the crashed dense engine restored through a file.  bf16
    recovery is not claimed bit-identical: re-prefilling ``prompt + done``
    is not the computation of the decode steps that made ``done``.  Returns
    the launches summed over the runs."""
    cfg = get_config("qwen2-0.5b")
    base = dict(max_slots=8, cache_capacity=2048, prefill_len=64, alpha=4,
                attn_pim=True)
    cases = [("durable dense", {}, plain, CRASH_AT),
             ("durable paged", dict(kv_layout="paged", page_size=16), plain,
              CRASH_AT),
             ("durable spec dense perfect draft",
              dict(spec_len=SPEC_LEN, draft=(cfg, params)), SPEC_STREAMS,
              SPEC_CRASH_AT)]
    total = {}
    for label, kw, want, at in cases:
        _, m, launches = _crash_and_restore(cfg, params, label, want,
                                            {**base, **kw}, at)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        print(f"      {label} [{CARD}]: restore {m['restore_ms']:.3f} ms "
              f"({m['resumed']} requests), re-admission wave "
              f"{m['readmit_ms']:.2f} ms; {m['same']} of {m['total']} bf16 "
              "tokens equal the uncrashed run's", flush=True)

    eng = PapiEngine(cfg, params, faults=FaultInjector(
        seed=0, crash_p=1.0, start=CRASH_AT, stop=CRASH_AT + 1),
        device=DEV, **base)
    _submit_main(eng, cfg)
    try:
        eng.run(max_iterations=500)
    except EngineCrashError:
        pass
    with _work_dir() as d:
        snap = str(Path(d) / "engine.snap.json")
        state = eng.snapshot(snap)
        pre = {r.req_id: r.tokens for r in eng.results}
        fresh = PapiEngine(cfg, params, device=DEV, **base)
        info = fresh.restore(snap)
        after = {r.req_id: r.tokens for r in fresh.run(max_iterations=500)}
    check(info["resumed"] == len(state["requests"]) > 0
          and not set(pre) & set(after)
          and sorted({**pre, **after}) == list(range(8)),
          f"snapshot/restore: {info['resumed']} requests resumed from the "
          "snapshot file, every request finished exactly once")
    return total


def phase_durability_parity() -> None:
    """Phase 6f: recovery parity in f32 (full width, 2 layers, the kernels
    on: pim FC at alpha 99, Attn-PIM): the union of the durable and the
    post-crash streams equals the uncrashed run token for token, dense and
    paged, at spec_len 1 and 2 (the seed-1 draft)."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), num_layers=2,
                              dtype="float32")
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(3))
    draft = (cfg, init_params(cfg, torch.Generator(device=DEV).manual_seed(1)))
    base = dict(max_slots=8, cache_capacity=2048, prefill_len=64, alpha=99,
                attn_pim=True, eos_token=cfg.vocab_size)
    for layout in ("dense", "paged"):
        for spec in (1, 2):
            kw = dict(base)
            if layout == "paged":
                kw.update(kv_layout="paged", page_size=16)
            if spec > 1:
                kw.update(spec_len=spec, draft=draft)
            oracle = PapiEngine(cfg, params, device=DEV, **kw)
            _submit_main(oracle, cfg)
            want = {r.req_id: r.tokens for r in oracle.run(500)}
            label = f"f32 2 layers recovery {layout} spec_len {spec}"
            got, m, _ = _crash_and_restore(cfg, params, label, want, kw)
            check(got == want, f"{label}: {m['same']} of {m['total']} "
                  "tokens equal the uncrashed run's"
                  + _first_divergence(got, want))


def _program_counts(tracer) -> dict:
    return {k: t["count"] for k, t in tracer.program_table().items()}


def _traced_main(cfg, params, label, tracer, **kw) -> tuple[dict, object]:
    """Phase 4's requests offline at full width with eos off (so the
    schedule depends on lengths and budgets only); returns (streams,
    engine) with the wall in ``engine.wall_s``."""
    eng = PapiEngine(cfg, params, max_slots=8, cache_capacity=2048,
                     prefill_len=64, alpha=4, attn_pim=True,
                     eos_token=cfg.vocab_size, tracer=tracer, device=DEV,
                     **kw)
    _submit_main(eng, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(max_iterations=500)
    torch.cuda.synchronize()
    eng.wall_s = time.perf_counter() - t0
    return {r.req_id: r.tokens for r in results}, eng


def _cpu_schedule_programs(layout_kw: dict) -> dict:
    """The program table the same schedule gives on the CPU: the smoke
    twin (eos off, so lengths and budgets alone set the schedule) with the
    same engine settings and phase 4's prompt lengths and budgets."""
    cfg = get_config("qwen2-0.5b-smoke")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tr = Tracer()
    eng = PapiEngine(cfg, params, max_slots=8, cache_capacity=2048,
                     prefill_len=64, alpha=4, attn_pim=True,
                     eos_token=cfg.vocab_size, tracer=tr, device="cpu",
                     **layout_kw)
    _submit_main(eng, cfg)
    eng.run(max_iterations=500)
    return _program_counts(tr)


def phase_tracing(params) -> dict:
    """Phase 4l: phase 4's run untraced and traced, dense and paged: equal
    streams, one transfer per steady iteration traced, the program table's
    keys and counts equal to those of the same schedule on the CPU, the
    tracer's overhead in tokens/s and the per-key mean ms (CUDA events).
    A chrome and a jsonl trace go through `tools/trace_report.py
    --validate` as subprocesses.  Returns the launches of the traced
    runs."""
    cfg = get_config("qwen2-0.5b")
    total = {}
    for layout, kw in (("dense", {}),
                       ("paged", dict(kv_layout="paged", page_size=16))):
        label = f"traced {layout}"
        plain, eng0 = _traced_main(cfg, params, f"untraced {layout}", None,
                                   **kw)
        tr = Tracer()
        zero_counts()
        got, eng = _traced_main(cfg, params, label, tr, **kw)
        for k, v in read_counts().items():
            total[k] = total.get(k, 0) + v
        check(got == plain, f"{label}: the streams equal the untraced "
              "run's")
        steady = [s for s in eng.stats if not s.admitted]
        check(bool(steady) and all(s.transfers == 1 for s in steady),
              f"{label}: {len(steady)} steady iterations, one host "
              "transfer each with the tracer on")
        table = tr.program_table()
        want = _cpu_schedule_programs(kw)
        check(_program_counts(tr) == want,
              f"{label}: program keys and counts {_program_counts(tr)} "
              f"equal the CPU schedule's")
        check(all(t["total_s"] > 0 for t in table.values()) and not tr._pending,
              f"{label}: every program key timed by CUDA events")
        toks = sum(len(t) for t in got.values())
        print(f"      {label} [{CARD}]: {toks / eng0.wall_s:.1f} tok/s "
              f"untraced, {toks / eng.wall_s:.1f} traced "
              f"({eng.wall_s / eng0.wall_s:.3f}x wall); {tr.emitted} events; "
              "mean ms per call (CUDA events, stream time start to stop): "
              + ", ".join(f"{k} {t['mean_s'] * 1e3:.3f} x{t['count']}"
                          for k, t in table.items()), flush=True)
        if layout == "dense":
            with _work_dir() as d:
                for fmt in ("chrome", "jsonl"):
                    path = Path(d) / f"trace.{fmt}"
                    write_trace(tr, path, fmt)
                    out = subprocess.run(
                        [sys.executable, str(ROOT / "tools" / "trace_report.py"),
                         str(path), "--validate"], capture_output=True,
                        text=True, timeout=120)
                    check(out.returncode == 0,
                          f"{label}: tools/trace_report.py --validate "
                          f"accepts the {fmt} trace "
                          f"({path.stat().st_size} bytes)"
                          + ("" if out.returncode == 0 else
                             f": {out.stdout[-300:]} {out.stderr[-300:]}"))
    return total


def phase_ssm_decode_trace(params_by_arch) -> None:
    """Phase 4l: phase 4d's mamba2-1.3b requests traced (the 600-token
    one rejected): the per-key table of its admission wave and decode
    steps (CUDA events)."""
    cfg = get_config("mamba2-1.3b")
    tr = Tracer()
    eng = PapiEngine(cfg, params_by_arch[cfg.name], tracer=tr, device=DEV,
                     **SSM_ENGINE)
    _submit_ssm(eng, cfg)
    results = eng.run(max_iterations=500)
    steady = [s for s in eng.stats if not s.admitted]
    check(len(results) == 9 and all(s.transfers == 1 for s in steady),
          f"traced mamba2-1.3b: 9 requests, one transfer per steady "
          f"iteration ({len(steady)})")
    table = tr.program_table()
    walls = [s.wall_s * 1e3 for s in steady]
    print(f"      traced mamba2-1.3b [{CARD}]: median steady iteration wall "
          f"{statistics.median(walls):.2f} ms; per key (CUDA events, "
          "stream time start to stop): "
          + ", ".join(f"{k} mean {t['mean_s'] * 1e3:.3f} ms min "
                      f"{t['min_s'] * 1e3:.3f} x{t['count']}"
                      for k, t in table.items()), flush=True)


def phase_sanitizer(params) -> None:
    """Phase 4m: phase 4's run dense and paged and 4f's perfect-draft run
    with ``sanitize=True`` (sync-debug mode "error" around every step):
    no SanitizeError, one transfer per steady iteration; then a
    deliberate ``.item()`` inside a sanitized step raises, and the
    sync-debug mode is back to its previous value after the phase."""
    cfg = get_config("qwen2-0.5b")
    before = torch.cuda.get_sync_debug_mode()
    cases = [("sanitized dense", {}),
             ("sanitized paged", dict(kv_layout="paged", page_size=16)),
             ("sanitized spec dense perfect draft",
              dict(spec_len=SPEC_LEN, draft=(cfg, params)))]
    for label, kw in cases:
        eng = PapiEngine(cfg, params, max_slots=8, cache_capacity=2048,
                         prefill_len=64, alpha=4, attn_pim=True,
                         sanitize=True, device=DEV, **kw)
        _submit_main(eng, cfg)
        err = None
        try:
            results = eng.run(max_iterations=500)
        except SanitizeError as exc:
            err, results = exc, []
        rep = eng.sanitize_report()
        check(err is None and len(results) == 8
              and rep.steady_iterations > 0
              and rep.transfers_per_steady_iter == 1.0,
              f"{label} [{CARD}]: {rep.steady_iterations}/{rep.iterations} "
              f"steady iterations at {rep.transfers_per_steady_iter} "
              f"transfers each, {rep.programs} program keys"
              + (f"; {err}" if err else ""))
    eng = PapiEngine(cfg, params, max_slots=8, cache_capacity=2048,
                     prefill_len=64, alpha=4, attn_pim=True, sanitize=True,
                     device=DEV)
    real = eng._fetch

    def leaky(*tensors):
        tensors[0].sum().item()          # a host sync outside the scope
        return real(*tensors)

    eng._fetch = leaky
    _submit_main(eng, cfg)
    raised = None
    try:
        eng.run(max_iterations=500)
    except SanitizeError as exc:
        raised = exc
    check(raised is not None and "synchroniz" in str(raised),
          f"sanitizer: a deliberate .item() inside a sanitized step raises "
          f"({str(raised)[:80] if raised else 'nothing raised'})")
    check(torch.cuda.get_sync_debug_mode() == before,
          f"sanitizer: sync-debug mode back to {before} after the phase")


def phase_journal_cost(params) -> None:
    """Journal cost: phase 4's dense run with no journal, and with the
    ``flush`` and ``fsync`` policies: tokens/s, bytes and records."""
    cfg = get_config("qwen2-0.5b")
    rows = []
    for policy in (None, "flush", "fsync"):
        with _work_dir() as d:
            wal = Path(d) / "cost.wal"
            journal = None if policy is None else Journal(wal, flush=policy)
            eng = PapiEngine(cfg, params, max_slots=8, cache_capacity=2048,
                             prefill_len=64, alpha=4, attn_pim=True,
                             journal=journal, device=DEV)
            _submit_main(eng, cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = eng.run(max_iterations=500)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            nbytes = records = 0
            if journal is not None:
                journal.close()
                nbytes = wal.stat().st_size
                records = len(read_records(wal)[0])
            toks = sum(len(r.tokens) for r in results)
            check(len(results) == 8, f"journal {policy}: 8 requests "
                  "finished")
            rows.append(f"{policy or 'none'} {toks / wall:.1f} tok/s "
                        f"({records} records, {nbytes} bytes)")
    print(f"      journal cost, phase 4 dense [{CARD}]: " + "; ".join(rows),
          flush=True)


# ---------------------------------------------------------------------------
# the other decoder families at full width: olmoe-1b-7b (MoE), granite-8b
# (dense) and qwen2-vl-7b (M-RoPE) at their published depth; deepseek-67b
# (untied head) and command-r-plus-104b (layernorm) at published widths and
# the depth (None: published) that fits one 80 GB card in bf16
FAMILY_PATHS = [("olmoe-1b-7b", 4), ("granite-8b", 8),
                ("qwen2-vl-7b", 7), ("deepseek-67b", 8),
                ("command-r-plus-104b", 4), ("gpt3-175b", 2)]
# f32, 2 layers: the streams held token for token against the plain path
FAMILY_PARITY = ("olmoe-1b-7b", "qwen2-vl-7b", "command-r-plus-104b",
                 "deepseek-67b")


def family_cfg(arch: str, depth: int | None = None, dtype: str | None = None):
    cfg = get_config(arch)
    kw = {k: v for k, v in (("num_layers", depth), ("dtype", dtype)) if v}
    return dataclasses.replace(cfg, **kw) if kw else cfg


def fc_groups(cfg) -> list:
    """(K, [N of each weight]) of one layer's FC-PIM launches under "pim":
    q/k/v and the out projection; gate/up (a gelu MLP's w_in) and down
    (w_out) unless the MLP is MoE (its experts are plain matmuls, as the
    reference's einsums)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    groups = [(d, [q, kv, kv]), (q, [d])]
    if cfg.moe is None:
        up = [cfg.d_ff] * (2 if cfg.mlp == "swiglu" else 1)
        groups += [(d, up), (cfg.d_ff, [d])]
    return groups


def _attn_bound(lens, t, nkv, g, hd) -> tuple[float, str]:
    """The least time of one bf16 Attn-PIM call: each live K/V row read
    once, q and out moved once, 4 t g hd operations per live row."""
    kv_bytes = sum(lens) * 2 * nkv * hd * 2
    io_bytes = 2 * len(lens) * nkv * t * g * hd * 2
    return bound(kv_bytes + io_bytes, 4 * sum(lens) * nkv * t * g * hd,
                 torch.bfloat16)


FAMILY_LENS = {1: [1, 32, 33, 2048, 100, 513, 1000, 7],
               4: [4, 5, 36, 2048, 100, 513, 1000, 7],
               64: [64, 65, 96, 2048, 128, 513, 1000, 200]}


def phase_family_kernels() -> None:
    """Phase 3f: fc_gemv at every FC group of one layer of each family
    model (f32 at m = 8; bf16 at m = 8, 32 and 512), decode_attention and
    paged_decode_attention at hd 128 with each model's GQA geometry (t = 1,
    4, 64; S = 2048; pages of 16), held against their plain versions, the
    paged kernel bit-equal to the dense one; then each layer's FC groups
    and the attention at t = 1 and 64 timed (bf16, m = 8) beside the
    library call and the bound."""
    gen = torch.Generator(device=DEV).manual_seed(14)
    for arch, _ in FAMILY_PATHS:
        cfg = get_config(arch)
        for dtype, ms in ((torch.float32, (8,)),
                          (torch.bfloat16, (8, 32, 512))):
            for K, ns in fc_groups(cfg):
                ws = [(torch.randn(K, n, generator=gen, device=DEV)
                       / math.sqrt(K)).to(dtype) for n in ns]
                for m in ms:
                    x = torch.randn(m, K, generator=gen, device=DEV).to(dtype)
                    ys = fc_mod.fc_gemv_group(x, ws)
                    torch.cuda.synchronize()
                    errs = [max_err(y, fc_mod.fc_gemv_ref(x, w))
                            for y, w in zip(ys, ws)]
                    check(all(ok for _, ok, _ in errs)
                          and all(y.shape == (m, n) for y, n in zip(ys, ns)),
                          f"fc_gemv_group {str(dtype)[6:]} {arch} m={m} K={K} "
                          f"N={ns} ({fc_plan_note(K, ns)}): max_abs_err "
                          f"{max(e for e, _, _ in errs):.3e} "
                          f"(tol {errs[0][2]})")
                del ws
        nkv, g, hd = cfg.num_kv_heads, cfg.group_size, cfg.resolved_head_dim
        for dtype in (torch.float32, torch.bfloat16):
            for t, lens in FAMILY_LENS.items():
                q, k, v, ln = _attn_inputs(gen, dtype, t, lens, nkv=nkv, g=g,
                                           hd=hd)
                got = attn_mod.decode_attention(q, k, v, ln, q_rows=t)
                kp, vp, clean, _ = _paged_pool(gen, dtype, lens, 16, nkv=nkv,
                                               hd=hd)
                paged = paged_mod.paged_decode_attention(q, kp, vp, ln, clean,
                                                         q_rows=t)
                blocks = clean[:, :2048 // 16]
                dense = attn_mod.decode_attention(
                    q, paged_mod.gather_kv_pages(kp, blocks).contiguous(),
                    paged_mod.gather_kv_pages(vp, blocks).contiguous(), ln,
                    q_rows=t)
                torch.cuda.synchronize()
                err, ok, tol = max_err(
                    got, attn_mod.decode_attention_ref(q, k, v, ln, t))
                perr, pok, _ = max_err(paged, paged_mod.paged_decode_attention_ref(
                    q, kp, vp, ln, clean, t))
                check(ok and pok and bool(torch.isfinite(got).all())
                      and torch.equal(paged, dense),
                      f"decode_attention / paged {str(dtype)[6:]} {arch} t={t} "
                      f"nkv={nkv} g={g} hd={hd} S=2048 "
                      f"({plan_note(8, nkv, t * g)}): max_abs_err dense "
                      f"{err:.3e}, paged {perr:.3e} (tol {tol}), paged "
                      "bit-equal to dense")
                del q, k, v, kp, vp
        _fc_group_times(gen, fc_groups(cfg), f"one {arch} layer", reps=3)
        for t in (1, 64):
            lens = FAMILY_LENS[t]
            sets = [_attn_inputs(gen, torch.bfloat16, t, lens, nkv=nkv, g=g,
                                 hd=hd) for _ in range(6)]
            k_ms = time_ms(lambda q, k, v, ln: attn_mod.decode_attention(
                q, k, v, ln, q_rows=t), sets, reps=3)
            p_ms = time_ms(lambda q, k, v, ln: attn_mod.decode_attention_ref(
                q, k, v, ln, t), sets, reps=3)
            l_ms = time_ms(_sdpa, [_sdpa_args(*s, t) for s in sets], reps=3)
            b_ms, b_by = _attn_bound(lens, t, nkv, g, hd)
            print(f"      decode_attention bf16 {arch} t={t} b=8 nkv={nkv} "
                  f"g={g} hd={hd} S=2048: kernel {k_ms:.4f} ms "
                  f"({plan_note(8, nkv, t * g)}), plain {p_ms:.4f} ms, sdpa "
                  f"{l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
            del sets


def _family_run(cfg, params, label: str, layout: str, alpha: float,
                sanitize: bool = False):
    """Phase 4's 8 requests through one engine (attn_pim), the launch
    counts set to 0 just before `run()` and read just after.  Every steady
    iteration makes the engine's `transfer_budget` host transfers (one,
    plus one per MoE layer); ``sanitize`` runs it under the sanitizer,
    which holds them to it.  Returns ({req_id: tokens}, launches)."""
    eng = PapiEngine(cfg, params, max_slots=8, cache_capacity=2048,
                     prefill_len=64, alpha=alpha, attn_pim=True,
                     kv_layout=layout, page_size=16, sanitize=sanitize,
                     device=DEV)
    _submit_main(eng, cfg)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(max_iterations=500)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    reasons = sorted(r.finished_reason for r in results)
    check(len(results) == 8 and all(r in ("eos", "length") for r in reasons),
          f"{label}: 8 requests finished ({reasons})")
    check_healthy(eng, label)
    toks = [t for r in results for t in r.tokens]
    check(len(toks) > 0 and all(0 <= t < cfg.vocab_size for t in toks),
          f"{label}: {len(toks)} tokens within the vocabulary")
    attn = "paged_decode_attention" if layout == "paged" else "decode_attention"
    other = "decode_attention" if layout == "paged" else "paged_decode_attention"
    # alpha 0 runs "pu" but for the first decode step (RLP is 0 at the
    # initial schedule, as in the reference); alpha 99 "pim" throughout
    variants = {s.fc_variant for s in eng.stats}
    per_step = len(fc_groups(cfg)) * cfg.num_layers
    check(launches[attn] > 0 and launches[other] == launches["ssd_scan"] == 0
          and (launches["fc_gemv"] > 0) == ("pim" in variants)
          and launches["fc_gemv"] % per_step == 0
          and (variants == {"pim"} if alpha > 8 else "pu" in variants),
          f"{label}: FC variants {sorted(variants)}, launches {launches} "
          f"(fc_gemv {len(fc_groups(cfg))} per layer of each pim step)")
    steady = [s for s in eng.stats if s.admitted == 0]
    budget = 1 + (cfg.num_layers if cfg.moe is not None else 0)
    check(bool(steady) and eng.transfer_budget == budget
          and all(s.transfers == budget for s in steady),
          f"{label}: {len(steady)} steady iterations, {budget} host "
          "transfer(s) each (the fetch, one per MoE layer)")
    if sanitize:
        rep = eng.sanitize_report()
        check(rep.steady_iterations > 0 and rep.transfer_budget == budget
              and rep.transfers_per_steady_iter == budget
              and torch.cuda.get_sync_debug_mode() == 0,
              f"{label}: {rep.steady_iterations} sanitized steady iterations "
              f"at {rep.transfers_per_steady_iter} transfers each (budget "
              f"{rep.transfer_budget}), sync-debug mode back to default")
    if layout == "paged":
        _check_drained(eng, label)
    med = statistics.median(s.wall_s * 1e3 for s in steady)
    print(f"      {label}: {len(toks)} tokens in {eng.iteration} iterations, "
          f"{wall:.3f} s, {len(toks) / wall:.1f} tok/s; median steady "
          f"iteration {med:.2f} ms ({len(steady)} its)", flush=True)
    return {r.req_id: r.tokens for r in results}, launches


def _family_trace(cfg, params) -> None:
    """Phase 5f: five steady granite-8b iterations (8 live requests,
    dense, alpha 99: FC-PIM every step) under torch.profiler: busy share,
    and FC-PIM's device time against its byte bound (every layer's FC
    weights streamed once)."""
    rng = np.random.default_rng(15)
    eng = PapiEngine(cfg, params, max_slots=8, cache_capacity=2048,
                     prefill_len=64, alpha=99, attn_pim=True, device=DEV)
    for i in range(8):
        eng.submit(ServeRequest(i, rng.integers(3, cfg.vocab_size,
                                                size=32).tolist(),
                                max_new_tokens=32))
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = _kernels(prof)
    w_bytes = sum(K * sum(ns) for K, ns in fc_groups(cfg)) * 2 * cfg.num_layers
    b_ms, _ = bound(w_bytes, 0, torch.bfloat16)
    if not kern:
        print(f"      trace {cfg.name}: profiler saw no device time (not "
              "measured)", flush=True)
        return
    busy = sum(k[0] for k in kern)
    fc = [k for k in kern if "fc_gemv" in k[1]]
    attn = [k for k in kern if "attn_split" in k[1] or "attn_merge" in k[1]]
    fc_ms = sum(k[0] for k in fc) / 5e3
    top = sorted(kern, reverse=True)[:5]
    check(all(s.transfers == 1 and s.fc_variant == "pim"
              for s in eng.stats[-5:]),
          f"trace {cfg.name}: five pim iterations, one transfer each")
    print(f"      trace {cfg.name} dense pim: 5 steady iterations "
          f"{wall_us / 5e3:.2f} ms each, device busy {busy / 5e3:.2f} ms each "
          f"({busy / wall_us:.1%}); FC-PIM {fc_ms:.4f} ms in "
          f"{sum(k[2] for k in fc) // 5} CUDA launches each ({fc_ms / (busy / 5e3):.1%} "
          f"of busy), bound {b_ms:.4f} ms ({w_bytes / 1e6:.0f} MB of FC "
          f"weights at 3.35 TB/s, {b_ms / fc_ms:.1%} of it); Attn-PIM "
          f"{sum(k[0] for k in attn) / 5e3:.4f} ms; top: "
          + "; ".join(f"{name[:40]} {dev / 5e3:.3f} ms x{cnt // 5}"
                      for dev, name, cnt in top), flush=True)


def phase_family_paths() -> dict:
    """Phases 4n and 5f: each family model at full width, bf16, random
    weights from seed 0, one resident at a time, serves phase 4's 8
    requests dense and paged, under "pu" (alpha 0) and "pim" (alpha 99);
    paged streams equal dense ones per variant, and pu's tokens equal to
    pim's are counted; an MoE model also serves dense pim under the
    sanitizer.  granite-8b's steady iteration is traced (5f).
    Returns the kernels' launches summed over the runs."""
    total = dict.fromkeys(MODS, 0)
    for arch, depth in FAMILY_PATHS:
        cfg = family_cfg(arch, depth)
        torch.cuda.empty_cache()
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0))
        weights = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()   # the init's f32 transients
        name = f"{arch}" + (f" ({depth} of {get_config(arch).num_layers} "
                            "layers)" if depth else "")
        out = {}
        for alpha, variant in ((0.0, "pu"), (99.0, "pim")):
            for layout in ("dense", "paged"):
                out[layout, variant], ln = _family_run(
                    cfg, params, f"{name} {layout} {variant}", layout, alpha)
                for k, n in ln.items():
                    total[k] += n
            check(out["paged", variant] == out["dense", variant],
                  f"{name} {variant}: the paged streams equal the dense ones")
        if cfg.moe is not None:
            got, ln = _family_run(cfg, params, f"{name} dense pim sanitized",
                                  "dense", 99.0, sanitize=True)
            for k, n in ln.items():
                total[k] += n
            check(got == out["dense", "pim"],
                  f"{name}: the sanitized streams equal the unsanitized ones")
        same, n = _same_tokens(out["dense", "pim"], out["dense", "pu"])
        print(f"      {name}: {same} of {n} bf16 tokens under pim equal pu's; "
              f"weights {weights:.2f} GiB, peak memory while serving "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
              flush=True)
        if arch == "granite-8b":
            _family_trace(cfg, params)
        del params
    torch.cuda.empty_cache()
    return total


def phase_family_parity() -> None:
    """Phase 6g: f32, full width, 2 layers.  Phase 4's 8 requests (eos
    off) through the kernels (alpha 99: fc_gemv every step and mixed wave;
    Attn-PIM) by run() and serve() (phase 4h's Poisson schedule), dense and
    paged, equal the plain path's run() (pu, plain attention) token for
    token; olmoe also speculating (spec_len 2, the perfect draft)."""
    for arch in FAMILY_PARITY:
        cfg = family_cfg(arch, 2, "float32")
        torch.cuda.empty_cache()
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(3))
        base = dict(max_slots=8, cache_capacity=2048, prefill_len=64,
                    eos_token=cfg.vocab_size, device=DEV)
        plain = PapiEngine(cfg, params, alpha=0, **base)
        _submit_main(plain, cfg)
        want = {r.req_id: r.tokens for r in plain.run(500)}
        runs = []
        for layout in ("dense", "paged"):
            kw = dict(base, alpha=99, attn_pim=True, kv_layout=layout)
            eng = PapiEngine(cfg, params, **kw)
            _submit_main(eng, cfg)
            runs.append((f"run() {layout}",
                         {r.req_id: r.tokens for r in eng.run(500)}))
            eng = PapiEngine(cfg, params, **kw)
            finals = _consume(eng.serve(_main_schedule(cfg), max_iterations=500),
                              f"{arch} f32 2 layers serve() {layout}")
            runs.append((f"serve() {layout}",
                         {i: r.tokens for i, r in finals.items()}))
            if cfg.moe is not None:
                eng = PapiEngine(cfg, params, spec_len=2, draft=(cfg, params),
                                 **kw)
                _submit_main(eng, cfg)
                runs.append((f"spec_len 2 {layout}",
                             {r.req_id: r.tokens for r in eng.run(500)}))
        for what, got in runs:
            same, total = _same_tokens(got, want)
            note = ""
            if got != want:
                i = next(i for i in want if want[i] != got.get(i))
                a, b = want[i], got.get(i, [])
                j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
                note = (f"; first divergence: request {i} token {j}, margin "
                        f"{_top2_margin(cfg, params, i, a[:j]):.3e}")
            check(got == want, f"{arch} f32 2 layers, kernels, {what}: the "
                  f"streams equal the plain path's ({same} of {total} "
                  f"tokens){note}")
        del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 7: training
# ---------------------------------------------------------------------------
TRAIN_DATA = dict(batch=8, seq_len=512)
TRAIN_ACCUM = 2
TRAIN_OPT = dict(lr=3e-4, warmup_steps=5)
TRAIN_STEPS = 30
TRAIN_MAIN_DEPTH = 8
TRAIN_FITS = ("hubert-xlarge", "mamba2-1.3b", "zamba2-1.2b",
              "granite-moe-1b-a400m")
TRAIN_TOO_BIG = ("olmoe-1b-7b", "qwen2-vl-7b", "granite-8b", "deepseek-67b",
                 "command-r-plus-104b")
# bytes a parameter takes to train with AdamW: the bf16 weight and
# gradient, the f32 first and second moments
TRAIN_BYTES_PER_PARAM = 12


def param_count(cfg) -> int:
    def walk(tree):
        return sum(walk(v) if isinstance(v, dict) else math.prod(v.shape)
                   for v in tree.values())
    return walk(model_spec(cfg))


def _microbatches(raw: dict) -> dict:
    return {k: v.reshape((TRAIN_ACCUM, v.shape[0] // TRAIN_ACCUM)
                         + v.shape[1:]) for k, v in raw.items()}


def _finite(xs) -> bool:
    return bool(xs) and all(math.isfinite(x) for x in xs)


def phase_train_main() -> None:
    """Phase 7a: full-width qwen2-0.5b, cut to `TRAIN_MAIN_DEPTH` of its 24
    layers (the script's limit), through `run_training`, checkpoint at
    step 20, resume to 30 against the uninterrupted run."""
    cfg = family_cfg("qwen2-0.5b", TRAIN_MAIN_DEPTH)
    dcfg = DataConfig(**TRAIN_DATA)
    ocfg = AdamWConfig(total_steps=TRAIN_STEPS, **TRAIN_OPT)
    tokens = dcfg.batch * dcfg.seq_len
    with _work_dir() as d:
        tcfg = TrainConfig(steps=TRAIN_STEPS, accum=TRAIN_ACCUM, remat=True,
                           checkpoint_every=20, checkpoint_dir=d,
                           log_every=10, seed=0)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run_training(cfg, tcfg, dcfg, ocfg, device=DEV)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = res.losses
        check(len(losses) == TRAIN_STEPS and _finite(losses),
              f"7a qwen2-0.5b: {len(losses)} losses, all finite")
        first = statistics.mean(losses[:5])
        last = statistics.mean(losses[-5:])
        check(last < first - 0.2, f"7a qwen2-0.5b: the loss falls from "
              f"{first:.4f} (mean of steps 0-4) to {last:.4f} (25-29), by "
              "more than 0.2")
        ckpt = CheckpointManager(d)
        check(ckpt.all_steps() == [20, TRAIN_STEPS],
              f"7a: checkpoints at steps {ckpt.all_steps()}")
        shutil.rmtree(Path(d) / f"step_{TRAIN_STEPS:08d}")
        t0 = time.perf_counter()
        res2 = run_training(cfg, tcfg, dcfg, ocfg, resume=True, device=DEV)
        wall2 = time.perf_counter() - t0
        rel = max((abs(a - b) / abs(b)
                   for a, b in zip(res2.losses, losses[20:])), default=0.0)
        check(res2.resumed_from == 20 and len(res2.losses) == 10
              and _finite(res2.losses) and rel <= 2e-2,
              f"7a: resumed from {res2.resumed_from}, "
              f"{len(res2.losses)} losses, within {rel:.2e} relative of "
              "the uninterrupted run's steps 20-29 (limit 2e-2)")
    med = statistics.median(res.step_s[5:])
    print(f"      7a qwen2-0.5b [{CARD}]: losses "
          + " ".join(f"{x:.3f}" for x in losses)
          + f"; resumed {' '.join(f'{x:.3f}' for x in res2.losses)}",
          flush=True)
    print(f"      7a qwen2-0.5b [{CARD}]: step wall median "
          f"{med * 1e3:.1f} ms over steps 5-{TRAIN_STEPS - 1} ({tokens} "
          f"tokens a step: batch {dcfg.batch} x seq {dcfg.seq_len}, accum "
          f"{TRAIN_ACCUM}, remat), {tokens / med:.0f} training tokens/s; "
          f"peak memory {peak:.2f} GiB; run {wall:.1f} s of which steps "
          f"{sum(res.step_s):.1f} s (the rest: weights, checkpoints at 20 "
          f"and {TRAIN_STEPS}); resume {wall2:.1f} s of which steps "
          f"{sum(res2.step_s):.1f} s", flush=True)
    _train_trace(cfg)


def _train_trace(cfg) -> None:
    """Phase 7a's trace: two train steps of `cfg` (after two warm ones)
    under torch.profiler: device busy share, CUDA launches and the
    kernels that take the most."""
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0))
    opt = init_adamw(params)
    step_fn = make_train_step(cfg, AdamWConfig(total_steps=4, **TRAIN_OPT),
                              accum=TRAIN_ACCUM, remat=True)
    batches = [to_device(_microbatches(make_batch(
        cfg, DataConfig(**TRAIN_DATA), s)), DEV) for s in range(4)]
    for b in batches[:2]:
        params, opt, _, m = step_fn(params, opt, {}, b)
    float(m["loss"])
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in batches[2:]:
            params, opt, _, m = step_fn(params, opt, {}, b)
            float(m["loss"])
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = sorted(_kernels(prof), reverse=True)
    busy = sum(k[0] for k in kern)
    launches = sum(k[2] for k in kern)
    if not kern:
        print("      7a trace: not measured (no device time in the trace)",
              flush=True)
    else:
        top = "; ".join(f"{name[:48]} {us / 2e3:.2f} ms x{n // 2}"
                        for us, name, n in kern[:6])
        print(f"      7a trace {cfg.name} [{CARD}], per step (2 traced): "
              f"wall {wall_us / 2e3:.1f} ms, device busy {busy / 2e3:.1f} "
              f"ms ({100 * busy / wall_us:.1f}%), {launches // 2} CUDA "
              f"launches; top kernels: {top}", flush=True)
    del params, opt
    torch.cuda.empty_cache()


def _train_steps(cfg, steps: int) -> dict:
    """`steps` train steps of `cfg` from seed 0 (batch, accum, remat and
    AdamW of phase 7), timed one by one.  Returns losses, gradient norms,
    walls, the peak memory and the weights' GiB."""
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0))
    weights = torch.cuda.memory_allocated() / 2 ** 30
    opt = init_adamw(params)
    step_fn = make_train_step(cfg, AdamWConfig(total_steps=steps,
                                               **TRAIN_OPT),
                              accum=TRAIN_ACCUM, remat=True)
    dcfg = DataConfig(**TRAIN_DATA)
    torch.cuda.reset_peak_memory_stats()
    out = {"loss": [], "grad_norm": [], "wall": []}
    err = {}
    for step in range(steps):
        batch = to_device(_microbatches(make_batch(cfg, dcfg, step)), DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, err, m = step_fn(params, opt, err, batch)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["wall"].append(time.perf_counter() - t0)
    out["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["weights"] = weights
    if cfg.moe is not None:
        with torch.no_grad():
            _, met = forward_train(cfg, params,
                                   {k: v[0] for k, v in batch.items()})
        out["aux"] = float(met["aux"])
    del params, opt
    torch.cuda.empty_cache()
    return out


def phase_train_families() -> None:
    """Phase 7b: 5 steps of each other family that fits one card, at a
    quarter of its published depth (to keep the script inside its time
    limit)."""
    for arch in TRAIN_FITS:
        cfg = family_cfg(arch, depth=get_config(arch).num_layers // 4)
        t0 = time.perf_counter()
        r = _train_steps(cfg, 5)
        wall = time.perf_counter() - t0
        check(_finite(r["loss"]) and _finite(r["grad_norm"]),
              f"7b {arch}: finite losses "
              + " ".join(f"{x:.3f}" for x in r["loss"])
              + " and gradient norms "
              + " ".join(f"{x:.3f}" for x in r["grad_norm"]))
        if "aux" in r:
            check(r["aux"] > 0, f"7b {arch}: the aux loss {r['aux']:.4f} > 0")
        tokens = TRAIN_DATA["batch"] * TRAIN_DATA["seq_len"]
        med = statistics.median(r["wall"][1:])
        print(f"      7b {arch} [{CARD}] ({cfg.num_layers} of "
              f"{get_config(arch).num_layers} layers, "
              f"{param_count(cfg) / 1e9:.3f} B parameters, weights "
              f"{r['weights']:.2f} GiB): step wall median {med * 1e3:.1f} ms "
              f"over steps 1-4 (step 0 {r['wall'][0] * 1e3:.1f} ms), "
              f"{tokens / med:.0f} tokens/s, peak memory {r['peak']:.2f} "
              f"GiB; {wall:.1f} s with the weights' init", flush=True)
    total = torch.cuda.get_device_properties(0).total_memory
    for arch in TRAIN_TOO_BIG:
        n = param_count(get_config(arch))
        need = n * TRAIN_BYTES_PER_PARAM
        print(f"      7b {arch}: not trained here: {n / 1e9:.2f} B "
              f"parameters x {TRAIN_BYTES_PER_PARAM} bytes (bf16 weight and "
              f"gradient, f32 moments) = {need / 2 ** 30:.1f} GiB before "
              f"activations and the f32 gradient sum of accum (4 bytes "
              f"more), against the card's {total / 2 ** 30:.1f} GiB",
              flush=True)


def _clone_to(tree, device):
    if isinstance(tree, dict):
        return {k: _clone_to(v, device) for k, v in tree.items()}
    return tree.detach().clone().to(device)


def phase_train_parity() -> None:
    """Phase 7c: f32 smoke twins, the card against the CPU: the first
    step's gradients, then 3 train steps from the same weights."""
    tol = 1e-4
    ocfg = AdamWConfig(lr=1e-5, warmup_steps=0, total_steps=3)
    for arch, seq in (("qwen2-0.5b", 64), ("mamba2-1.3b", 64)):
        cfg = get_config(arch + "-smoke")
        host = init_params(cfg, torch.Generator().manual_seed(0))
        dcfg = DataConfig(batch=4, seq_len=seq)
        runs = []
        for dev in (torch.device("cpu"), DEV):
            params = _clone_to(host, dev)
            ps = leaves(params)
            for p in ps:
                p.requires_grad_(True)
            batch0 = to_device(make_batch(cfg, dcfg, 0), dev)
            grads = torch.autograd.grad(
                forward_train(cfg, params, batch0)[0], ps)
            opt = init_adamw(params)
            step_fn = make_train_step(cfg, ocfg, accum=2, remat=True)
            met = []
            for step in range(3):
                batch = to_device(_microbatches(make_batch(cfg, dcfg, step)),
                                  dev)
                params, opt, _, m = step_fn(params, opt, {}, batch)
                met.append((float(m["loss"]), float(m["grad_norm"])))
            runs.append((met, [g.cpu() for g in grads],
                         [p.detach().cpu() for p in leaves(params)]))

        def worst(a, b):
            return max(float(((x - y).abs() / (tol + tol * y.abs())).max())
                       for x, y in zip(a, b))

        (mc, gc, pc), (md, gd, pd) = runs
        scal = max(abs(x - y) / (tol + tol * abs(y)) for a, b in zip(md, mc)
                   for x, y in zip(a, b))
        g_err, p_err = worst(gd, gc), worst(pd, pc)
        check(max(scal, g_err, p_err) <= 1.0,
              f"7c {cfg.name} f32: card vs CPU, losses and gradient norms of "
              f"3 steps at {scal:.3f}, the first step's gradients at "
              f"{g_err:.3f}, the parameters after 3 steps at {p_err:.3f} of "
              f"the tolerance (1e-4 + 1e-4 |cpu|)")


def phase_train_launcher() -> None:
    """Phase 7e: the training launcher at full width, 4 steps."""
    with _work_dir() as d:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            train_cli.main(["--arch", "qwen2-0.5b", "--steps", "4",
                            "--checkpoint-dir", d])
        wall = time.perf_counter() - t0
        done = [x for x in buf.getvalue().splitlines()
                if x.startswith("done:")]
        check(len(done) == 1 and done[0].startswith("done: 4 steps")
              and CheckpointManager(d).all_steps() == [4],
              f"7e launcher --arch qwen2-0.5b --steps 4: {done} in "
              f"{wall:.1f} s, checkpoint at step 4")


def phase_training() -> dict:
    """Phase 7 (7a-7e).  Returns the kernels' launches over it (all 0)."""
    zero_counts()
    phase_train_main()
    phase_train_families()
    phase_train_parity()
    phase_train_launcher()
    launches = read_counts()
    check(not any(launches.values()),
          f"7d: no kernel launched on the train path ({launches})")
    x = torch.randn(8, 896, device=DEV, requires_grad=True)
    w = torch.randn(896, 896, device=DEV)
    try:
        fc_mod.fc_gemv(x, w)
        refused = "returned a tensor"
    except RuntimeError as e:
        refused = str(e)
    check("fc_gemv has no backward" in refused and fc_mod.LAUNCHES == 0,
          f"7d: fc_gemv under autograd raises ({refused[:60]})")
    return launches


# ---------------------------------------------------------------------------
# Phase 7f: the train cell over the data axis and, since the tensor split
# of training, over (data, model): four ranks on this card
TRAIN_MESH_ARCH = "qwen2-0.5b"
TRAIN_MESH_DEPTH = 4
TRAIN_MESH_CELL = ShapeCell("train_mesh", 256, 8, "train")
TRAIN_MESH_FAMILIES = ("olmoe-1b-7b", "mamba2-1.3b", "hubert-xlarge",
                       "qwen2-vl-7b")
# eps 1e-6: Adam's first update of an element is lr * g / (|g| + eps),
# which for |g| near 1e-8 turns on the gradient's last bits, and the card
# sums a split batch's gradient in another order than one rank's GEMM
# (1.01e-4 apart after 3 steps at eps 1e-8, measured on one H100)
TRAIN_MESH_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-6)
TRAIN_MESH_STEPS, TRAIN_MESH_MORE = 3, 2
TRAIN_MESH_TIMEOUT_S = 600
# the tensor split: qwen2 at (2, 2) (7 of its 14 heads a rank) and (1, 4)
# (its heads whole, the FFN and the vocabulary split), the residual over
# the sequence on "model"; the VLM and audio twins at (2, 2)
TRAIN_TP_MESHES = ((2, 2), (1, 4))
TRAIN_TP_FAMILIES = ("qwen2-vl-7b", "hubert-xlarge")


def _tm_rows(cfg, step: int, shards: int, mesh, device) -> dict:
    """This rank's rows of step's global batch, which `shards` pipeline
    shards draw (rank r of a (shards, 1) mesh: exactly shard r)."""
    parts = [draw_train_batch(cfg, TRAIN_MESH_CELL, step, shards=shards,
                              shard=r) for r in range(shards)]
    return {k: local_block(torch.from_numpy(np.concatenate(
        [p[k] for p in parts])), ("data",), mesh).to(device)
        for k in parts[0]}


def _tm_specs(cfg, rules, mesh) -> dict:
    specs = param_shardings(cfg, rules, mesh)
    return {"params": specs, "opt": AdamWState((), specs, specs)}


def _tm_train(cfg, mesh, device, *, steps: int, start: int = 0,
              state=None, shards: int = 2, save=None) -> dict:
    """`steps` train steps of `cfg` on this rank of `mesh` (None: one
    rank) from seed-0 weights or from `state`; `save` = (directory,
    step): a checkpoint over the mesh after that step.  From seed-0
    weights it first takes the first step's gradients, gathered whole."""
    built = build_step(cfg, TRAIN_MESH_CELL, mesh, accum=1,
                       ocfg=AdamWConfig(**TRAIN_MESH_OPT))
    m = mesh or local_mesh(device)
    out = {"losses": [], "walls": []}
    if state is None:
        full = init_params(cfg, torch.Generator(device=device).manual_seed(0))
        params = shard_params(cfg, full, built.rules, m)
        del full
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
        with axis_rules(built.rules, m):
            loss, _ = forward_train(cfg, params, _tm_rows(cfg, start, shards,
                                                          m, device))
            grads = torch.autograd.grad(loss, ps)
        out["grads"] = unshard_params(cfg, unflatten(params, list(grads)),
                                      built.rules, m)
        del grads, loss
        state = (params, init_adamw(params))
    params, opt = state
    coll = 0
    for step in range(start, start + steps):
        batch = _tm_rows(cfg, step, shards, m, device)
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), m.collectives
        params, opt, loss = built.fn(params, opt, batch)
        out["losses"].append(float(loss))
        out["walls"].append(time.perf_counter() - t0)
        coll += m.collectives - c0
        if save is not None and step + 1 == save[1]:
            CheckpointManager(save[0]).save(
                step + 1, {"params": params, "opt": opt},
                shardings=_tm_specs(cfg, built.rules, m), mesh=m)
    with axis_rules(built.rules, m):
        out["reckoned"] = collectives_per_train_step(
            cfg, seq_len=TRAIN_MESH_CELL.seq_len)
    out["collectives"] = coll / steps
    out["weight_bytes"] = sum(4 * p.numel() for p in leaves(params))
    out["moment_bytes"] = sum(4 * x.numel()
                              for x in leaves(opt.m) + leaves(opt.v))
    out["state"], out["rules"], out["mesh"] = (params, opt), built.rules, m
    return out


def _tm_gather(cfg, run) -> dict:
    """The run's parameters gathered whole (a collective on its mesh)."""
    return unshard_params(cfg, run["state"][0], run["rules"], run["mesh"])


def _tm_diff(got: dict, want: dict) -> float:
    return max(float((a.detach() - b.detach()).abs().max())
               for a, b in zip(leaves(got), leaves(want)))


def _tm_grad_err(got: dict, want: dict) -> float:
    """The largest gradient difference over the largest gradient."""
    top = max(float(g.abs().max()) for g in leaves(want))
    return _tm_diff(got, want) / top


def _tm_rel(got: list, want: list) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _tm_summary(run: dict) -> dict:
    return {k: run[k] for k in ("losses", "walls", "collectives",
                                "reckoned", "weight_bytes", "moment_bytes")}


def _train_mesh_rank(rank: int, device, ckpt_dir: str) -> dict:
    """One rank of phase 7f's world of 4: the (2, 1) runs (qwen2 on
    ranks 0-1, the families on ranks 2-3), the elastic restores, then the
    tensor split's runs on every rank (`_train_tp_runs`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh4 = make_serving_mesh(4, 1, device=device)
    mesh2 = make_serving_mesh(2, 1, device=device)
    tp_meshes = [make_serving_mesh(*shape, device=device)
                 for shape in TRAIN_TP_MESHES]
    res = {"coords4": dict(mesh4.coords), "coords2": dict(mesh2.coords)}
    one_state = None
    lead = mesh2.rank == 0
    cfg = family_cfg(TRAIN_MESH_ARCH, TRAIN_MESH_DEPTH, "float32")
    if rank < 2:
        total = TRAIN_MESH_STEPS + TRAIN_MESH_MORE
        run = _tm_train(cfg, mesh2, device, steps=total,
                        save=(ckpt_dir, TRAIN_MESH_STEPS))
        res["qwen2"] = _tm_summary(run)
        whole = _tm_gather(cfg, run)
        grads = run["grads"]
        del run
        if lead:
            ck = CheckpointManager(ckpt_dir)
            at3 = ck.restore(TRAIN_MESH_STEPS, {"params": whole},
                             device)["params"]
            one = _tm_train(cfg, None, device, steps=TRAIN_MESH_STEPS)
            res["one"] = _tm_summary(one)
            res["param_err"] = _tm_diff(at3, one["state"][0])
            res["grad_err"] = _tm_grad_err(grads, one["grads"])
            one_state = (one["state"][0], one["grads"])
            del one, at3
        del grads
        res["uninterrupted"] = whole if lead else None
    else:
        res["families"] = {}
        for arch in TRAIN_MESH_FAMILIES:
            fcfg = get_config(arch + "-smoke")
            run = _tm_train(fcfg, mesh2, device, steps=TRAIN_MESH_STEPS)
            whole = _tm_gather(fcfg, run)
            got, run_grads = _tm_summary(run), run["grads"]
            del run
            if lead:
                one = _tm_train(fcfg, None, device, steps=TRAIN_MESH_STEPS)
                got["one_losses"] = one["losses"]
                got["param_err"] = _tm_diff(whole, one["state"][0])
                got["grad_err"] = _tm_grad_err(run_grads, one["grads"])
                del one
            res["families"][arch] = got
    mesh4.barrier()
    ck = CheckpointManager(ckpt_dir)
    built = build_step(cfg, TRAIN_MESH_CELL, mesh4)
    p_meta, o_meta, _ = built.args
    t0 = time.perf_counter()
    got = ck.restore(TRAIN_MESH_STEPS, {"params": p_meta, "opt": o_meta},
                     device, shardings=_tm_specs(cfg, built.rules, mesh4),
                     mesh=mesh4)
    res["restore_s"] = time.perf_counter() - t0
    run = _tm_train(cfg, mesh4, device, steps=TRAIN_MESH_MORE,
                    start=TRAIN_MESH_STEPS,
                    state=(got["params"], got["opt"]))
    res["resumed4"] = _tm_summary(run)
    res["weights4"] = run["weight_bytes"]
    whole4 = _tm_gather(cfg, run)
    del run, got
    if rank == 0:
        res["resumed4_err"] = _tm_diff(whole4, res["uninterrupted"])
        got = ck.restore(TRAIN_MESH_STEPS, {"params": p_meta,
                                            "opt": o_meta}, device)
        run = _tm_train(cfg, None, device, steps=TRAIN_MESH_MORE,
                        start=TRAIN_MESH_STEPS,
                        state=(got["params"], got["opt"]))
        res["resumed1"] = _tm_summary(run)
        res["resumed1_err"] = _tm_diff(run["state"][0],
                                       res["uninterrupted"])
        del run, got
    res["uninterrupted"] = None
    res["tp"] = _train_tp_runs(cfg, tp_meshes, device, one_state)
    res["launches"] = read_counts()
    return res


def _train_tp_run(cfg, mesh, device, one) -> dict:
    """3 steps of `cfg` on `mesh` from seed-0 weights; on rank 0, the
    distance of the first step's gathered gradients and of the gathered
    parameters from `one`'s (params, grads) of the one-rank step."""
    run = _tm_train(cfg, mesh, device, steps=TRAIN_MESH_STEPS)
    whole, grads = _tm_gather(cfg, run), run["grads"]
    got = _tm_summary(run)
    del run
    if one is not None:
        got["param_err"] = _tm_diff(whole, one[0])
        got["grad_err"] = _tm_grad_err(grads, one[1])
    return got


def _train_tp_runs(cfg, meshes, device, one_state) -> dict:
    """The tensor split (tp > 1, every rank): qwen2 on each mesh of
    `TRAIN_TP_MESHES` against rank 0's one-rank run (`one_state`), the
    VLM and audio twins at (2, 2) against rank 0's one-rank runs."""
    out = {}
    for shape, mesh in zip(TRAIN_TP_MESHES, meshes):
        out[(TRAIN_MESH_ARCH, shape)] = _train_tp_run(cfg, mesh, device,
                                                      one_state)
    del one_state
    for arch in TRAIN_TP_FAMILIES:
        fcfg = get_config(arch + "-smoke")
        one = None
        if meshes[0].rank == 0:
            run = _tm_train(fcfg, None, device, steps=TRAIN_MESH_STEPS)
            one = (run["state"][0], run["grads"])
            out[(arch, "one")] = _tm_summary(run)
            del run
        out[(arch, TRAIN_TP_MESHES[0])] = _train_tp_run(fcfg, meshes[0],
                                                        device, one)
        del one
    return out


def phase_train_mesh() -> dict:
    """Phase 7f (module docstring).  Returns the kernels' launches over
    it, summed over the ranks (all 0)."""
    t_phase = time.perf_counter()
    zero_counts()
    with _work_dir() as d:
        ranks = spawn_world(_train_mesh_rank, 4, device="cuda",
                            timeout_s=TRAIN_MESH_TIMEOUT_S, args=(d,),
                            store_dir=ROOT / "build", threads=2)
    r0 = ranks[0]
    q, one = r0["qwen2"], r0["one"]
    ok = all(r["qwen2"]["losses"] == q["losses"] for r in ranks[:2])
    rel = _tm_rel(q["losses"][:TRAIN_MESH_STEPS], one["losses"])
    check(ok and rel <= 1e-5 and r0["grad_err"] <= 1e-5
          and r0["param_err"] <= 1e-4,
          f"7f qwen2-0.5b/{TRAIN_MESH_DEPTH} f32 (2, 1): both ranks' losses "
          f"equal ({ok}), within {rel:.2e} relative of the one-rank step's "
          f"(limit 1e-5); the first step's gathered gradients within "
          f"{r0['grad_err']:.2e} of the largest (limit 1e-5), the gathered "
          f"parameters after {TRAIN_MESH_STEPS} steps within "
          f"{r0['param_err']:.2e} (limit 1e-4)")
    share = q["weight_bytes"] / one["weight_bytes"]
    check(abs(q["collectives"] - q["reckoned"]) < 1e-9,
          f"7f qwen2 (2, 1): {q['collectives']:.1f} collectives a step "
          f"(reckoned from the layers: {q['reckoned']})")
    print(f"      7f qwen2-0.5b/{TRAIN_MESH_DEPTH} f32 (2, 1) [{CARD}]: "
          f"losses {' '.join(f'{x:.5f}' for x in q['losses'])} (one rank "
          f"{' '.join(f'{x:.5f}' for x in one['losses'])}); a rank holds "
          f"{q['weight_bytes'] / 2**20:.1f} MiB of weights and "
          f"{q['moment_bytes'] / 2**20:.1f} MiB of moments, one rank "
          f"{one['weight_bytes'] / 2**20:.1f} / "
          f"{one['moment_bytes'] / 2**20:.1f} MiB ({share:.4f}: the tied "
          f"embedding stays whole); {q['collectives']:.0f} collectives a "
          f"step ({q['reckoned']} reckoned), each staged through a host "
          f"copy; step wall median {statistics.median(q['walls']):.3f} s "
          f"(one rank {statistics.median(one['walls']):.3f} s)",
          flush=True)
    fams = ranks[2]["families"]
    for arch, got in fams.items():
        same = got["losses"] == ranks[3]["families"][arch]["losses"]
        rel = _tm_rel(got["losses"], got["one_losses"])
        check(same and rel <= 1e-5 and got["grad_err"] <= 1e-5
              and got["param_err"] <= 1e-4
              and got["collectives"] == got["reckoned"],
              f"7f {arch}-smoke f32 (2, 1): both ranks' losses equal "
              f"({same}), within {rel:.2e} relative of the one-rank step's, "
              f"gradients within {got['grad_err']:.2e} of the largest, "
              f"parameters after {TRAIN_MESH_STEPS} steps within "
              f"{got['param_err']:.2e}; {got['collectives']:.0f} "
              f"collectives a step ({got['reckoned']} reckoned)")
    want = q["losses"][TRAIN_MESH_STEPS:]
    for key, err in (("resumed4", r0["resumed4_err"]),
                     ("resumed1", r0["resumed1_err"])):
        rel = _tm_rel(r0[key]["losses"], want)
        same = all(r["resumed4"]["losses"] == r0["resumed4"]["losses"]
                   for r in ranks) if key == "resumed4" else True
        check(same and rel <= 1e-5 and err <= 1e-4,
              f"7f elastic restore of the (2, 1) checkpoint at step "
              f"{TRAIN_MESH_STEPS} onto {'(4, 1)' if key == 'resumed4' else 'one rank'}: "
              f"{TRAIN_MESH_MORE} more steps within {rel:.2e} relative "
              f"of the uninterrupted run's losses, parameters within "
              f"{err:.2e}")
    print(f"      7f elastic restore [{CARD}]: (4, 1) losses "
          f"{' '.join(f'{x:.5f}' for x in r0['resumed4']['losses'])}, one "
          f"rank {' '.join(f'{x:.5f}' for x in r0['resumed1']['losses'])}, "
          f"uninterrupted {' '.join(f'{x:.5f}' for x in want)}; a (4, 1) "
          f"rank holds {r0['weights4'] / 2**20:.1f} MiB of weights; "
          f"restore {max(r['restore_s'] for r in ranks):.1f} s",
          flush=True)
    _check_train_tp(ranks, one)
    launches = read_counts()
    for r in ranks:
        for name, n in r["launches"].items():
            launches[name] += n
    check(not any(launches.values()),
          f"7f: no kernel launched on any rank ({launches})")
    print(f"      7f: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def _check_train_tp(ranks: list, one: dict) -> None:
    """7f's tensor-split runs (module docstring) against the one-rank
    steps, `one` being qwen2's."""
    r0 = ranks[0]["tp"]
    for (arch, shape), got in r0.items():
        if shape == "one":
            continue
        want = one if arch == TRAIN_MESH_ARCH else r0[(arch, "one")]
        label = (f"{arch}/{TRAIN_MESH_DEPTH}" if arch == TRAIN_MESH_ARCH
                 else f"{arch}-smoke")
        same = all(r["tp"][(arch, shape)]["losses"] == got["losses"]
                   for r in ranks)
        counted = all(r["tp"][(arch, shape)]["collectives"] == got["reckoned"]
                      for r in ranks)
        rel = _tm_rel(got["losses"], want["losses"])
        check(same and counted and rel <= 1e-5 and got["grad_err"] <= 1e-5
              and got["param_err"] <= 1e-4,
              f"7f {label} f32 {shape}: every rank's losses equal ({same}), "
              f"within {rel:.2e} relative of the one-rank step's (limit "
              f"1e-5); the first step's gathered gradients within "
              f"{got['grad_err']:.2e} of the largest (limit 1e-5), the "
              f"gathered parameters after {TRAIN_MESH_STEPS} steps within "
              f"{got['param_err']:.2e} (limit 1e-4); {got['collectives']:.0f} "
              f"collectives a step on every rank ({counted}; "
              f"{got['reckoned']} reckoned)")
        print(f"      7f {label} f32 {shape} [{CARD}]: losses "
              f"{' '.join(f'{x:.5f}' for x in got['losses'])} (one rank "
              f"{' '.join(f'{x:.5f}' for x in want['losses'])}); a rank "
              f"holds {got['weight_bytes'] / 2**20:.1f} MiB of weights and "
              f"{got['moment_bytes'] / 2**20:.1f} MiB of moments, one rank "
              f"{want['weight_bytes'] / 2**20:.1f} / "
              f"{want['moment_bytes'] / 2**20:.1f} MiB "
              f"({got['weight_bytes'] / want['weight_bytes']:.4f}); "
              f"{got['collectives']:.0f} collectives a step "
              f"({got['reckoned']} reckoned), each staged through a host "
              f"copy; step wall median {statistics.median(got['walls']):.3f}"
              f" s (one rank {statistics.median(want['walls']):.3f} s)",
              flush=True)


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# Phase 6i: mesh serving on the tensor axis (--mesh 1,2), both ranks on
# this card over gloo: every collective is staged through a host copy
MESH_TP = 2
MESH_PROMPTS = [24, 150, 40, 70, 12, 33]     # 150 and 70 chunk (window 64)
MESH_ENGINE = dict(max_slots=8, cache_capacity=512, prefill_len=64, alpha=4)
MESH_CASES = {"dense": {}, "attn_pim": dict(attn_pim=True, sanitize=True),
              "paged": dict(kv_layout="paged", page_size=16, attn_pim=True),
              "spec": dict(attn_pim=True, spec_len=4)}
MESH_GRANITE_DEPTH = 8
# qwen2-0.5b's depth in 6i and 6j (8 of 24 layers: the script's limit)
MESH_QWEN_DEPTH = 8
MESH_ATTN = {"qwen2-0.5b": (2, 7, 64), "granite-8b": (8, 4, 128)}
MESH_TIMEOUT_S = 600


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _state_bytes(cache: dict) -> int:
    """Bytes of a cache's KV and SSM state (the slab or the pools)."""
    return sum(t.numel() * t.element_size() for key, val in cache.items()
               if key in ("k", "v", "ssm")
               for t in (val if key == "ssm" else (val,)))


def _mesh_run(cfg, params, case: str, mesh=None,
              engine: dict = MESH_ENGINE) -> dict:
    """One engine run of phase 6i's requests (one rank of the mesh, or the
    one-rank engine), the launch counts set to 0 just before `run()`."""
    kw = dict(MESH_CASES[case])
    if kw.get("spec_len"):
        kw["draft"] = (cfg, params)          # the perfect draft
    eng = PapiEngine(cfg, params, mesh=mesh, device=DEV, **engine, **kw)
    rng = np.random.default_rng(0)
    for i, n in enumerate(MESH_PROMPTS):
        eng.submit(ServeRequest(i, rng.integers(3, cfg.vocab_size,
                                                size=n).tolist(),
                                max_new_tokens=8 + 4 * i))
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(max_iterations=500)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steady = [s.transfers for s in eng.stats if s.admitted == 0
              and s.decode_slots and not s.prefill_slots and not s.degraded]
    rep = eng.sanitize_report()
    return dict(
        streams={r.req_id: list(r.tokens) for r in results},
        reasons=sorted(r.finished_reason for r in results),
        fc=sorted({s.fc_variant for s in eng.stats}), wall=wall,
        tokens=sum(len(r.tokens) for r in results),
        launches=read_counts(), steady=sorted(set(steady)),
        budget=eng.transfer_budget, degraded=eng.degraded_steps,
        sanitized=None if rep is None else rep.steady_iterations,
        weight_bytes=_tree_bytes(eng.params),
        kv_bytes=_state_bytes(eng.cache),
        kv_shape=tuple(eng.cache["k"].shape) if "k" in eng.cache else None,
        ssm_shape=(tuple(eng.cache["ssm"].ssm.shape) if "ssm" in eng.cache
                   else None),
        staged=0 if mesh is None else mesh.staged_copies)


def _mesh_first_logits(cfg, params, mesh=None, rules=None) -> torch.Tensor:
    """The prefill logits of phase 6i's first 4 prompts cut to 12 tokens
    (on the mesh: the gathered vocabulary, the same on every rank)."""
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(np.stack([
        rng.integers(3, cfg.vocab_size, size=n)[:12]
        for n in MESH_PROMPTS[:4]])).to(DEV)
    scope = (axis_rules(rules, mesh) if mesh is not None
             else contextlib.nullcontext())
    with scope, torch.no_grad():
        if mesh is not None:
            params = shard_params(cfg, params, rules, mesh)
        cache = init_cache(cfg, 4, 64, DEV)
        logits, _ = prefill(cfg, params, {"tokens": toks}, cache)
    return logits.float().cpu()


def _mesh_banks(mesh) -> dict:
    """Each rank's FC banks at qwen2-0.5b's and granite-8b's widths (bf16,
    m = 8, under serve_rules(attn_pim=True)): the column groups (q/k/v,
    gate/up) against the columns of the plain unsharded product, the row
    banks (o, down) reduced over the ranks against the whole product."""
    out = {}
    rules = serve_rules(attn_pim=True)
    for arch in ("qwen2-0.5b", "granite-8b"):
        cfg = get_config(arch)
        d, hd = cfg.d_model, cfg.resolved_head_dim
        q, kv, f = cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.d_ff
        gen = torch.Generator(device=DEV).manual_seed(5)
        banks = [("qkv", "col", d, [q, kv, kv], "heads", cfg.num_heads),
                 ("o", "row", q, [d], "heads", cfg.num_heads),
                 ("gate_up", "col", d, [f, f], "ffn", f),
                 ("down", "row", f, [d], "ffn", f)]
        for name, tp, K, ns, bank, units in banks:
            x = torch.randn(8, K, generator=gen, device=DEV).bfloat16()
            ws = [(torch.randn(K, n, generator=gen, device=DEV)
                   / K ** 0.5).bfloat16() for n in ns]
            want = [fc_mod.fc_gemv_ref(x, w) for w in ws]
            if tp == "col":
                xs = x
                wl = [local_block(w, (None, "model"), mesh) for w in ws]
            else:
                xs = local_block(x, (None, "model"), mesh)
                wl = [local_block(w, ("model", None), mesh) for w in ws]
            n0 = fc_mod.LAUNCHES
            with axis_rules(rules, mesh), fc_variant("pim"):
                got = papi_linear_group(xs, wl, tp=tp, bank=bank,
                                        units=units)
            torch.cuda.synchronize()
            errs, ok = [], True
            for g, w_, full in zip(got, wl, want):
                if tp == "col":
                    r = mesh.coords["model"]
                    full = full[:, r * w_.shape[1]:(r + 1) * w_.shape[1]]
                e, good, _ = max_err(g, full)
                errs.append(e)
                ok = ok and good
            out[f"{arch} {name}"] = dict(
                err=max(errs), ok=ok, launches=fc_mod.LAUNCHES - n0,
                shapes=[tuple(w.shape) for w in wl])
    return out


def _mesh_attention(mesh) -> dict:
    """Both sharded Attn-PIM wrappers at qwen2's and granite's geometry,
    t = 1, 4 and 64, bf16: bit-equal to the unsharded kernel's rows for
    the rank's KV heads, within tolerance of the plain version."""
    from repro_torch.kernels.decode_attention import decode_attention_sharded
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention_sharded
    out = {}
    r = mesh.coords["model"]
    for arch, (nkv, g, hd) in MESH_ATTN.items():
        n = nkv // MESH_TP
        for t in (1, 4, 64):
            gen = torch.Generator(device=DEV).manual_seed(t)
            b, S, page = 8, 2048, 16
            q = torch.randn(b, nkv, t * g, hd, generator=gen,
                            device=DEV).bfloat16()
            k = torch.randn(b, S, nkv, hd, generator=gen,
                            device=DEV).bfloat16()
            v = torch.randn(b, S, nkv, hd, generator=gen,
                            device=DEV).bfloat16()
            lens = torch.tensor([2048, 1, 700, 1500, 64, 513, 2000, 77],
                                dtype=torch.int32, device=DEV)
            lens = torch.clamp(lens, min=t)
            ql = local_block(q, (None, "model"), mesh)
            kl = local_block(k, (None, None, "model"), mesh)
            vl = local_block(v, (None, None, "model"), mesh)
            n0 = attn_mod.LAUNCHES
            got = decode_attention_sharded(ql, kl, vl, lens, mesh=mesh,
                                           heads=nkv, q_rows=t)
            full = attn_mod.decode_attention(q, k, v, lens, q_rows=t)
            ref = attn_mod.decode_attention_ref(q, k, v, lens, t)
            mine = slice(r * n, (r + 1) * n)
            e, ok, _ = max_err(got, ref[:, mine])
            out[f"{arch} dense t={t}"] = dict(
                bitwise=bool(torch.equal(got, full[:, mine])), err=e, ok=ok,
                launches=attn_mod.LAUNCHES - n0 - 1,
                shape=tuple(kl.shape))
            pages = b * S // page
            perm = torch.randperm(pages, generator=gen, device=DEV)
            tables = perm.reshape(b, S // page).to(torch.int32).contiguous()
            kp = torch.empty(pages, page, nkv, hd, dtype=k.dtype, device=DEV)
            vp = torch.empty_like(kp)
            kp[perm] = k.reshape(pages, page, nkv, hd)
            vp[perm] = v.reshape(pages, page, nkv, hd)
            kpl = local_block(kp, (None, None, "model"), mesh)
            vpl = local_block(vp, (None, None, "model"), mesh)
            n0 = paged_mod.LAUNCHES
            got = paged_decode_attention_sharded(ql, kpl, vpl, lens, tables,
                                                 mesh=mesh, heads=nkv,
                                                 q_rows=t)
            fullp = paged_mod.paged_decode_attention(q, kp, vp, lens, tables,
                                                     q_rows=t)
            e, ok, _ = max_err(got, ref[:, mine])
            out[f"{arch} paged t={t}"] = dict(
                bitwise=bool(torch.equal(got, fullp[:, mine])), err=e,
                ok=ok, launches=paged_mod.LAUNCHES - n0 - 1,
                shape=tuple(kpl.shape))
    return out


def _mesh_rank(rank: int, device, granite_depth: int) -> dict:
    """One rank of phase 6i's world: the banks, the sharded attention, the
    engine runs, the first-step logits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_serving_mesh(1, MESH_TP, device=device)
    out = {"banks": _mesh_banks(mesh), "attention": _mesh_attention(mesh)}
    cfg32 = family_cfg("qwen2-0.5b", MESH_QWEN_DEPTH, "float32")
    params = init_params(cfg32, torch.Generator(device=DEV).manual_seed(0))
    out["f32"] = {c: _mesh_run(cfg32, params, c, mesh) for c in MESH_CASES}
    out["f32_logits"] = _mesh_first_logits(cfg32, params, mesh,
                                           serve_rules())
    del params
    cfg16 = family_cfg("qwen2-0.5b", MESH_QWEN_DEPTH)
    params = init_params(cfg16, torch.Generator(device=DEV).manual_seed(0))
    out["bf16"] = _mesh_run(cfg16, params, "attn_pim", mesh)
    out["bf16_logits"] = _mesh_first_logits(cfg16, params, mesh,
                                            serve_rules())
    del params
    gcfg = family_cfg("granite-8b", depth=granite_depth)
    params = init_params(gcfg, torch.Generator(device=DEV).manual_seed(0))
    out["granite"] = _mesh_run(gcfg, params, "attn_pim", mesh)
    out["collectives"] = mesh.collectives
    return out


def _nccl_world_of_one() -> str:
    """A one-rank NCCL world on the card: make_serving_mesh and an
    all_reduce and an all_gather on CUDA tensors."""
    import torch.distributed as dist
    work = _work_dir()
    dist.init_process_group("nccl", init_method=f"file://{work.name}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_serving_mesh(1, 1, device=DEV)
        x = torch.arange(6, dtype=torch.float32, device=DEV)
        dist.all_reduce(x)
        parts = [torch.empty_like(x)]
        dist.all_gather(parts, x)
        torch.cuda.synchronize()
        ok = torch.equal(parts[0], torch.arange(6, device=DEV).float())
        check(ok and mesh.backend == "nccl" and not mesh.staged,
              f"NCCL world of one: backend {mesh.backend}, collectives ok "
              f"{ok}")
        return mesh.backend
    finally:
        dist.destroy_process_group()
        work.cleanup()


def _shard_times() -> None:
    """The shard shapes' kernel times, this process alone on the card: one
    qwen2 / granite layer's FC-PIM groups whole and at the rank's shard
    (bf16, m = 8), and Attn-PIM at t = 1 over all KV heads and a rank's."""
    for arch in ("qwen2-0.5b", "granite-8b"):
        cfg = get_config(arch)
        whole = fc_groups(cfg)
        d, hd = cfg.d_model, cfg.resolved_head_dim
        q, kv, f = cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.d_ff
        shard = [(d, [q // 2, kv // 2, kv // 2]), (q // 2, [d]),
                 (d, [f // 2, f // 2]), (f // 2, [d])]
        gen = torch.Generator(device=DEV).manual_seed(3)
        times = {}
        for label, groups in (("whole", whole), ("shard", shard)):
            nbytes = sum(K * n * 2 for K, ns in groups for n in ns)
            copies = max(1, -(-2 * L2_BYTES // nbytes))
            sets = [[(torch.randn(8, K, generator=gen,
                                  device=DEV).bfloat16(),
                      [(torch.randn(K, n, generator=gen, device=DEV)
                        / K ** 0.5).bfloat16() for n in ns])
                     for K, ns in groups] for _ in range(copies)]

            def layer(gs):
                for x, ws in gs:
                    fc_mod.fc_gemv_group(x, ws)

            def plain(gs):
                for x, ws in gs:
                    for w in ws:
                        torch.matmul(x, w)
            times[label] = (time_ms(layer, [(g,) for g in sets]),
                            time_ms(plain, [(g,) for g in sets]),
                            bound(nbytes, sum(2 * 8 * K * n for K, ns
                                              in groups for n in ns),
                                  torch.bfloat16)[0])
        nkv, g, hd = MESH_ATTN[arch]
        at = {}
        for label, n in (("whole", nkv), ("shard", nkv // 2)):
            q_, k_, v_, lens = _attn_inputs(gen, torch.bfloat16, 1,
                                            [2048] * 8, nkv=n, g=g, hd=hd)
            at[label] = time_ms(
                lambda a, b_, c, l_: attn_mod.decode_attention(
                    a, b_, c, l_, splits=attn_mod.num_splits(
                        8, nkv, g, attn_mod.sm_count(DEV))),
                [(q_, k_, v_, lens)])
        print(f"      {arch} shard times ({CARD}), bf16, m = 8: one layer's "
              f"FC-PIM {times['whole'][0]:.4f} ms whole / "
              f"{times['shard'][0]:.4f} ms a rank's shard (torch.matmul "
              f"{times['whole'][1]:.4f} / {times['shard'][1]:.4f}, bound "
              f"{times['whole'][2]:.4f} / {times['shard'][2]:.4f}); "
              f"Attn-PIM t=1, b 8, lens 2048: {at['whole']:.4f} ms over "
              f"{nkv} KV heads / {at['shard']:.4f} ms over a rank's "
              f"{nkv // 2} (the unsharded split count)", flush=True)


def phase_mesh() -> tuple[dict, dict]:
    """Phase 6i (module docstring): the one-rank NCCL world, the one-rank
    engine's runs here, the tp = 2 world, and the checks between them.
    Returns the mesh path's launches, summed over the ranks' engine runs,
    and the one-rank f32 qwen2 runs (phase 6j's baseline)."""
    print(f"      NCCL world of one: {_nccl_world_of_one()}", flush=True)
    _shard_times()
    cfg32 = family_cfg("qwen2-0.5b", MESH_QWEN_DEPTH, "float32")
    params = init_params(cfg32, torch.Generator(device=DEV).manual_seed(0))
    one = {c: _mesh_run(cfg32, params, c) for c in MESH_CASES}
    one_logits32 = _mesh_first_logits(cfg32, params)
    del params
    cfg16 = family_cfg("qwen2-0.5b", MESH_QWEN_DEPTH)
    params = init_params(cfg16, torch.Generator(device=DEV).manual_seed(0))
    one16 = _mesh_run(cfg16, params, "attn_pim")
    one_logits16 = _mesh_first_logits(cfg16, params)
    del params
    gcfg = family_cfg("granite-8b", depth=MESH_GRANITE_DEPTH)
    params = init_params(gcfg, torch.Generator(device=DEV).manual_seed(0))
    one_granite = _mesh_run(gcfg, params, "attn_pim")
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = spawn_world(_mesh_rank, MESH_TP, device="cuda",
                        timeout_s=MESH_TIMEOUT_S,
                        args=(MESH_GRANITE_DEPTH,),
                        store_dir=ROOT / "build", threads=2)
    print(f"      mesh (1, {MESH_TP}) world: {MESH_TP} ranks on one "
          f"{torch.cuda.get_device_name(0)} over gloo, collectives staged "
          f"through host copies; {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches = {name: 0 for name in MODS}
    for r, res in enumerate(ranks):
        for key, b in res["banks"].items():
            check(b["ok"] and b["launches"] == 1,
                  f"rank {r} FC bank {key}: max err {b['err']:.3g}, "
                  f"{b['launches']} fc_gemv launch at {b['shapes']}")
        for key, a in res["attention"].items():
            check(a["bitwise"] and a["ok"] and a["launches"] == 1,
                  f"rank {r} {key}: bit-equal to the unsharded kernel "
                  f"{a['bitwise']}, max err {a['err']:.3g} at {a['shape']}")
        for case, got in res["f32"].items():
            want = one[case]
            label = f"rank {r} f32 {case}"
            check(got["streams"] == want["streams"],
                  f"{label}: streams equal the one-rank engine's "
                  f"({_first_divergence(got['streams'], want['streams'])})")
            check(got["fc"] == ["pim", "pu"], f"{label}: FC variants "
                  f"{got['fc']}")
            check(got["steady"] == [got["budget"]] and got["degraded"] == 0,
                  f"{label}: steady transfers {got['steady']}, budget "
                  f"{got['budget']}")
            attn = ("paged_decode_attention" if case == "paged"
                    else "decode_attention")
            ln = got["launches"]
            check(ln["fc_gemv"] > 0 and (ln[attn] > 0 or case == "dense"),
                  f"{label}: launches {ln}")
            for name, n in ln.items():
                launches[name] += n
        check(res["f32"]["attn_pim"]["sanitized"],
              f"rank {r}: sanitized attn_pim run, "
              f"{res['f32']['attn_pim']['sanitized']} steady iterations")
        check(res["granite"]["kv_shape"][3] == 4,
              f"rank {r} granite: {res['granite']['kv_shape'][3]} KV heads "
              "a rank")
        for key in ("bf16", "granite"):
            for name, n in res[key]["launches"].items():
                launches[name] += n
        check(torch.equal(res["f32_logits"], ranks[0]["f32_logits"])
              and torch.equal(res["bf16_logits"], ranks[0]["bf16_logits"]),
              f"rank {r}: the same gathered logits as rank 0")
    r0 = ranks[0]
    d32 = (r0["f32_logits"] - one_logits32).abs().max().item()
    d16 = (r0["bf16_logits"] - one_logits16).abs().max().item()
    same16 = _same_tokens(r0["bf16"]["streams"], one16["streams"])
    sameg = _same_tokens(r0["granite"]["streams"], one_granite["streams"])
    print(f"      first-step logits, mesh vs one rank: f32 max |diff| "
          f"{d32:.3g}, bf16 {d16:.3g} (bf16 row-bank partials rounded "
          f"to bf16 by fc_gemv / matmul, summed in f32, rounded once); "
          f"bf16 attn_pim tokens equal {same16[0]}/{same16[1]}; granite-8b "
          f"(depth {MESH_GRANITE_DEPTH}) bf16 attn_pim tokens equal "
          f"{sameg[0]}/{sameg[1]}", flush=True)
    for label, got, want in (
            [(f"qwen2 f32 {c}", r0["f32"][c], one[c]) for c in MESH_CASES]
            + [("qwen2 bf16 attn_pim", r0["bf16"], one16),
               (f"granite-8b/{MESH_GRANITE_DEPTH} bf16 attn_pim",
                r0["granite"], one_granite)]):
        print(f"      {label}: tp=2 {got['tokens'] / got['wall']:.1f} tok/s "
              f"({got['wall']:.2f} s) vs tp=1 "
              f"{want['tokens'] / want['wall']:.1f} tok/s; a rank holds "
              f"{got['weight_bytes'] / 2**20:.1f} MiB of weights and "
              f"{got['kv_bytes'] / 2**20:.1f} MiB of KV (one rank alone: "
              f"{want['weight_bytes'] / 2**20:.1f} / "
              f"{want['kv_bytes'] / 2**20:.1f} MiB); transfers per steady "
              f"iteration {got['steady']} (one rank {want['steady']}); "
              f"launches per rank {got['launches']}", flush=True)
    print(f"      mesh launches (both ranks, engine runs): "
          f"{json.dumps(launches)}; collectives on rank 0: "
          f"{r0['collectives']}", flush=True)
    return launches, one


# ---------------------------------------------------------------------------
# Phase 6j: mesh serving on the data axis (--mesh dp,tp): the slot batch
# split over the data groups, every rank on this card over gloo
DATA_MESHES = ((2, 2), (2, 1))
# (label, arch, depth, phase 6i case, engine): the families the data axis
# serves at tp = 1, f32, depth cut; mamba2's window takes phase 6i's
# longest prompt (the SSM families take no chunk waves)
DATA_FAMILY_RUNS = (
    ("mamba2-1.3b", 8, "dense", dict(MESH_ENGINE, prefill_len=256)),
    ("olmoe-1b-7b", 4, "attn_pim", MESH_ENGINE),
    ("olmoe-1b-7b", 4, "paged", MESH_ENGINE),
)
# the kernels each run must launch on every rank
DATA_KERNELS = {"dense": ("fc_gemv",), "attn_pim": ("fc_gemv",
                                                    "decode_attention"),
                "paged": ("fc_gemv", "paged_decode_attention"),
                "spec": ("fc_gemv", "decode_attention")}


def _family_mesh_runs(runs, mesh=None) -> dict:
    """`runs`' engine runs (one rank's, or the one-rank engine's): each
    family model from seed 0 in f32, one at a time on the card (its weights
    made once for its consecutive runs)."""
    out, params, made = {}, None, None
    for arch, depth, case, engine in runs:
        cfg = family_cfg(arch, depth=depth, dtype="float32")
        if made != (arch, depth):
            del params
            torch.cuda.empty_cache()
            params = init_params(cfg,
                                 torch.Generator(device=DEV).manual_seed(0))
            made = (arch, depth)
        out[f"{arch}/{depth} f32 {case}"] = _mesh_run(cfg, params, case,
                                                      mesh, engine)
    del params
    torch.cuda.empty_cache()
    return out


def _data_mesh_rank(rank: int, device, dp: int, tp: int) -> dict:
    """One rank of a phase 6j world: at (2, 2) phase 6i's f32 qwen2 cases
    (8 layers), at (2, 1) the family runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_serving_mesh(dp, tp, device=device)
    if tp > 1:
        cfg = family_cfg("qwen2-0.5b", MESH_QWEN_DEPTH, "float32")
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0))
        runs = {f"qwen2 f32 {c}": _mesh_run(cfg, params, c, mesh)
                for c in MESH_CASES}
    else:
        runs = _family_mesh_runs(DATA_FAMILY_RUNS, mesh)
    return {"coords": dict(mesh.coords), "runs": runs,
            "collectives": mesh.collectives}


def _data_kernels(label: str) -> tuple:
    return ("ssd_scan",) if label.startswith("mamba2") else \
        DATA_KERNELS[label.rsplit(" ", 1)[1]]


def phase_data_mesh(one: dict) -> dict:
    """Phase 6j (module docstring): the (2, 2) and (2, 1) worlds against
    the one-rank engine (phase 6i's f32 qwen2 runs, the family runs here).
    Returns the launches summed over every rank's engine runs."""
    want = {f"qwen2 f32 {c}": r for c, r in one.items()}
    want.update(_family_mesh_runs(DATA_FAMILY_RUNS))
    launches = {name: 0 for name in MODS}
    for dp, tp in DATA_MESHES:
        t0 = time.perf_counter()
        ranks = spawn_world(_data_mesh_rank, dp * tp, device="cuda",
                            timeout_s=MESH_TIMEOUT_S, args=(dp, tp),
                            store_dir=ROOT / "build", threads=2)
        print(f"      mesh ({dp}, {tp}) world: {dp * tp} ranks on one "
              f"{torch.cuda.get_device_name(0)} over gloo, collectives "
              f"staged through host copies; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        slots = MESH_ENGINE["max_slots"]
        for r, res in enumerate(ranks):
            check(res["coords"] == {"data": r // tp, "model": r % tp},
                  f"({dp}, {tp}) rank {r} at {res['coords']}")
            for label, got in res["runs"].items():
                w = want[label]
                tag = f"({dp}, {tp}) rank {r} {label}"
                check(got["streams"] == w["streams"]
                      and got["reasons"] == w["reasons"],
                      f"{tag}: streams equal the one-rank engine's "
                      f"({_first_divergence(got['streams'], w['streams'])})")
                check(got["fc"] == w["fc"], f"{tag}: FC variants "
                      f"{got['fc']} (one rank {w['fc']})")
                check(got["steady"] == [got["budget"]]
                      and got["degraded"] == 0,
                      f"{tag}: steady transfers {got['steady']}, budget "
                      f"{got['budget']} (one rank {w['steady']})")
                paged = label.endswith("paged")
                shape = got["ssm_shape"] or got["kv_shape"]
                whole = w["ssm_shape"] or w["kv_shape"]
                if paged:
                    held = "pools whole over the pages"
                    batch_ok = shape[1] == whole[1]
                else:
                    held = f"{slots // dp} of {slots} slots a rank"
                    batch_ok = shape[1] == slots // dp == whole[1] // dp
                check(batch_ok, f"{tag}: {held}, state {shape} (one rank "
                      f"{whole})")
                ln = got["launches"]
                check(all(ln[k] > 0 for k in _data_kernels(label)),
                      f"{tag}: launches {ln}")
                for name, n in ln.items():
                    launches[name] += n
                if got["sanitized"] is not None:
                    check(got["sanitized"] > 0, f"{tag}: sanitized, "
                          f"{got['sanitized']} steady iterations")
        for label, got in ranks[0]["runs"].items():
            w = want[label]
            print(f"      ({dp}, {tp}) {label}: "
                  f"{got['tokens'] / got['wall']:.1f} tok/s "
                  f"({got['wall']:.2f} s) vs one rank "
                  f"{w['tokens'] / w['wall']:.1f} tok/s [{CARD}]; a rank "
                  f"holds {got['weight_bytes'] / 2**20:.1f} MiB of weights "
                  f"and {got['kv_bytes'] / 2**20:.1f} MiB of KV / SSM state "
                  f"(one rank {w['weight_bytes'] / 2**20:.1f} / "
                  f"{w['kv_bytes'] / 2**20:.1f} MiB); transfers per steady "
                  f"iteration {got['steady']} (one rank {w['steady']}); "
                  f"launches per rank {got['launches']}", flush=True)
    print(f"      data-mesh launches (every rank, engine runs): "
          f"{json.dumps(launches)}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 6k: the MoE, SSM and hybrid families under a tensor split (--mesh
# 1,2, and mamba2 at --mesh 2,2), every rank on this card over gloo
SSM_MESH_ENGINE = dict(MESH_ENGINE, prefill_len=256)
# (arch, depth, phase 6i case, engine), f32, depth cut to keep the phase
# near 90 s with 7f beside it: olmoe 4 of 16 layers, mamba2 8 of 48,
# zamba2 12 of 38 (two shared-block applications)
FAMILY_MESH_RUNS = (
    ("olmoe-1b-7b", 4, "dense", MESH_ENGINE),
    ("olmoe-1b-7b", 4, "attn_pim", MESH_ENGINE),
    ("olmoe-1b-7b", 4, "paged", MESH_ENGINE),
    ("mamba2-1.3b", 8, "dense", SSM_MESH_ENGINE),
    ("mamba2-1.3b", 8, "spec", SSM_MESH_ENGINE),
    ("zamba2-1.2b", 12, "attn_pim", SSM_MESH_ENGINE),
)
FAMILY_MESHES = {(1, 2): FAMILY_MESH_RUNS,
                 (2, 2): (("mamba2-1.3b", 8, "dense", SSM_MESH_ENGINE),)}
# the shard shapes at tp 2 (and mamba2's scan at tp 4): (K, [N]) of one
# layer's FC-PIM groups, the scan's (b, nh, l, hp, n, cs), the Attn-PIM
# geometry (nkv, g, hd) of a rank's KV heads
FAMILY_SHARD_FC = {
    "olmoe-1b-7b": [(2048, [1024, 1024, 1024]), (1024, [2048])],
    "granite-moe-1b-a400m": [(1024, [512, 256, 256]), (512, [1024])],
    "zamba2-1.2b": [(2048, [1024, 1024, 1024]), (1024, [2048]),
                    (2048, [4096, 4096]), (4096, [2048])],
}
FAMILY_SHARD_SSD = {"mamba2-1.3b tp 2": (8, 32, 512, 64, 128, 256),
                    "mamba2-1.3b tp 4": (8, 16, 512, 64, 128, 256),
                    "zamba2-1.2b tp 2": (8, 32, 512, 64, 64, 256)}
FAMILY_SHARD_ATTN = {"olmoe-1b-7b": (8, 1, 128), "zamba2-1.2b": (16, 1, 64)}


def _family_shard_kernels() -> None:
    """The kernels at a rank's shard shapes, this process alone on the
    card: fc_gemv (f32 and bf16, m = 8) and decode_attention (bf16, t = 1)
    against their plain versions, fc_gemv timed beside torch.matmul;
    ssd_scan (dtx f32, B/C/y bf16) against `ssd_scan_ref` and timed."""
    gen = torch.Generator(device=DEV).manual_seed(28)
    for arch, groups in FAMILY_SHARD_FC.items():
        for dtype in (torch.float32, torch.bfloat16):
            for K, ns in groups:
                ws = [(torch.randn(K, n, generator=gen, device=DEV)
                       / math.sqrt(K)).to(dtype) for n in ns]
                x = torch.randn(8, K, generator=gen, device=DEV).to(dtype)
                ys = fc_mod.fc_gemv_group(x, ws)
                torch.cuda.synchronize()
                errs = [max_err(y, fc_mod.fc_gemv_ref(x, w))
                        for y, w in zip(ys, ws)]
                check(all(ok for _, ok, _ in errs),
                      f"6k fc_gemv_group {str(dtype)[6:]} {arch} shard m=8 "
                      f"K={K} N={ns}: max_abs_err "
                      f"{max(e for e, _, _ in errs):.3e} (tol {errs[0][2]})")
        _fc_group_times(gen, groups, f"a tp = 2 rank's {arch} layer", reps=3)
    for arch, (nkv, g, hd) in FAMILY_SHARD_ATTN.items():
        lens = FAMILY_LENS[1]
        q, k, v, ln = _attn_inputs(gen, torch.bfloat16, 1, lens, nkv=nkv,
                                   g=g, hd=hd)
        got = attn_mod.decode_attention(q, k, v, ln, q_rows=1)
        torch.cuda.synchronize()
        err, ok, tol = max_err(got, attn_mod.decode_attention_ref(q, k, v,
                                                                  ln, 1))
        k_ms = time_ms(lambda q, k, v, ln: attn_mod.decode_attention(
            q, k, v, ln, q_rows=1), [(q, k, v, ln)], reps=3)
        check(ok, f"6k decode_attention bf16 {arch} a rank's {nkv} KV heads "
              f"(g {g}, hd {hd}, t 1): max_abs_err {err:.3e} (tol {tol}); "
              f"{k_ms:.4f} ms")
    f32, bf16 = torch.float32, torch.bfloat16
    for label, (b, nh, l, hp, n, ch) in FAMILY_SHARD_SSD.items():
        sets = [_ssd_inputs(gen, b, nh, l, hp, n, f32, bf16)[:4]
                + (torch.zeros(b, nh, hp, n, device=DEV),) for _ in range(3)]

        def kern(dtx, lt, B, C, s0):
            return ssd_mod.ssd_scan(dtx, lt, B, C, chunk=ch, init_state=s0,
                                    out_dtype=bf16)

        def plain(dtx, lt, B, C, s0):
            return ssd_mod.ssd_scan_ref(dtx, lt, B, C, chunk=ch,
                                        init_state=s0, out_dtype=bf16)

        y, st = kern(*sets[0])
        torch.cuda.synchronize()
        want_y, want_st = plain(*sets[0])
        ey, oky, tol = max_err(y, want_y, SSD_TOL[bf16])
        es, oks, _ = max_err(st, want_st, SSD_TOL[f32])
        k_ms, p_ms = time_ms(kern, sets, reps=3), time_ms(plain, sets, reps=3)
        b_ms, b_by = ssd_tc_bound(b, nh, l, hp, n, ch)
        check(oky and oks, f"6k ssd_scan {label} b={b} nh={nh} l={l} "
              f"hp={hp} n={n} cs={ch}: max_abs_err y {ey:.3e} (tol {tol}), "
              f"state {es:.3e}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}) [{CARD}]")
        del sets, y, st, want_y, want_st


def _block_bytes(cfg, rules, shape: dict, coords: dict) -> int:
    """Bytes of one rank's block of every weight of an f32 `cfg` under
    `rules` (`param_shardings` on a shape-only mesh at `coords`)."""
    mesh = types.SimpleNamespace(shape=shape, coords=coords)

    def walk(specs, shapes):
        if isinstance(specs, dict):
            return sum(walk(specs[k], shapes[k]) for k in specs)
        return 4 * math.prod(hi - lo for lo, hi in (
            block_range(n, e, mesh) for n, e in zip(shapes, specs)))
    return walk(param_shardings(cfg, rules, mesh), param_shapes(cfg))


def _family_mesh_rank(rank: int, device, dp: int, tp: int) -> dict:
    """One rank of a phase 6k world: its runs of `FAMILY_MESHES`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_serving_mesh(dp, tp, device=device)
    runs = _family_mesh_runs(FAMILY_MESHES[dp, tp], mesh)
    return {"coords": dict(mesh.coords), "runs": runs,
            "collectives": mesh.collectives}


def phase_family_mesh() -> dict:
    """Phase 6k (module docstring): the shard kernels, the one-rank
    engine's runs, then the (1, 2) and (2, 2) worlds against them.
    Returns the launches summed over every rank's engine runs, and the
    one-rank runs (phase 6l holds its long-context runs to them)."""
    _family_shard_kernels()
    want = _family_mesh_runs(FAMILY_MESH_RUNS)
    launches = {name: 0 for name in MODS}
    for (dp, tp), runs in FAMILY_MESHES.items():
        t0 = time.perf_counter()
        ranks = spawn_world(_family_mesh_rank, dp * tp, device="cuda",
                            timeout_s=MESH_TIMEOUT_S, args=(dp, tp),
                            store_dir=ROOT / "build", threads=2)
        print(f"      6k mesh ({dp}, {tp}) world: {dp * tp} ranks on one "
              f"{torch.cuda.get_device_name(0)} over gloo, collectives "
              f"staged through host copies; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        share = dp * tp if dp > 1 else tp        # of the one-rank state
        for r, res in enumerate(ranks):
            check(res["coords"] == {"data": r // tp, "model": r % tp},
                  f"6k ({dp}, {tp}) rank {r} at {res['coords']}")
            for label, got in res["runs"].items():
                w = want[label]
                tag = f"6k ({dp}, {tp}) rank {r} {label}"
                check(got["streams"] == w["streams"]
                      and got["reasons"] == w["reasons"],
                      f"{tag}: streams equal the one-rank engine's "
                      f"({_first_divergence(got['streams'], w['streams'])})")
                check(got["fc"] == w["fc"], f"{tag}: FC variants "
                      f"{got['fc']} (one rank {w['fc']})")
                check(got["steady"] == [got["budget"]]
                      and got["degraded"] == 0,
                      f"{tag}: steady transfers {got['steady']}, budget "
                      f"{got['budget']} (one rank {w['steady']})")
                # the weights: the rules' block of every leaf (the router,
                # norms, B and C whole: a little over half); the SSM state
                # keeps conv_B / conv_C whole
                arch, depth = label.split(" ")[0].split("/")
                kw = MESH_CASES[label.rsplit(" ", 1)[1]]
                rules = serve_rules(attn_pim=bool(kw.get("attn_pim")
                                                  or kw.get("kv_layout")))
                blk = _block_bytes(family_cfg(arch, int(depth), "float32"),
                                   rules, {"data": dp, "model": tp},
                                   res["coords"])
                wt = got["weight_bytes"] / w["weight_bytes"]
                st = got["kv_bytes"] / w["kv_bytes"]
                check(got["weight_bytes"] == blk and wt >= 1 / tp
                      and 1 / share <= st <= 1.1 / share,
                      f"{tag}: a rank holds {wt:.4f} of the one-rank "
                      f"weights (the rules' blocks: {blk} bytes) and "
                      f"{st:.4f} of its KV / SSM state (1/{tp} and "
                      f"1/{share} with what stays whole)")
                ln = got["launches"]
                need = _data_kernels(label) + (
                    ("ssd_scan",) if label.startswith("zamba2") else ())
                check(all(ln[k] > 0 for k in need), f"{tag}: launches {ln}")
                for name, n in ln.items():
                    launches[name] += n
                if got["sanitized"] is not None:
                    check(got["sanitized"] > 0, f"{tag}: sanitized, "
                          f"{got['sanitized']} steady iterations")
        for label, got in ranks[0]["runs"].items():
            w = want[label]
            print(f"      6k ({dp}, {tp}) {label}: "
                  f"{got['tokens'] / got['wall']:.1f} tok/s "
                  f"({got['wall']:.2f} s) vs one rank "
                  f"{w['tokens'] / w['wall']:.1f} tok/s [{CARD}]; a rank "
                  f"holds {got['weight_bytes'] / 2**20:.1f} MiB of weights "
                  f"and {got['kv_bytes'] / 2**20:.1f} MiB of KV / SSM state "
                  f"(one rank {w['weight_bytes'] / 2**20:.1f} / "
                  f"{w['kv_bytes'] / 2**20:.1f} MiB); transfers per steady "
                  f"iteration {got['steady']} (one rank {w['steady']}); "
                  f"launches per rank {got['launches']}", flush=True)
        print(f"      6k ({dp}, {tp}) collectives on rank 0: "
              f"{ranks[0]['collectives']}", flush=True)
    print(f"      family-mesh launches (every rank, engine runs): "
          f"{json.dumps(launches)}", flush=True)
    return launches, want


# ---------------------------------------------------------------------------
# Phase 6l: serving with the weights or the KV sequence over the data axis,
# one world of 4 ranks at (2, 2) on this card over gloo, f32 with TF32 off.
# The tables are `choose_rules`' for the FULL-depth configs (the threshold
# reads `param_count`, which falls with a depth cut), applied to the
# depth-cut models.
FSDP_ARCH, FSDP_DEPTH = "deepseek-67b", 2          # 2 of 95 layers
FSDP_MESH = (2, 2)
# phase 6i's 6 requests on 8 slots of 512; alpha 4 gives both FC variants
FSDP_ENGINE = dict(max_slots=8, cache_capacity=512, prefill_len=64, alpha=4)
# the decode cell's 8 rows (positions in every quarter of a 512-position
# slab) and the FSDP prefill's 4 prompts of a 512-token window
FSDP_DECODE_POS = [500, 100, 300, 7, 250, 450, 130, 383]
FSDP_PREFILL_LENS = [512, 300, 480, 64]
# long_500k: zamba2-1.2b cut to 12 of 38 layers (two shared-block
# applications) at the full capacity; the KV drawn in chunks of LONG_CHUNK
# positions, each from its own seed, so a rank draws its slice alone and
# the one-rank oracle the whole slab
LONG_ARCH, LONG_DEPTH = "zamba2-1.2b", 12
LONG_CAP, LONG_POS, LONG_STEPS, LONG_CHUNK = 524288, 524280, 4, 4096
# the engines under the long-context tables: (arch, depth, phase 6i case,
# attn_pim table), held to phase 6k's one-rank runs, and the kernel each
# must launch on every rank
LONG_ENGINE_RUNS = (("mamba2-1.3b", 8, "dense", False, "ssd_scan"),
                    ("zamba2-1.2b", 12, "attn_pim", True, "decode_attention"))
FSDP_TIMEOUT_S = 600
# the card's bytes that put the depth-cut deepseek-67b over
# `choose_rules`' threshold in `build_step`; every rank checks that the
# table it gives equals the full config's (`_fsdp_tables`)
CUT_HBM = 1.0


def _seeded_params(cfg, seed: int, rules=None, mesh=None) -> dict:
    """`cfg`'s weights leaf by leaf on the card, leaf i from its own
    generator (seed * 1000 + i): a rank makes each whole leaf, keeps its
    block under `rules` and frees the rest (deepseek-67b's embedding alone
    is 3.4 GB in f32); whole leaves without `rules`."""
    specs = (dict(flatten_tree(param_shardings(cfg, rules, mesh)))
             if rules is not None else None)
    out = {}
    for i, (key, ps) in enumerate(flatten_tree(model_spec(cfg))):
        leaf = init_leaf(cfg, ps, torch.Generator(device=DEV).manual_seed(
            seed * 1000 + i))
        out[key] = leaf if specs is None else local_block(leaf, specs[key],
                                                          mesh)
        del leaf
    return unflatten_tree(out)


def _block_shapes_ok(cfg, params, rules, mesh) -> tuple[bool, int, int]:
    """(every leaf of the rank's params has its rules' block shape, the
    bytes of its "fsdp" leaves (those over "data"), their bytes whole)."""
    specs = dict(flatten_tree(param_shardings(cfg, rules, mesh)))
    held = dict(flatten_tree(params))
    ok, mine, whole = True, 0, 0
    for key, shape in flatten_tree(param_shapes(cfg)):
        block = tuple(hi - lo for lo, hi in (
            block_range(n, e, mesh) for n, e in zip(shape, specs[key])))
        ok = ok and tuple(held[key].shape) == block
        if "data" in specs[key]:
            es = held[key].element_size()
            ok = ok and block != tuple(shape)
            mine += math.prod(block) * es
            whole += math.prod(shape) * es
    return ok, mine, whole


def _fsdp_block_groups(cfg, mesh) -> list:
    """(K, [N of each weight]) of a 2D rank's FC-PIM launches of one
    layer: K over "data" for the column groups, N over "data" for the
    row banks, the heads and the FFN over "model" (the KV heads whole)."""
    dp, tp = mesh
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    return [(d // dp, [q // tp, kv, kv]), (q // tp, [d // dp]),
            (d // dp, [cfg.d_ff // tp] * 2), (cfg.d_ff // tp, [d // dp])]


def _fsdp_kernels() -> None:
    """fc_gemv on a (2, 2) rank's 2D blocks of a deepseek-67b layer (f32,
    and bf16 with the f32 output a 2D rank sums, against the plain
    version, m = 8), then timed in bf16 beside the whole layer, with
    torch.matmul on the same blocks and the bound."""
    gen = torch.Generator(device=DEV).manual_seed(63)
    cfg = get_config(FSDP_ARCH)
    groups = _fsdp_block_groups(cfg, FSDP_MESH)
    for K, ns in groups:
        ws = [torch.randn(K, n, generator=gen, device=DEV) / math.sqrt(K)
              for n in ns]
        x = torch.randn(8, K, generator=gen, device=DEV)
        ys = fc_mod.fc_gemv_group(x, ws)
        torch.cuda.synchronize()
        errs = [max_err(y, fc_mod.fc_gemv_ref(x, w)) for y, w in zip(ys, ws)]
        check(all(ok for _, ok, _ in errs),
              f"6l fc_gemv_group f32 deepseek-67b (2, 2) 2D block m=8 K={K} "
              f"N={ns} ({fc_plan_note(K, ns)}): max_abs_err "
              f"{max(e for e, _, _ in errs):.3e} (tol {errs[0][2]})")
        # bf16 in, the f32 sums out unrounded: the partial products a 2D
        # rank sums over "data" before its one rounding
        xb, wb = x.to(torch.bfloat16), [w.to(torch.bfloat16) for w in ws]
        ys = fc_mod.fc_gemv_group(xb, wb, torch.float32)
        torch.cuda.synchronize()
        errs = [max_err(y, fc_mod.fc_gemv_ref(xb, w, torch.float32))
                for y, w in zip(ys, wb)]
        check(all(y.dtype == torch.float32 for y in ys)
              and all(ok for _, ok, _ in errs),
              f"6l fc_gemv_group bf16 -> f32 out deepseek-67b (2, 2) 2D "
              f"block m=8 K={K} N={ns}: max_abs_err "
              f"{max(e for e, _, _ in errs):.3e} (tol {errs[0][2]}, the "
              f"f32 sums of exact bf16 products)")
        del ws, x, ys, xb, wb
    _fc_group_times(gen, groups, "a (2, 2) rank's 2D blocks of a "
                    "deepseek-67b layer", reps=3)
    _fc_group_times(gen, fc_groups(cfg), "deepseek-67b's whole layer",
                    reps=3)
    torch.cuda.empty_cache()


def _fsdp_tables(mesh) -> dict:
    """The FULL-depth configs' tables on `mesh`: deepseek-67b's 2D decode
    (decode_32k) and FSDP prefill (prefill_32k), zamba2's long_500k."""
    full = get_config(FSDP_ARCH)
    return {"decode": choose_rules(full, SHAPES["decode_32k"], mesh),
            "prefill": choose_rules(full, SHAPES["prefill_32k"], mesh),
            "long": choose_rules(get_config(LONG_ARCH), SHAPES["long_500k"],
                                 mesh)}


def _fsdp_serve(cfg, params, mesh=None, rules=None) -> dict:
    """Phase 6i's 6 requests on `FSDP_ENGINE`, the launch counts set to 0
    just before `run()`."""
    eng = PapiEngine(cfg, params, mesh=mesh, rules=rules, device=DEV,
                     **FSDP_ENGINE)
    rng = np.random.default_rng(0)
    for i, n in enumerate(MESH_PROMPTS):
        eng.submit(ServeRequest(i, rng.integers(3, cfg.vocab_size,
                                                size=n).tolist(),
                                max_new_tokens=8 + 4 * i))
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(max_iterations=500)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steady = [s for s in eng.stats if s.admitted == 0
              and s.decode_slots and not s.prefill_slots and not s.degraded]
    return dict(streams={r.req_id: list(r.tokens) for r in results},
                reasons=sorted(r.finished_reason for r in results),
                fc=[s.fc_variant for s in eng.stats], wall=wall,
                iterations=len(eng.stats),
                steady_wall=statistics.median(s.wall_s for s in steady),
                wave_wall=statistics.median(s.wall_s for s in eng.stats
                                            if s not in steady),
                tokens=sum(len(r.tokens) for r in results),
                launches=read_counts(),
                steady=sorted({s.transfers for s in steady}),
                budget=eng.transfer_budget, data_split=eng._data_split,
                weight_bytes=_tree_bytes(eng.params))


def _rank_cache_block(cfg, whole: dict, cap: int, rules, mesh) -> dict:
    """This rank's block of a whole dense cache under `rules`."""
    b = whole["pos"].shape[0]
    with axis_rules(rules, mesh):
        cache = init_cache(cfg, b, cap, DEV)
        lo, hi = batch_block(b)
    specs = cache_shardings(cfg, b, cap, rules, mesh)
    for key in ("k", "v"):
        cache[key].copy_(local_block(whole[key], specs[key], mesh))
    cache["pos"] = whole["pos"][lo:hi].clone()
    return cache


def _fsdp_decode_cell(cfg, params, mesh=None, rules=None) -> dict:
    """One decode step over 8 rows of a drawn 512-position cache:
    `build_step`'s decode cell fn (`CUT_HBM`: the 2D table) on the rank's
    blocks under `rules` (the full model's table), or `decode_step` on one
    rank; the logits, and on a rank the collectives the step ran, those
    reckoned, and whether `build_step`'s table is `rules`."""
    gen = torch.Generator(device=DEV).manual_seed(61)
    whole = init_cache(cfg, len(FSDP_DECODE_POS), 512, DEV)
    for key in ("k", "v"):
        whole[key] = (torch.randn(whole[key].shape, generator=gen,
                                  device=DEV) * 0.5).to(whole[key].dtype)
    whole["pos"] = torch.tensor(FSDP_DECODE_POS, dtype=torch.int32,
                                device=DEV)
    tok = torch.randint(3, cfg.vocab_size, (len(FSDP_DECODE_POS), 1),
                        generator=gen, device=DEV, dtype=torch.int32)
    if mesh is None:
        logits, _ = decode_step(cfg, params, whole, tok)
        return {"logits": logits.float().cpu()}
    cache = _rank_cache_block(cfg, whole, 512, rules, mesh)
    del whole
    built = build_step(cfg, SHAPES["decode_32k"], mesh, hbm_bytes=CUT_HBM)
    n0 = mesh.collectives
    logits, cache = built.fn(params, cache, tok)
    ran = mesh.collectives - n0
    with axis_rules(rules, mesh):
        reckoned = collectives_per_forward(cfg, cache, False)
    return {"logits": logits.float().cpu(), "ran": ran,
            "reckoned": reckoned, "table": built.rules == rules}


def _fsdp_prefill(cfg, params, mesh=None, rules=None) -> dict:
    """`build_step`'s prefill cell fn (`CUT_HBM`: the FSDP prefill's
    table, checked against `rules`, the full model's) on the rank's rows
    of 4 prompts of a 512-token window, into its cache block; `prefill` on
    one rank."""
    gen = torch.Generator(device=DEV).manual_seed(62)
    n = len(FSDP_PREFILL_LENS)
    batch = {"tokens": torch.randint(3, cfg.vocab_size, (n, 512),
                                     generator=gen, device=DEV,
                                     dtype=torch.int32),
             "prompt_lens": torch.tensor(FSDP_PREFILL_LENS,
                                         dtype=torch.int32, device=DEV)}
    if mesh is None:
        logits, cache = prefill(cfg, params, batch,
                                init_cache(cfg, n, 512, DEV))
        lo, hi, ran, table = 0, n, 0, True
    else:
        with axis_rules(rules, mesh):
            lo, hi = batch_block(n)
            cache = init_cache(cfg, n, 512, DEV)
        built = build_step(cfg, SHAPES["prefill_32k"], mesh,
                           hbm_bytes=CUT_HBM)
        n0 = mesh.collectives
        logits, cache = built.fn(params, {k: v[lo:hi]
                                          for k, v in batch.items()}, cache)
        ran = mesh.collectives - n0
        table = built.rules == rules
    return {"rows": (lo, hi), "logits": logits.float().cpu(), "ran": ran,
            "table": table,
            "k": cache["k"].float().cpu(), "v": cache["v"].float().cpu(),
            "pos": cache["pos"].cpu()}


def _long_decode(mesh=None, rules=None) -> dict:
    """long_500k: zamba2-1.2b/12 f32 at the full 524288 positions, the KV
    and the SSM state drawn from seeds (a rank draws its slice and heads),
    every row at `LONG_POS`, then `LONG_STEPS` decode steps through
    `build_step`'s long_500k fn (a rank) or `decode_step` (one rank):
    the logits, each step's wall, the KV at the written positions the
    rank holds, its SSM state, its KV bytes and whether `build_step`'s
    table is `rules`."""
    cfg = family_cfg(LONG_ARCH, LONG_DEPTH, "float32")
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0))
    scope = contextlib.nullcontext()
    if mesh is not None:
        params = shard_params(cfg, params, rules, mesh)
        scope = axis_rules(rules, mesh)
    with scope:
        cache = init_cache(cfg, 1, LONG_CAP, DEV)
    lo, span = cache.get("kv_seq", (0,))[0], cache["k"].shape[2]
    for ki, key in enumerate(("k", "v")):
        for app in range(cache[key].shape[0]):
            for c in range(lo // LONG_CHUNK, (lo + span) // LONG_CHUNK):
                gen = torch.Generator(device=DEV).manual_seed(
                    (ki * 8 + app) * 1000 + c)
                part = cache[key][app, :, c * LONG_CHUNK - lo:
                                  (c + 1) * LONG_CHUNK - lo]
                part.copy_(torch.randn(part.shape, generator=gen,
                                       device=DEV) * 0.5)
    gen = torch.Generator(device=DEV).manual_seed(71)
    specs = (cache_shardings(cfg, 1, LONG_CAP, rules, mesh)["ssm"]
             if mesh is not None else None)
    for i, (dst, shape) in enumerate(zip(
            cache["ssm"], cache_shapes(cfg, 1, LONG_CAP)["ssm"])):
        full = torch.randn(shape, generator=gen, device=DEV) * 0.1
        dst.copy_(full if specs is None else local_block(full, specs[i],
                                                         mesh))
    cache["pos"].fill_(LONG_POS)
    toks = torch.randint(3, cfg.vocab_size, (LONG_STEPS, 1, 1),
                         generator=gen, device=DEV, dtype=torch.int32)
    table = True
    if mesh is None:
        def fn(p, c, t):
            return decode_step(cfg, p, c, t)
    else:
        built = build_step(cfg, SHAPES["long_500k"], mesh)
        fn, table = built.fn, built.rules == rules
    kv_bytes = _state_bytes(cache)
    logits, walls = [], []
    for tok in toks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cache = fn(params, cache, tok)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        logits.append(out.float().cpu())
    own = [p for p in range(LONG_POS, LONG_POS + LONG_STEPS)
           if lo <= p < lo + span]
    kv = {key: cache[key][:, :, [p - lo for p in own]].float().cpu()
          for key in ("k", "v")}
    out = {"logits": torch.cat(logits), "walls": walls, "own": own,
           "kv": kv, "ssm": cache["ssm"].ssm.cpu(), "kv_bytes": kv_bytes,
           "table": table}
    del cache, params
    torch.cuda.empty_cache()
    return out


def _fsdp_rank(rank: int, device) -> dict:
    """One rank of phase 6l's (2, 2) world: deepseek-67b/2 under the 2D
    table (the engine in f32 then bf16, the decode cell in both), the FSDP
    prefill (f32), zamba2/12's long_500k decode, then mamba2/8 and
    zamba2/12 in the engine under the long-context tables."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_serving_mesh(*FSDP_MESH, device=device)
    tables = _fsdp_tables(mesh)
    res = {"coords": dict(mesh.coords), "tables": tables,
           "launches": {name: 0 for name in MODS}}

    def count(run):
        for name, n in run["launches"].items():
            res["launches"][name] += n
        return run

    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        cfg = family_cfg(FSDP_ARCH, FSDP_DEPTH, dtype)
        params = _seeded_params(cfg, 0, tables["decode"], mesh)
        if dtype == "float32":
            res["blocks"] = _block_shapes_ok(cfg, params, tables["decode"],
                                             mesh)
        res[f"serve {dtype}"] = count(_fsdp_serve(cfg, params, mesh,
                                                  tables["decode"]))
        res[f"cell {dtype}"] = _fsdp_decode_cell(cfg, params, mesh,
                                                 tables["decode"])
        del params
        torch.cuda.empty_cache()
    cfg = family_cfg(FSDP_ARCH, FSDP_DEPTH, "float32")
    params = _seeded_params(cfg, 0, tables["prefill"], mesh)
    res["prefill"] = _fsdp_prefill(cfg, params, mesh, tables["prefill"])
    del params
    torch.cuda.empty_cache()
    res["fsdp_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["long"] = _long_decode(mesh, tables["long"])
    res["long_s"] = time.perf_counter() - t0
    res["engines"] = {}
    for arch, depth, case, pim, _ in LONG_ENGINE_RUNS:
        cfg = family_cfg(arch, depth, "float32")
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0))
        engine = dict(SSM_MESH_ENGINE,
                      rules=serve_rules(long_context=True, attn_pim=pim))
        res["engines"][f"{arch}/{depth} f32 {case}"] = count(
            _mesh_run(cfg, params, case, mesh, engine))
        del params
        torch.cuda.empty_cache()
    res["collectives"] = mesh.collectives
    return res


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference relative to the largest magnitude."""
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def _equal_tokens(got: dict, want: dict) -> tuple[int, int]:
    same = sum(a == b for r in want for a, b in zip(got.get(r, []), want[r]))
    return same, sum(len(t) for t in want.values())


def phase_fsdp_mesh(family_one: dict) -> dict:
    """Phase 6l (module docstring): the 2D blocks' kernel, the one-rank
    oracles, then the (2, 2) world against them; mamba2 and zamba2 in the
    engine are held to phase 6k's one-rank runs (`family_one`).  Returns
    the launches summed over every rank's engine runs."""
    t_phase = time.perf_counter()
    _fsdp_kernels()
    one = {}
    for dtype in ("float32", "bfloat16"):
        cfg = family_cfg(FSDP_ARCH, FSDP_DEPTH, dtype)
        params = _seeded_params(cfg, 0)
        one[f"serve {dtype}"] = _fsdp_serve(cfg, params)
        one[f"cell {dtype}"] = _fsdp_decode_cell(cfg, params)
        if dtype == "float32":
            one["prefill"] = _fsdp_prefill(cfg, params)
        del params
        torch.cuda.empty_cache()
    one["long"] = _long_decode()
    t0 = time.perf_counter()
    ranks = spawn_world(_fsdp_rank, 4, device="cuda",
                        timeout_s=FSDP_TIMEOUT_S, store_dir=ROOT / "build",
                        threads=2)
    print(f"      6l mesh {FSDP_MESH} world: 4 ranks on one "
          f"{torch.cuda.get_device_name(0)} over gloo, collectives staged "
          f"through host copies; {time.perf_counter() - t0:.1f} s "
          f"(deepseek {max(r['fsdp_s'] for r in ranks):.1f} s, long_500k "
          f"{max(r['long_s'] for r in ranks):.1f} s)", flush=True)
    dp, tp = FSDP_MESH
    t = ranks[0]["tables"]
    check(t["decode"]["fsdp"] == "data" and t["decode"]["batch"] is None
          and t["decode"]["act_kv_seq"] == ("data", "model")
          and t["prefill"]["fsdp"] == "data"
          and t["prefill"]["batch"] == "data"
          and t["long"]["batch"] is None and t["long"]["fsdp"] is None
          and t["long"]["act_kv_seq"] == ("data", "model"),
          f"6l tables of the full configs at {FSDP_MESH}: decode_32k fsdp "
          f"{t['decode']['fsdp']}, batch {t['decode']['batch']}, KV "
          f"sequence {t['decode']['act_kv_seq']}; prefill_32k fsdp "
          f"{t['prefill']['fsdp']}, batch {t['prefill']['batch']}; "
          f"long_500k batch {t['long']['batch']}, KV sequence "
          f"{t['long']['act_kv_seq']}")
    f32, b16 = one["serve float32"], one["serve bfloat16"]
    check({"pu", "pim"} <= set(f32["fc"]),
          f"6l one-rank deepseek-67b/{FSDP_DEPTH} f32: FC variants "
          f"{sorted(set(f32['fc']))}")
    launches = {name: 0 for name in MODS}
    for r, res in enumerate(ranks):
        tag = f"6l rank {r} {res['coords']}"
        check(res["coords"] == {"data": r // tp, "model": r % tp},
              f"{tag}: coordinates")
        got = res["serve float32"]
        check(got["streams"] == f32["streams"]
              and got["reasons"] == f32["reasons"] and got["fc"] == f32["fc"],
              f"{tag} deepseek-67b/{FSDP_DEPTH} f32 2D decode engine: "
              f"streams and FC variants equal the one-rank engine's "
              f"({_first_divergence(got['streams'], f32['streams'])})")
        check(not got["data_split"] and got["steady"] == [got["budget"]]
              and got["launches"]["fc_gemv"] > 0,
              f"{tag} 2D decode engine: batch whole on every data group "
              f"({not got['data_split']}), steady transfers {got['steady']}"
              f" = budget {got['budget']}, fc_gemv launched "
              f"{got['launches']['fc_gemv']} times")
        ok, mine, whole = res["blocks"]
        check(ok, f"{tag}: every weight is its 2D table block (shapes: "
              f"each leaf over 'data' cut); the leaves over 'data' "
              f"{mine / 2**20:.1f} MiB of {whole / 2**20:.1f} MiB whole")
        cell = res["cell float32"]
        err = _rel(cell["logits"], one["cell float32"]["logits"])
        check(err <= 1e-4 and cell["ran"] == cell["reckoned"]
              and cell["table"],
              f"{tag} decode_32k cell (2D table) f32: logits within "
              f"{err:.2e} relative of one rank's (limit 1e-4); "
              f"{cell['ran']} collectives a step, "
              f"{cell['reckoned']} reckoned (collectives_per_forward); "
              f"build_step's table is the full config's ({cell['table']})")
        pf, want = res["prefill"], one["prefill"]
        lo, hi = pf["rows"]
        mesh = types.SimpleNamespace(shape={"data": dp, "model": tp},
                                     coords=res["coords"])
        specs = cache_shardings(family_cfg(FSDP_ARCH, FSDP_DEPTH,
                                           "float32"),
                                len(FSDP_PREFILL_LENS), 512,
                                res["tables"]["prefill"], mesh)
        errs = [_rel(pf["logits"], want["logits"][lo:hi])] + [
            _rel(pf[k], local_block(want[k], specs[k], mesh))
            for k in ("k", "v")]
        check(max(errs) <= 1e-4 and hi - lo == len(FSDP_PREFILL_LENS) // dp
              and torch.equal(pf["pos"], want["pos"][lo:hi]) and pf["table"],
              f"{tag} prefill_32k cell (FSDP prefill) f32, rows {lo}-{hi}: "
              f"last logits within {errs[0]:.2e}, the cache block's K/V "
              f"within {max(errs[1:]):.2e} relative of one rank's (limit "
              f"1e-4); {pf['ran']} collectives; build_step's table is the "
              f"full config's ({pf['table']})")
        lg, lw = res["long"], one["long"]
        err = _rel(lg["logits"], lw["logits"])
        at = [p - LONG_POS for p in lg["own"]]
        kv_ok = not at or all(_rel(lg["kv"][k], lw["kv"][k][:, :, at])
                              <= 1e-4 for k in ("k", "v"))
        sspec = cache_shardings(family_cfg(LONG_ARCH, LONG_DEPTH,
                                           "float32"), 1, LONG_CAP,
                                res["tables"]["long"], mesh)["ssm"].ssm
        s_err = _rel(lg["ssm"], local_block(lw["ssm"], sspec, mesh))
        check(err <= 1e-4 and s_err <= 1e-4 and kv_ok and lg["table"],
              f"{tag} long_500k {LONG_ARCH}/{LONG_DEPTH} f32 at "
              f"{LONG_CAP} positions, {LONG_STEPS} steps from {LONG_POS}: "
              f"logits within {err:.2e}, SSM state within {s_err:.2e} "
              f"relative of one rank's (limit 1e-4); the K/V it holds of "
              f"the written positions {lg['own']} within 1e-4 of one "
              f"rank's ({kv_ok}); build_step's table is choose_rules' "
              f"({lg['table']})")
        for label, got in res["engines"].items():
            w = family_one[label]
            kern = next(k for a, d, c, p, k in LONG_ENGINE_RUNS
                        if label.startswith(f"{a}/{d}"))
            check(got["streams"] == w["streams"]
                  and got["reasons"] == w["reasons"]
                  and got["fc"] == w["fc"]
                  and got["steady"] == [got["budget"]]
                  and got["launches"][kern] > 0,
                  f"{tag} {label} (long-context table): streams and FC "
                  f"variants equal phase 6k's one-rank engine's "
                  f"({_first_divergence(got['streams'], w['streams'])}); "
                  f"steady transfers {got['steady']} (budget "
                  f"{got['budget']}); {kern} launched {got['launches'][kern]}"
                  " times")
        for name, n in res["launches"].items():
            launches[name] += n
    r0 = ranks[0]
    got = r0["serve float32"]
    print(f"      6l deepseek-67b/{FSDP_DEPTH} f32 2D decode (2, 2) "
          f"[{CARD}]: {got['tokens'] / got['wall']:.1f} tok/s "
          f"({got['wall']:.2f} s, {got['iterations']} iterations) vs one "
          f"rank {f32['tokens'] / f32['wall']:.1f} tok/s "
          f"({f32['wall']:.2f} s); steady decode iteration wall median "
          f"{got['steady_wall'] * 1e3:.1f} ms (one rank "
          f"{f32['steady_wall'] * 1e3:.1f}), admission and chunk waves "
          f"{got['wave_wall'] * 1e3:.1f} ms ({f32['wave_wall'] * 1e3:.1f}); "
          f"a rank holds "
          f"{got['weight_bytes'] / 2**20:.1f} MiB of weights (one rank "
          f"{f32['weight_bytes'] / 2**20:.1f} MiB; the embedding stays "
          f"whole over 'data'); {r0['cell float32']['reckoned']} "
          f"collectives a decode step, each staged through a host copy; "
          f"transfers per steady iteration {got['steady']}; launches per "
          f"rank {got['launches']}", flush=True)
    bf = r0["serve bfloat16"]
    same, total = _equal_tokens(bf["streams"], b16["streams"])
    same32, total32 = _equal_tokens(b16["streams"], f32["streams"])
    got, want = r0["cell bfloat16"]["logits"], one["cell bfloat16"]["logits"]
    exact = one["cell float32"]["logits"]
    print(f"      6l deepseek-67b/{FSDP_DEPTH} bf16 2D decode (2, 2) "
          f"[{CARD}], report only: decode cell logits within "
          f"{_rel(got, want):.3e} relative of one rank's bf16 (max abs "
          f"{(got - want).abs().max().item():.3e}); against one rank's "
          f"f32: the 2D bf16 {_rel(got, exact):.3e}, one rank's bf16 "
          f"{_rel(want, exact):.3e}; engine tokens equal to one rank's "
          f"bf16 {same} of {total} (one rank's bf16 to its f32: {same32} "
          f"of {total32}); "
          f"{bf['tokens'] / bf['wall']:.1f} tok/s vs one rank "
          f"{b16['tokens'] / b16['wall']:.1f} tok/s", flush=True)
    lg, lw = r0["long"], one["long"]
    print(f"      6l long_500k {LONG_ARCH}/{LONG_DEPTH} f32 (2, 2) [{CARD}]: "
          f"decode step wall median "
          f"{statistics.median(lg['walls'][1:]) * 1e3:.1f} ms (one rank "
          f"{statistics.median(lw['walls'][1:]) * 1e3:.1f} ms); a rank "
          f"holds {lg['kv_bytes'] / 2**30:.2f} GiB of KV and SSM state "
          f"(one rank {lw['kv_bytes'] / 2**30:.2f} GiB)", flush=True)
    for label, got in r0["engines"].items():
        w = family_one[label]
        print(f"      6l (2, 2) {label} long-context table: "
              f"{got['tokens'] / got['wall']:.1f} tok/s vs one rank "
              f"{w['tokens'] / w['wall']:.1f} tok/s [{CARD}]; launches per "
              f"rank {got['launches']}", flush=True)
    print(f"      6l collectives on rank 0: {r0['collectives']}; "
          f"launches (every rank, engine runs): {json.dumps(launches)}; "
          f"6l: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def main() -> int:
    global CARD
    card = CARD = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    secs = _build.build_all()
    print(f"built {', '.join(_build.KERNELS)} for sm_90a in {secs:.1f} s",
          flush=True)

    t_start = time.perf_counter()

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"      [{fn.__name__}: {time.perf_counter() - t0:.1f} s, "
              f"{time.perf_counter() - t_start:.1f} s in all]", flush=True)
        return out

    fc = timed(phase_fc_gemv)
    at = timed(phase_decode_attention)
    pa = timed(phase_paged_attention)
    ssd = timed(phase_ssd_scan)
    timed(phase_alpha)
    launches, params, plain = timed(phase_main_path)
    timed(phase_long_context, params)
    spec_launches = timed(phase_spec, params, plain)
    timed(phase_tlp_register, params)
    serve_launches = timed(phase_serve, params, plain)
    failure_launches = timed(phase_failure, params, plain)
    durable_launches = timed(phase_durability, params, plain)
    traced_launches = timed(phase_tracing, params)
    timed(phase_sanitizer, params)
    timed(phase_journal_cost, params)
    timed(phase_trace, params)
    timed(phase_guard_cost)
    timed(phase_spec_trace, params)
    timed(phase_serve_trace, params)
    del params
    timed(phase_parity)
    timed(phase_spec_parity)
    timed(phase_serve_parity)
    timed(phase_failure_parity)
    timed(phase_durability_parity)
    ssm_launches, ssm_params, ssm_info = timed(phase_ssm_paths)
    ssm_spec_launches = timed(phase_ssm_spec, ssm_params, ssm_info)
    timed(phase_ssm_decode_trace, ssm_params)
    timed(phase_wave_trace, ssm_params)
    timed(phase_ssm_state_cost, ssm_params)
    del ssm_params
    timed(phase_ssm_parity)
    timed(phase_ssm_spec_parity)
    timed(phase_family_kernels)
    family_launches = timed(phase_family_paths)
    timed(phase_family_parity)
    mesh_launches, mesh_one = timed(phase_mesh)
    data_launches = timed(phase_data_mesh, mesh_one)
    family_mesh_launches, family_one = timed(phase_family_mesh)
    fsdp_launches = timed(phase_fsdp_mesh, family_one)
    del family_one
    train_launches = timed(phase_training)
    train_mesh_launches = timed(phase_train_mesh)
    # the sum over every path's run, each with the counts set to 0 just
    # before it
    print(f"      launches by path: qwen2-0.5b dense and paged (phases 4, "
          f"4b): {json.dumps(launches)}; qwen2-0.5b speculative (phase 4f, "
          f"8 runs): {json.dumps(spec_launches)}; qwen2-0.5b serve() "
          f"(phases 4h, 4i, 6 runs): {json.dumps(serve_launches)}; "
          f"qwen2-0.5b failure model (phase 4j, 5 runs): "
          f"{json.dumps(failure_launches)}; qwen2-0.5b crash and restore "
          f"(phase 4k, 3 runs and their recoveries): "
          f"{json.dumps(durable_launches)}; qwen2-0.5b traced (phase 4l, "
          f"2 runs): {json.dumps(traced_launches)}; "
          + "; ".join(f"{arch}: {json.dumps(ln)}"
                      for arch, ln in ssm_launches.items())
          + f"; mamba2-1.3b/24 and zamba2-1.2b/18 speculative (phase 4o, "
          f"4 runs and their 2 TLP = 1 runs): "
          f"{json.dumps(ssm_spec_launches)}"
          + f"; the other families (phase 4n, 25 runs): "
          f"{json.dumps(family_launches)}; mesh (phase 6i, 2 ranks x 6 "
          f"runs): {json.dumps(mesh_launches)}; data mesh (phase 6j, "
          f"4 ranks x 4 runs and 2 ranks x 3): {json.dumps(data_launches)}; "
          f"family mesh (phase 6k, 2 ranks x 6 runs and 4 ranks x 1): "
          f"{json.dumps(family_mesh_launches)}; weights and KV sequence "
          f"over 'data' (phase 6l, 4 ranks x 4 engine runs): "
          f"{json.dumps(fsdp_launches)}; training (phase 7): "
          f"{json.dumps(train_launches)}; training over the mesh "
          f"(phase 7f, 4 ranks): {json.dumps(train_mesh_launches)}",
          flush=True)
    launches = {name: n + spec_launches[name] + serve_launches[name]
                + failure_launches.get(name, 0)
                + durable_launches.get(name, 0)
                + traced_launches.get(name, 0)
                + sum(ln[name] for ln in ssm_launches.values())
                + ssm_spec_launches[name]
                + family_launches[name]
                + mesh_launches[name] + data_launches[name]
                + family_mesh_launches[name] + fsdp_launches[name]
                for name, n in launches.items()}

    rows = [
        dict(name="fc_gemv", route="cuda",
             source="src/repro_torch/kernels/csrc/fc_gemv.cu",
             replaces="src/repro/kernels/fc_gemv.py:86",
             launches=launches["fc_gemv"], **fc),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:152",
             launches=launches["decode_attention"], **at),
        dict(name="paged_decode_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_decode_attention.cu",
             replaces="src/repro/kernels/paged_decode_attention.py:77",
             launches=launches["paged_decode_attention"], **pa),
        dict(name="ssd_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:78",
             launches=launches["ssd_scan"], **ssd),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card, flush=True)
    if FAILURES:
        print(f"{len(FAILURES)} check(s) failed:", *FAILURES, sep="\n  ",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
