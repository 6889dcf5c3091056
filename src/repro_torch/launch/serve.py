"""Serving launcher of the port: the PAPI engine on a synthetic trace with
random weights made from ``--seed``.

    python -m repro_torch.launch.serve --arch qwen2-0.5b --requests 8 \\
        --alpha 4 --attn-pim [--kv paged --page-size 16]
    python -m repro_torch.launch.serve --arch zamba2-1.2b --attn-pim
    python -m repro_torch.launch.serve --arch mamba2-1.3b

The SSM (mamba2) and hybrid (zamba2) families reject prompts longer than
``--prefill-len`` and refuse ``--kv paged``, as the reference does.

Runs on the card (``--device cpu`` for the plain PyTorch path).  Prints
the per-iteration scheduler decisions — RLP, TLP, the AI estimate and the
chosen FC path — and, under ``--kv paged``, the page pool's watermark, as
`repro.launch.serve` does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serving import PapiEngine, ServeRequest


def make_requests(n: int, vocab: int, seed: int, max_prompt: int,
                  max_new: int = 64) -> list[ServeRequest]:
    """n requests with seeded random prompts (4..max_prompt tokens) and
    staggered generation budgets (8..max_new tokens)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(4, max_prompt + 1))
        prompt = rng.integers(3, vocab, size=plen).tolist()
        budget = 8 + (max_new - 8) * i // max(n - 1, 1)
        reqs.append(ServeRequest(i, prompt, max_new_tokens=budget))
    return reqs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=2048,
                    help="KV slab length per slot")
    ap.add_argument("--prefill-len", type=int, default=64,
                    help="prefill window; longer prompts are chunked")
    ap.add_argument("--max-prompt", type=int, default=160)
    ap.add_argument("--alpha", type=float, default=4.0)
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
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen)
    eng = PapiEngine(cfg, params, max_slots=args.max_slots,
                     cache_capacity=args.capacity,
                     prefill_len=args.prefill_len, alpha=args.alpha,
                     attn_pim=args.attn_pim, kv_layout=args.kv,
                     page_size=args.page_size, max_blocks=args.max_blocks,
                     device=device)
    for r in make_requests(args.requests, cfg.vocab_size, args.seed,
                           args.max_prompt):
        eng.submit(r)
    t0 = time.perf_counter()
    results = eng.run(max_iterations=4000)
    wall = time.perf_counter() - t0

    by_reason: dict[str, int] = {}
    for r in results:
        by_reason[r.finished_reason] = by_reason.get(r.finished_reason, 0) + 1
    tok = sum(len(r.tokens) for r in results)
    print(f"completed {len(results)} requests in {eng.iteration} iterations "
          f"{dict(sorted(by_reason.items()))} on {device}")
    print(f"tokens: {tok}  wall: {wall:.2f}s  tok/s: {tok / max(wall, 1e-9):.1f}")
    print(f"reschedules: {eng.scheduler.num_reschedules}")
    if eng.kv is not None:
        st = eng.kv.stats()
        frag = max((s.kv_fragmentation for s in eng.stats), default=0.0)
        print(f"kv pages: watermark {st.watermark}/{st.num_pages} "
              f"({st.page_size} tokens/page), peak fragmentation "
              f"{frag:.1%}")
    print("\niter  rlp tlp    AI  fc_path  new_toks")
    for s in eng.stats:
        print(f"{s.iteration:5d} {s.rlp:4d} {s.tlp:3d} {s.ai_estimate:5.1f}  "
              f"{s.fc_variant:7s} {s.new_tokens:5d}")


if __name__ == "__main__":
    main()
