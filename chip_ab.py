"""A/B timing of the Attn-PIM kernels of this checkout against those of
another checkout (e.g. the parent commit), on one card, in turns.

    git archive <parent> | tar -x -C build/parent
    python3 chip_ab.py build/parent
    python3 chip_ab.py --sweep        # this checkout alone: NS sweep

Imports the other checkout's kernel wrappers (`decode_attention`,
`paged_decode_attention`) as modules of their own, which build its
sources into its own ``build/``, so the two may differ in their C
interface.  Then times, on the same bf16 inputs at the main paths'
shapes, in the order parent dense, parent paged, dense, paged, SDPA,
paged, dense, parent paged, parent dense — twice:
  * qwen2-0.5b t=1 and t=64: b=8, nkv=2, g=7, hd=64, S=2048, ragged
    lens up to 2048;
  * zamba2-1.2b's shared block: b=8, nkv=32, g=1, hd=64, S=1024, lens up
    to 576;
  * ``parent dense`` / ``dense``: the two checkouts' dense kernels;
  * ``parent paged`` / ``paged``: their paged kernels over a shuffled
    16-token page pool holding the same contents;
  * ``sdpa``: one `scaled_dot_product_attention` call with the
    window-causal mask over head-major copies of K/V (timed only).
Each number is `chip_smoke.time_ms`'s device time per call (CUDA events,
12 argument sets to exceed L2).  Prints the card line, this checkout's
split plan (row tile, splits, CUDA launches per call) per shape, whether
each paged kernel is bit-equal to its dense one and how far the two
checkouts' dense outputs are apart, and one JSON line of medians.

With ``--sweep`` it times this checkout alone, at the same shapes: the
device time of each CUDA kernel of one call (torch.profiler over 12
dense calls), then the dense and the paged kernel with the split count
forced to each NS in `SWEEP_NS` (the data behind the planner's
constants in `kernels/decode_attention.py`), and one JSON line.
"""
from __future__ import annotations

import importlib
import json
import statistics
import sys
from pathlib import Path

import chip_smoke as cs  # exits without a card or outside a checkout
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as attn_mod
from repro_torch.kernels import paged_decode_attention as paged_mod

# label -> (t, lens, KV geometry)
SHAPES = {
    "qwen2 t=1": (1, [1, 32, 33, 2048, 100, 513, 1000, 7],
                  dict(nkv=2, g=7, S=2048)),
    "qwen2 t=64": (64, [64, 65, 96, 2048, 128, 513, 1000, 200],
                   dict(nkv=2, g=7, S=2048)),
    "zamba2 t=1": (1, [1, 12, 33, 512, 100, 300, 576, 64],
                   dict(nkv=32, g=1, S=1024)),
}
PAGE = 16
SWEEP_NS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)


def other_wrappers(root: Path):
    """(dense, paged) wrapper functions of the checkout at `root`, imported
    under module objects of their own; this checkout's modules are put
    back afterwards."""
    mine = {n: m for n, m in sys.modules.items()
            if n == "repro_torch" or n.startswith("repro_torch.")}
    for n in mine:
        del sys.modules[n]
    src = str(root / "src")
    sys.path.insert(0, src)
    try:
        build = importlib.import_module("repro_torch.kernels._build")
        dense = importlib.import_module("repro_torch.kernels.decode_attention")
        paged = importlib.import_module(
            "repro_torch.kernels.paged_decode_attention")
        build.build_all(("decode_attention", "paged_decode_attention"))
    finally:
        sys.path.remove(src)
        for n in [n for n in sys.modules
                  if n == "repro_torch" or n.startswith("repro_torch.")]:
            del sys.modules[n]
        sys.modules.update(mine)
    return dense.decode_attention, paged.paged_decode_attention


def argsets(gen, t, lens, nkv, g, S, n=12):
    """`n` sets of (q, k, v, lens, k_pages, v_pages, tables, sdpa args)."""
    sets = []
    nblk = S // PAGE
    for _ in range(n):
        q, k, v, ln = cs._attn_inputs(gen, torch.bfloat16, t, lens, nkv=nkv,
                                      g=g, S=S)
        perm = torch.randperm(8 * nblk, generator=gen, device=cs.DEV) + 1
        tables = perm.reshape(8, nblk).to(torch.int32).contiguous()
        kp = torch.zeros(8 * nblk + 1, PAGE, nkv, 64, dtype=k.dtype,
                         device=cs.DEV)
        vp = torch.zeros_like(kp)
        kp[tables.long()] = k.reshape(8, nblk, PAGE, nkv, 64)
        vp[tables.long()] = v.reshape(8, nblk, PAGE, nkv, 64)
        sets.append((q, k, v, ln, kp, vp, tables,
                     cs._sdpa_args(q, k, v, ln, t)))
    return sets


def sweep() -> int:
    """Per-kernel device time of one call and the NS sweep, per shape."""
    print(cs.card_line(), flush=True)
    gen = torch.Generator(device=cs.DEV).manual_seed(7)
    planner = attn_mod.num_splits
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    res: dict[str, dict] = {}
    for label, (t, lens, geo) in SHAPES.items():
        sets = argsets(gen, t, lens, **geo)

        def dense(q, k, v, ln, kp, vp, tab, sd):
            return attn_mod.decode_attention(q, k, v, ln, q_rows=t)

        def paged(q, k, v, ln, kp, vp, tab, sd):
            return paged_mod.paged_decode_attention(q, kp, vp, ln, tab,
                                                    q_rows=t)

        for a in sets[:3]:
            dense(*a)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for a in sets:
                dense(*a)
            torch.cuda.synchronize()
        kern = {e.key.split("(")[0][:48]: e.self_device_time_total / e.count
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0}
        times = {}
        for ns in SWEEP_NS:
            attn_mod.num_splits = paged_mod.num_splits = (
                lambda *_, ns=ns: ns)
            try:
                times[ns] = (cs.time_ms(dense, sets), cs.time_ms(paged, sets))
            finally:
                attn_mod.num_splits = paged_mod.num_splits = planner
        ns0 = planner(8, geo["nkv"], t * geo["g"], attn_mod.sm_count(cs.DEV))
        print(f"{label}: planner NS={ns0}; per call (dense, us): "
              + ", ".join(f"{k} {v:.2f}" for k, v in kern.items()), flush=True)
        print(f"{label}: dense/paged ms by NS: " + ", ".join(
            f"{ns} {d:.4f}/{p:.4f}" for ns, (d, p) in times.items()),
            flush=True)
        res[label] = {"planner_ns": ns0, "kernel_us": kern,
                      "ms_by_ns": {ns: list(v) for ns, v in times.items()}}
        del sets
    print(json.dumps(res))
    return 0


def main() -> int:
    if sys.argv[1] == "--sweep":
        return sweep()
    root = Path(sys.argv[1]).resolve()
    print(cs.card_line(), flush=True)
    _build.build_all(("decode_attention", "paged_decode_attention"))
    p_dense, p_paged = other_wrappers(root)
    gen = torch.Generator(device=cs.DEV).manual_seed(7)
    res: dict[str, dict[str, list[float]]] = {}
    for label, (t, lens, geo) in SHAPES.items():
        sets = argsets(gen, t, lens, **geo)
        rows = t * geo["g"]
        rt = attn_mod.row_tile(rows, torch.bfloat16)
        ns = attn_mod.num_splits(8, geo["nkv"], rows,
                                 attn_mod.sm_count(cs.DEV))
        q, k, v, ln, kp, vp, tab, _ = sets[0]
        a = p_dense(q, k, v, ln, q_rows=t)
        ap = p_paged(q, kp, vp, ln, tab, q_rows=t)
        d = attn_mod.decode_attention(q, k, v, ln, q_rows=t)
        p = paged_mod.paged_decode_attention(q, kp, vp, ln, tab, q_rows=t)
        torch.cuda.synchronize()
        print(f"{label}: row tile {rt}, {ns} splits, "
              f"{attn_mod.cuda_launches(ns)} CUDA launches per call; paged "
              f"== dense {torch.equal(p, d)}, parent paged == parent dense "
              f"{torch.equal(ap, a)}, |dense - parent dense| max "
              f"{(d.float() - a.float()).abs().max().item():.3e}", flush=True)
        fns = {
            "parent dense": lambda q, k, v, ln, kp, vp, tab, sd:
                p_dense(q, k, v, ln, q_rows=t),
            "parent paged": lambda q, k, v, ln, kp, vp, tab, sd:
                p_paged(q, kp, vp, ln, tab, q_rows=t),
            "dense": lambda q, k, v, ln, kp, vp, tab, sd:
                attn_mod.decode_attention(q, k, v, ln, q_rows=t),
            "paged": lambda q, k, v, ln, kp, vp, tab, sd:
                paged_mod.paged_decode_attention(q, kp, vp, ln, tab,
                                                 q_rows=t),
            "sdpa": lambda q, k, v, ln, kp, vp, tab, sd: cs._sdpa(*sd),
        }
        got = res.setdefault(label, {n: [] for n in fns})
        order = ("parent dense", "parent paged", "dense", "paged", "sdpa",
                 "paged", "dense", "parent paged", "parent dense")
        for name in order * 2:
            got[name].append(cs.time_ms(fns[name], sets))
        print(f"{label}: " + ", ".join(
            f"{n} {statistics.median(x):.4f} ms "
            f"({', '.join(f'{y:.4f}' for y in x)})"
            for n, x in got.items()), flush=True)
        del sets
    print(json.dumps({k: {n: statistics.median(x) for n, x in v.items()}
                      for k, v in res.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
