"""A/B timing of the port's kernels of this checkout against those of
another checkout (e.g. the parent commit), on one card, in turns.

    git archive <parent> | tar -x -C build/parent
    python3 chip_ab.py build/parent        # Attn-PIM
    python3 chip_ab.py --sweep             # this checkout alone: NS sweep
    python3 chip_ab.py --fc build/parent   # FC-PIM, its planner and m

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

With ``--fc`` it times FC-PIM (`fc_gemv`) at m = 8, bf16: one qwen2-0.5b
layer and one zamba2-1.2b shared-block application as the other
checkout's wrapper launches them (``parent``: one `fc_gemv` call per
weight, 7), as this checkout's model launches them (``grouped``: one
`fc_gemv_group` call per FC group, 4) and as ``torch.matmul`` (7 calls,
timed only), in the order parent, grouped, matmul, grouped, parent, twice,
over enough copies of the weights to exceed L2; then, per FC group, the
kernel with the planner's cluster size forced to each of `SWEEP_CLUSTERS`
and its column tile to each of `fc_gemv.COL_TILES` (the data behind the
planner's constants); then one qwen2 layer at each m in `SWEEP_M` against
``torch.matmul`` (whether alpha = 4 holds on this card); and one JSON line.
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
from repro_torch.kernels import fc_gemv as fc_mod
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
SWEEP_CLUSTERS = (1, 2, 4, 8)
SWEEP_M = (1, 2, 4, 8, 16, 32, 64)


def other_modules(root: Path, names: tuple[str, ...]) -> dict:
    """The kernel wrapper modules `names` of the checkout at `root`, built
    from its own sources and imported under module objects of their own;
    this checkout's modules are put back afterwards."""
    mine = {n: m for n, m in sys.modules.items()
            if n == "repro_torch" or n.startswith("repro_torch.")}
    for n in mine:
        del sys.modules[n]
    src = str(root / "src")
    sys.path.insert(0, src)
    try:
        build = importlib.import_module("repro_torch.kernels._build")
        mods = {n: importlib.import_module(f"repro_torch.kernels.{n}")
                for n in names}
        build.build_all(names)
    finally:
        sys.path.remove(src)
        for n in [n for n in sys.modules
                  if n == "repro_torch" or n.startswith("repro_torch.")]:
            del sys.modules[n]
        sys.modules.update(mine)
    return mods


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


def fc_layer_sets(gen, groups, m=8):
    """Copies of one layer's FC groups, enough to exceed L2: a list of
    [(x, [w, ...]) per group], bf16."""
    nbytes = sum(K * sum(ns) * 2 for K, ns in groups)
    copies = max(2, -(-2 * cs.L2_BYTES // nbytes))
    return [[(torch.randn(m, K, generator=gen, device=cs.DEV).to(
        torch.bfloat16), [torch.randn(K, n, generator=gen, device=cs.DEV).to(
            torch.bfloat16) for n in ns]) for K, ns in groups]
        for _ in range(copies)]


def _forced_plan(cluster: int, tile: int):
    """A planner that returns `cluster` ranks and `tile` columns, and raises
    ValueError where K has too few 16-row slices for the ranks."""
    def plan(K, ns, sms=132):
        ks = -(-K // cluster)
        ks = -(-ks // 16) * 16
        if (cluster - 1) * ks >= K:
            raise ValueError("cluster too large for K")
        return fc_mod.FcPlan(cluster, ks, tile)
    return plan


def fc(root: Path) -> int:
    """FC-PIM: parent against grouped against torch.matmul per layer, the
    planner sweep per group, and the m sweep."""
    print(cs.card_line(), flush=True)
    _build.build_all(("fc_gemv",))
    p_fc = other_modules(root, ("fc_gemv",))["fc_gemv"].fc_gemv
    gen = torch.Generator(device=cs.DEV).manual_seed(8)
    layers = {"qwen2 layer": cs.FC_GROUPS,
              "zamba2 application": cs.ZAMBA_FC_GROUPS}
    fns = {
        "parent": lambda layer: [p_fc(x, w) for x, ws in layer for w in ws],
        "grouped": lambda layer: [fc_mod.fc_gemv_group(x, ws)
                                  for x, ws in layer],
        "matmul": lambda layer: [torch.matmul(x, w) for x, ws in layer
                                 for w in ws],
    }
    res: dict = {"ab": {}, "plan": {}, "m": {}}
    for label, groups in layers.items():
        sets = fc_layer_sets(gen, groups)
        layer = sets[0]
        mine, theirs = fns["grouped"](layer), fns["parent"](layer)
        singles = [fc_mod.fc_gemv(x, w) for x, ws in layer for w in ws]
        torch.cuda.synchronize()
        mine = [y for ys in mine for y in ys]
        diff = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(mine, theirs))
        same = all(torch.equal(a, b) for a, b in zip(mine, singles))
        bnd = sum(cs.fc_group_bound(8, K, ns)[0] for K, ns in groups)
        print(f"{label}: {len(groups)} grouped launches against "
              f"{sum(len(ns) for _, ns in groups)} calls; grouped == single "
              f"launches {same}; |grouped - parent| max {diff:.3e}; bound "
              f"{bnd:.4f} ms", flush=True)
        got = {n: [] for n in fns}
        for name in ("parent", "grouped", "matmul", "grouped", "parent") * 2:
            got[name].append(cs.time_ms(fns[name], [(s,) for s in sets]))
        print(f"{label}: " + ", ".join(
            f"{n} {statistics.median(x):.4f} ms "
            f"({', '.join(f'{y:.4f}' for y in x)})" for n, x in got.items()),
            flush=True)
        res["ab"][label] = {n: statistics.median(x) for n, x in got.items()}
        res["ab"][label]["bound"] = bnd
        del sets, layer, mine, theirs, singles

    planner = fc_mod.plan
    for K, ns in dict.fromkeys((K, tuple(ns)) for K, ns in
                               cs.FC_GROUPS + cs.ZAMBA_FC_GROUPS):
        sets = fc_layer_sets(gen, [(K, list(ns))])
        args = [s[0] for s in sets]
        times = {}
        try:
            for cl in SWEEP_CLUSTERS:
                for tile in fc_mod.COL_TILES:
                    fc_mod.plan = _forced_plan(cl, tile)
                    try:
                        fc_mod.plan(K, ns)
                    except ValueError:
                        continue
                    times[f"{cl}x{tile}"] = cs.time_ms(
                        lambda x, ws: fc_mod.fc_gemv_group(x, ws), args)
        finally:
            fc_mod.plan = planner
        p = planner(K, list(ns), attn_mod.sm_count(cs.DEV))
        best = min(times, key=times.get)
        print(f"K={K} N={list(ns)}: planner {p.cluster}x{p.col_tile} "
              f"{times[f'{p.cluster}x{p.col_tile}']:.4f} ms, best {best} "
              f"{times[best]:.4f} ms; ms by cluster x tile: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in times.items()), flush=True)
        res["plan"][f"{K}x{list(ns)}"] = {
            "planner": f"{p.cluster}x{p.col_tile}", "ms": times}
        del sets, args

    # the floor of one launch: one block (K 16, N 32) and one cluster (K
    # 1024, N 32), beside torch.matmul on the same inputs
    for K, N in ((16, 32), (1024, 32)):
        sets = fc_layer_sets(gen, [(K, [N])])
        args = [s[0] for s in sets[:64]]
        k_ms = cs.time_ms(lambda x, ws: fc_mod.fc_gemv_group(x, ws), args)
        l_ms = cs.time_ms(lambda x, ws: torch.matmul(x, ws[0]), args)
        p = planner(K, [N])
        print(f"launch floor K={K} N={N} ({p.cluster}x{p.col_tile}, "
              f"{p.cluster * -(-N // p.col_tile)} blocks): kernel {k_ms:.4f} "
              f"ms, matmul {l_ms:.4f} ms", flush=True)
        res["plan"][f"floor {K}x{N}"] = {"kernel": k_ms, "matmul": l_ms}
        del sets, args

    for m in SWEEP_M:
        sets = fc_layer_sets(gen, cs.FC_GROUPS, m)
        k_ms = cs.time_ms(fns["grouped"], [(s,) for s in sets])
        l_ms = cs.time_ms(fns["matmul"], [(s,) for s in sets])
        print(f"qwen2 layer m={m}: grouped {k_ms:.4f} ms, matmul {l_ms:.4f} "
              f"ms ({l_ms / k_ms:.2f}x)", flush=True)
        res["m"][m] = {"grouped": k_ms, "matmul": l_ms}
        del sets
    print(json.dumps(res))
    return 0


def main() -> int:
    if sys.argv[1] == "--sweep":
        return sweep()
    if sys.argv[1] == "--fc":
        return fc(Path(sys.argv[2]).resolve())
    root = Path(sys.argv[1]).resolve()
    print(cs.card_line(), flush=True)
    _build.build_all(("decode_attention", "paged_decode_attention"))
    mods = other_modules(root, ("decode_attention", "paged_decode_attention"))
    p_dense = mods["decode_attention"].decode_attention
    p_paged = mods["paged_decode_attention"].paged_decode_attention
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
