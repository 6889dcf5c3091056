"""A/B timing of the port's kernels of this checkout against those of
another checkout (e.g. the parent commit), on one card, in turns.

    git archive <parent> | tar -x -C build/parent
    python3 chip_ab.py build/parent        # Attn-PIM
    python3 chip_ab.py --sweep             # this checkout alone: NS sweep
    python3 chip_ab.py --fc build/parent   # FC-PIM, its planner and m
    python3 chip_ab.py --ssd build/parent  # the SSD scan and its sweep

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

With ``--ssd`` it works on the SSD chunk scan (`ssd_scan`):
  * ptxas's registers, stack and spills of the main mix's instances
    (dtx f32, B/C/y bf16) of both kernels;
  * at mamba2-1.3b's and zamba2-1.2b's main-path shapes
    (`chip_smoke.SSD_SHAPES`; the main mix, three input sets of 137 MB
    past L2): the other checkout's wrapper (``parent``) against this
    one's (``kernel``), in the order parent, kernel, kernel, parent,
    twice, with how far the two are apart in y and in the state and each
    CUDA launch's device time;
  * this checkout's kernel built with each choice of `SSD_SWEEP` (blocks
    an SM, the state update on tensor cores or CUDA cores and its
    register tile: the data behind the kernel's constants), and with
    each part of `SSD_CUTS` cut out (the output is then wrong: only the
    time is read, and the time saved is what the part costs);
  * the rounding study behind the kernel's precision: the plain
    version's algorithm with P = C·Bᵀ∘L, dtx and S rounded as
    `SSD_ROUNDINGS` lists before their products (bf16 or TF32, to
    nearest), at the main shapes and both decay laws of
    `chip_smoke._ssd_inputs`, y stored in bf16, each held against the
    f32 plain version under `chip_smoke.max_err`'s rule at 5e-2: the
    worst |err| / (tol + tol·|ref|) (above 1 fails), beside the kernel's;
and prints one JSON line.
"""
from __future__ import annotations

import ctypes
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs  # exits without a card or outside a checkout
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as attn_mod
from repro_torch.kernels import fc_gemv as fc_mod
from repro_torch.kernels import paged_decode_attention as paged_mod
from repro_torch.kernels import ssd_scan as ssd_mod

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
# label -> the nvcc defines of one build of ssd_scan.cu (the first is the
# committed kernel)
SSD_SWEEP = {
    "2 blocks/SM, state 3xTF32": [],
    "1 block/SM, state 3xTF32": ["-DSSD_MIN_BLOCKS=1"],
    "2 blocks/SM, state f32 FMA 8x8": ["-DSSD_STATE_FMA=1"],
    "2 blocks/SM, state f32 FMA 4x8": ["-DSSD_STATE_FMA=1",
                                       "-DSSD_STATE_TP=4"],
}
# part -> (text of ssd_scan.cu, its replacement): a build that skips it
SSD_CUTS = {
    "the state update (phase B)": (
        "    const float last = cum[cs - 1];",
        "    if (nh > 0) continue;\n    const float last = cum[cs - 1];"),
    "y (phase A)": (
        "  load_rows<TX, TX, HP, LXS>(xsrc, SSD_RT, cs, xstage(0));",
        "  if (cs > 0) return;\n"
        "  load_rows<TX, TX, HP, LXS>(xsrc, SSD_RT, cs, xstage(0));"),
    "building P (C·Bᵀ fetch, exps, stores)": (
        "      store_p<LDP, true>(pre, Pt, cum, i0, jt * SSD_RT, cs);", ""),
    "P's exps": ("? src[u] * __expf(ci - cj[u]) : 0.f;",
                 "? src[u] * (ci - cj[u]) : 0.f;"),
    "phase A's dtx tile copies": (
        "        load_rows<TX, TX, HP, LXS>(xsrc + (long)njt * SSD_RT * HP, "
        "SSD_RT,\n                                   cs - njt * SSD_RT, "
        "xstage((pair + 1) & 1));", ""),
    "the inter-chunk mma": (
        "    for (int k0 = 0; k0 < N; k0 += 8) {\n      const TBC* cp",
        "    for (int k0 = 0; k0 < N && cs < 0; k0 += 8) {\n"
        "      const TBC* cp"),
    "the intra-chunk mma": (
        "      for (int k0 = 0; k0 < kend; k0 += 8) {",
        "      for (int k0 = 0; k0 < kend && cs < 0; k0 += 8) {"),
    "the state mma": (
        "    for (int k0 = 0; k0 < SSD_RT; k0 += 8) {\n      const float w0",
        "    for (int k0 = 0; k0 < SSD_RT && ntile < 0; k0 += 8) {\n"
        "      const float w0"),
}
# label -> the rounding of (P, dtx, S) before their products
SSD_ROUNDINGS = {
    "bf16 P, dtx and S": ("bf16", "bf16", "bf16"),
    "bf16 P": ("bf16", None, None),
    "bf16 dtx": (None, "bf16", None),
    "bf16 S": (None, None, "bf16"),
    "TF32 P, dtx and S (the kernel's)": ("tf32", "tf32", "tf32"),
}


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


def ssd_variant_libs() -> tuple[dict, dict, str]:
    """(prepare, launch) of ssd_scan.cu built with each `SSD_SWEEP`
    choice and with each `SSD_CUTS` part cut out, one nvcc each, started
    together; and ptxas's report of the committed source."""
    out_dir = _build.BUILD_DIR / "ssd_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "ssd_scan.cu").read_text()
    jobs = {("sweep", label): (text, defines)
            for label, defines in SSD_SWEEP.items()}
    for label, (old, new) in SSD_CUTS.items():
        if text.count(old) != 1:
            raise RuntimeError(f"cut {label!r}: its text is not in the "
                               "source once")
        jobs[("cut", label)] = (text.replace(old, new), [])
    procs = {}
    for i, (key, (src, defines)) in enumerate(jobs.items()):
        cu, so = out_dir / f"ssd_scan-{i}.cu", out_dir / f"libssd_scan-{i}.so"
        cu.write_text(src)
        procs[key] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    procs["ptxas"] = (None, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out_dir / "libssd_scan-ptxas.so"),
         str(_build.CSRC / "ssd_scan.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs: dict = {"sweep": {}, "cut": {}}
    report = ""
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log.decode()}")
        if key == "ptxas":
            report = log.decode()
        else:
            libs[key[0]][key[1]] = ssd_mod.bind(ctypes.CDLL(str(so)))
    return libs["sweep"], libs["cut"], report


def ptxas_lines(report: str) -> list[str]:
    """Registers, stack and spills of the main mix's instances (dtx f32,
    B/C/y bf16) of both kernels, from ptxas's -v report."""
    lines = report.splitlines()
    out = []
    for i, ln in enumerate(lines):
        if "Compiling entry function" not in ln:
            continue
        name = ln.split("'")[1]
        main = ("ssd_scan_kernelIf13__nv_bfloat16S0_Li64" in name
                or "ssd_cb_kernelI13__nv_bfloat16Li" in name)
        if main:
            info = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                    if "bytes stack" in x or "Used" in x]
            out.append(f"{name}: {'; '.join(info)}")
    return out


def _round(x: torch.Tensor, how: str | None) -> torch.Tensor:
    """x (f32) rounded to nearest bf16 or TF32 (10 mantissa bits)."""
    if how == "bf16":
        return x.to(torch.bfloat16).float()
    if how == "tf32":
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x


def rounded_scan(dtx, lt, B, C, cs: int, rounding) -> torch.Tensor:
    """y of `ssd_scan_ref`'s algorithm (zero initial state) with P, dtx
    and S rounded as `rounding` says before their products, f32 sums."""
    r_p, r_x, r_s = rounding
    b, nh, l, hp = dtx.shape
    n, nc = B.shape[-1], l // cs
    x = dtx.float().reshape(b, nh, nc, cs, hp)
    cum = ssd_mod.chunk_cumsum(lt, cs)
    Bc = B.float().reshape(b, nc, cs, n)
    Cc = C.float().reshape(b, nc, cs, n)
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    mask = torch.ones((cs, cs), dtype=torch.bool, device=dtx.device).tril()
    L = torch.where(mask, torch.exp(cum[..., :, None] - cum[..., None, :]),
                    torch.zeros((), device=dtx.device))
    y = torch.einsum("bhcij,bhcjp->bhcip", _round(CB[:, None] * L, r_p),
                     _round(x, r_x))
    d2e = torch.exp(cum[..., -1:] - cum)
    s_chunk = torch.einsum("bhcjp,bcjn->bhcpn", x * d2e[..., None], Bc)
    state = torch.zeros((b, nh, hp, n), device=dtx.device)
    inter = []
    for c in range(nc):
        inter.append(torch.einsum("bin,bhi,bhpn->bhip", Cc[:, c],
                                  torch.exp(cum[:, :, c]),
                                  _round(state, r_s)))
        state = torch.exp(cum[:, :, c, -1])[..., None, None] * state + \
            s_chunk[:, :, c]
    y = y + torch.stack(inter, dim=2)
    return y.reshape(b, nh, l, hp).to(torch.bfloat16)


def ssd_rounding() -> dict:
    """Worst |err| / (tol + tol·|ref|) of each `SSD_ROUNDINGS` entry and
    of the kernel, per main shape and decay law."""
    f32, bf16 = torch.float32, torch.bfloat16
    tol = cs.SSD_TOL[bf16]
    gen = torch.Generator(device=cs.DEV).manual_seed(12)
    res: dict = {}
    for arch, (b, nh, l, hp, n, ch) in cs.SSD_SHAPES.items():
        for slow in (False, True):
            dtx, lt, B, C, _ = cs._ssd_inputs(gen, b, nh, l, hp, n, f32,
                                              bf16, slow)
            ref, _ = ssd_mod.ssd_scan_ref(dtx, lt, B, C, chunk=ch,
                                          out_dtype=bf16)
            ref = ref.float()
            got = {label: rounded_scan(dtx, lt, B, C, ch, how)
                   for label, how in SSD_ROUNDINGS.items()}
            got["the kernel"], _ = ssd_mod.ssd_scan(dtx, lt, B, C, chunk=ch,
                                                    out_dtype=bf16)
            worst = {label: ((y.float() - ref).abs()
                             / (tol + tol * ref.abs())).max().item()
                     for label, y in got.items()}
            key = f"{arch} {'slow' if slow else 'fast'} decay"
            print(f"{key}: worst |err| / (tol + tol|ref|) at tol {tol}: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in worst.items()),
                  flush=True)
            res[key] = worst
            del dtx, lt, B, C, ref, got
    return res


def ssd(root: Path) -> int:
    """The SSD scan: parent against this checkout, then the sweep."""
    print(cs.card_line(), flush=True)
    _build.build_all(("ssd_scan",))
    p_ssd = other_modules(root, ("ssd_scan",))["ssd_scan"].ssd_scan
    libs, cuts, report = ssd_variant_libs()
    for line in ptxas_lines(report):
        print(f"ptxas: {line}", flush=True)
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=cs.DEV).manual_seed(11)
    res: dict = {}
    for arch, (b, nh, l, hp, n, ch) in cs.SSD_SHAPES.items():
        sets = []
        for _ in range(3):
            dtx, lt, B, C, _ = cs._ssd_inputs(gen, b, nh, l, hp, n, f32, bf16)
            sets.append((dtx, lt, B, C, torch.zeros(b, nh, hp, n,
                                                    device=cs.DEV)))
        fns = {
            "parent": lambda dtx, lt, B, C, s0: p_ssd(
                dtx, lt, B, C, chunk=ch, init_state=s0, out_dtype=bf16),
            "kernel": lambda dtx, lt, B, C, s0: ssd_mod.ssd_scan(
                dtx, lt, B, C, chunk=ch, init_state=s0, out_dtype=bf16),
        }
        (py, ps), (ky, ks) = fns["parent"](*sets[0]), fns["kernel"](*sets[0])
        torch.cuda.synchronize()
        dy = (py.float() - ky.float()).abs().max().item()
        ds = (ps - ks).abs().max().item()
        per = cs.ssd_launch_ms(fns["kernel"], sets)
        b_ms, b_by = cs.ssd_tc_bound(b, nh, l, hp, n, ch)
        f_ms, _ = cs.ssd_bound(b, nh, l, hp, n, ch)
        print(f"{arch}: |kernel - parent| max y {dy:.3e}, state {ds:.3e}; "
              "per launch " + ", ".join(f"{k} {v:.4f} ms"
                                        for k, v in per.items())
              + f"; bound {b_ms:.4f} ms ({b_by}), every product in f32 "
              f"{f_ms:.4f} ms", flush=True)
        got = {name: [] for name in fns}
        for name in ("parent", "kernel", "kernel", "parent") * 2:
            got[name].append(cs.time_ms(fns[name], sets))
        print(f"{arch}: " + ", ".join(
            f"{name} {statistics.median(x):.4f} ms "
            f"({', '.join(f'{y:.4f}' for y in x)})"
            for name, x in got.items()), flush=True)
        committed = ssd_mod._launch_fns()
        times, saved = {}, {}
        try:
            for label, lib_fns in libs.items():
                ssd_mod._fns = lib_fns
                times[label] = cs.time_ms(fns["kernel"], sets)
            base = times[next(iter(SSD_SWEEP))]
            for label, lib_fns in cuts.items():
                ssd_mod._fns = lib_fns
                saved[label] = base - cs.time_ms(fns["kernel"], sets)
        finally:
            ssd_mod._fns = committed
        print(f"{arch}: ms by build: " + ", ".join(
            f"{k} {v:.4f}" for k, v in times.items()), flush=True)
        print(f"{arch}: ms saved by cutting: " + ", ".join(
            f"{k} {v:.4f}" for k, v in saved.items()), flush=True)
        res[arch] = {**{k: statistics.median(v) for k, v in got.items()},
                     "per_launch": per, "bound": b_ms, "f32_bound": f_ms,
                     "sweep": times, "cuts": saved}
        del sets, py, ps, ky, ks
    res["rounding"] = ssd_rounding()
    print(json.dumps(res))
    return 0


def main() -> int:
    if sys.argv[1] == "--sweep":
        return sweep()
    if sys.argv[1] == "--fc":
        return fc(Path(sys.argv[2]).resolve())
    if sys.argv[1] == "--ssd":
        return ssd(Path(sys.argv[2]).resolve())
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
