"""A/B timing of the Attn-PIM kernels of this checkout against the dense
kernel of another checkout (e.g. the parent commit), on one card, in turns.

    git archive <parent> | tar -x -C build/parent
    python3 chip_ab.py build/parent

Builds the other checkout's ``csrc/decode_attention.cu`` with this
checkout's nvcc flags, then times on the same inputs (the main path's
shapes, bf16, b=8, nkv=2, g=7, hd=64, ragged lens up to 2048, t = 1 and
64), in the order parent, dense, paged, dense, parent — twice:
  * ``parent``: the other checkout's dense kernel;
  * ``dense``: this checkout's dense kernel;
  * ``paged``: this checkout's paged kernel over a shuffled 16-token page
    pool holding the same contents.
Each number is `chip_smoke.time_ms`'s device time per call (CUDA events,
12 argument sets to exceed L2).  Prints the card line and one JSON line of
medians.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs  # exits without a card or outside a checkout
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as attn_mod
from repro_torch.kernels import paged_decode_attention as paged_mod

LENS = {1: [1, 32, 33, 2048, 100, 513, 1000, 7],
        64: [64, 65, 96, 2048, 128, 513, 1000, 200]}


def other_dense(root: Path):
    """The other checkout's dense launch function, built here."""
    src = root / "src" / "repro_torch" / "kernels" / "csrc" / \
        "decode_attention.cu"
    out = _build.BUILD_DIR / "ab" / "libdecode_attention_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True)
    fn = ctypes.CDLL(str(out)).decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(q, k, v, lens, t):
        b, nkv, tg, hd = q.shape
        o = torch.empty_like(q)
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        lens.data_ptr(), o.data_ptr(), b, nkv, tg, hd,
                        k.shape[1], t, 1,
                        torch.cuda.current_stream().cuda_stream), "other")
        return o
    return call


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    print(cs.card_line(), flush=True)
    _build.build_all(("decode_attention", "paged_decode_attention"))
    parent = other_dense(root)
    gen = torch.Generator(device=cs.DEV).manual_seed(7)
    res: dict[str, dict[str, list[float]]] = {}
    for t, lens in LENS.items():
        sets = []
        for _ in range(12):
            q, k, v, ln = cs._attn_inputs(gen, torch.bfloat16, t, lens)
            perm = torch.randperm(1024, generator=gen, device=cs.DEV) + 1
            tables = perm.reshape(8, 128).to(torch.int32).contiguous()
            kp = torch.zeros(1025, 16, 2, 64, dtype=k.dtype, device=cs.DEV)
            vp = torch.zeros_like(kp)
            kp[tables.long()] = k.reshape(8, 128, 16, 2, 64)
            vp[tables.long()] = v.reshape(8, 128, 16, 2, 64)
            sets.append((q, k, v, ln, kp, vp, tables))
        a = parent(*sets[0][:4], t)
        d = attn_mod.decode_attention(*sets[0][:4], q_rows=t)
        p = paged_mod.paged_decode_attention(sets[0][0], *sets[0][4:6],
                                             sets[0][3], sets[0][6], q_rows=t)
        torch.cuda.synchronize()
        print(f"t={t}: dense == parent {torch.equal(a, d)}, paged == dense "
              f"{torch.equal(p, d)}", flush=True)
        fns = {
            "parent": lambda q, k, v, ln, kp, vp, tab: parent(q, k, v, ln, t),
            "dense": lambda q, k, v, ln, kp, vp, tab:
                attn_mod.decode_attention(q, k, v, ln, q_rows=t),
            "paged": lambda q, k, v, ln, kp, vp, tab:
                paged_mod.paged_decode_attention(q, kp, vp, ln, tab,
                                                 q_rows=t),
        }
        got = res.setdefault(f"t={t}", {n: [] for n in fns})
        for name in ("parent", "dense", "paged", "dense", "parent") * 2:
            got[name].append(cs.time_ms(fns[name], sets))
        print(f"t={t}: " + ", ".join(
            f"{n} {statistics.median(x):.4f} ms ({', '.join(f'{y:.4f}' for y in x)})"
            for n, x in got.items()), flush=True)
        del sets
    print(json.dumps({k: {n: statistics.median(x) for n, x in v.items()}
                      for k, v in res.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
