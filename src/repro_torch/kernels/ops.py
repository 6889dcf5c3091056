"""PAPI's two FC execution paths behind one call — the port's
`repro.kernels.ops.fc_forward` — and the timed FC work of one layer that
`core.calibration.calibrate_alpha_measured` compares them on.

``"pim"`` is FC-PIM, the hand-written `fc_gemv` kernel; ``"pu"`` is
``torch.matmul``.  On the CPU the "pim" path is `fc_gemv`'s plain version.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.kernels.fc_gemv import fc_gemv, fc_gemv_group

# one layer's FC groups as the model launches them under "pim": (K, [N of
# each weight]) for q/k/v, o, gate/up and down
QWEN2_FC_GROUPS = [(896, [896, 128, 128]), (896, [896]), (896, [4864, 4864]),
                   (4864, [896])]
# one application of zamba2-1.2b's shared attention + MLP block
ZAMBA2_FC_GROUPS = [(2048, [2048, 2048, 2048]), (2048, [2048]),
                    (2048, [8192, 8192]), (8192, [2048])]


def fc_forward(x: torch.Tensor, w: torch.Tensor,
               variant: str = "pu") -> torch.Tensor:
    """x [m, K] @ w [K, N] -> [m, N] on the FC path `variant` ("pu" or
    "pim")."""
    if variant == "pim":
        return fc_gemv(x, w)
    if variant == "pu":
        return torch.matmul(x, w)
    raise ValueError(f"fc variant must be 'pu' or 'pim', not {variant!r}")


def fc_layer_runners(groups: Sequence[tuple[int, list[int]]], *,
                     max_m: int, dtype: torch.dtype,
                     device: torch.device | str, generator: torch.Generator,
                     copies: int = 1
                     ) -> tuple[Callable[[int], None], Callable[[int], None]]:
    """(run_pu, run_pim) over one layer's FC `groups`: ``run_pu(m)`` runs
    one ``torch.matmul`` per weight, ``run_pim(m)`` one `fc_gemv_group`
    launch per group, both on the first m rows of a [max_m, K] input per
    K, and both block until the device is done.  Each call takes the next
    of `copies` sets of weights, so that with enough copies every call
    finds its weights outside the L2, as a layer of the served model does."""
    dev = torch.device(device)
    xs = {K: torch.randn(max_m, K, generator=generator, device=dev).to(dtype)
          for K, _ in groups}
    sets = [[[(torch.randn(K, n, generator=generator, device=dev)
               / K ** 0.5).to(dtype) for n in ns] for K, ns in groups]
            for _ in range(copies)]
    turn = [0, 0]

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def take(i: int) -> list[list[torch.Tensor]]:
        ws = sets[turn[i] % copies]
        turn[i] += 1
        return ws

    def run_pu(m: int) -> None:
        for (K, _), ws in zip(groups, take(0)):
            for w in ws:
                fc_forward(xs[K][:m], w, "pu")
        sync()

    def run_pim(m: int) -> None:
        for (K, _), ws in zip(groups, take(1)):
            fc_gemv_group(xs[K][:m], ws)
        sync()

    return run_pu, run_pim


__all__ = ["QWEN2_FC_GROUPS", "ZAMBA2_FC_GROUPS", "fc_forward",
           "fc_layer_runners"]
