"""Offline alpha calibration (§5.2.1).

"The threshold alpha is determined through offline iterative evaluation,
where we run the FC kernel on both PIM and PU units under varying
parallelization levels, using the observed execution times to establish the
best alpha."

Two calibrators:

* `calibrate_alpha_model` — runs the *analytical* device models (core.pim)
  over an RLP*TLP grid; used by the system simulators that reproduce the
  paper's figures.
* `calibrate_alpha_measured` — times two real callables on the device:
  in the port, `kernels.ops.fc_layer_runners`' ``torch.matmul`` path
  against its `fc_gemv` path, each blocking with
  ``torch.cuda.synchronize()`` (`chip_smoke.py` phase 3e).

The port's copy of `repro.core.calibration`.
"""
from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import pim


def _crossover_alpha(ms: Sequence[int], t_pim: Sequence[float],
                     t_pu: Sequence[float]) -> float:
    """Pick alpha minimizing total misassignment cost over the grid: for a
    threshold a, kernels with m > a run on PU, else PIM."""
    ms = list(ms)
    candidates = [0.5] + [m + 0.5 for m in ms]
    best_a, best_cost = candidates[0], float("inf")
    for a in candidates:
        cost = sum(
            (t_pu[i] if m > a else t_pim[i]) for i, m in enumerate(ms)
        )
        if cost < best_cost:
            best_cost, best_a = cost, a
    return best_a


def calibrate_alpha_model(
    cfg: ModelConfig,
    n_fc_devices: int = 30,
    n_gpus: int = 6,
    ms: Sequence[int] | None = None,
) -> float:
    """Analytical calibration: FC (m, h) @ (h, h) on FC-PIM vs the GPU pool."""
    h = cfg.d_model
    if ms is None:
        ms = [1, 2, 4, 8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512]
    t_pim = [
        pim.FC_PIM.gemv_time(m, h, max(h // n_fc_devices, 1)) for m in ms
    ]
    t_pu = [pim.gpu_fc_time(m, h, h, n_gpus=n_gpus) for m in ms]
    return _crossover_alpha(ms, t_pim, t_pu)


def calibrate_alpha_measured(
    run_pu: Callable[[int], None],
    run_pim: Callable[[int], None],
    ms: Sequence[int] | None = None,
    repeats: int = 5,
) -> float:
    """Wall-clock calibration of the two real FC paths.

    `run_pu(m)` / `run_pim(m)` execute (and block on) one FC kernel with m
    activation rows.  Returns the crossover threshold.
    """
    if ms is None:
        ms = [1, 2, 4, 8, 16, 32, 64, 128]

    def bench(fn: Callable[[int], None], m: int) -> float:
        fn(m)  # warmup / compile
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn(m)
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    t_pu = [bench(run_pu, m) for m in ms]
    t_pim = [bench(run_pim, m) for m in ms]
    return _crossover_alpha(ms, t_pim, t_pu)
