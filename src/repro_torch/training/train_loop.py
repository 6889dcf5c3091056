"""The training loop — the port of `repro.training.train_loop`: a step
with microbatch gradient accumulation, AdamW, optional int8 gradient
compression with error feedback, async checkpointing, resume, preemption
handling and a straggler watchdog, on one device.

`make_train_step(cfg, opt)` builds
    (params, opt_state, err, batch) -> (params, opt_state, err, metrics)
where `batch` tensors carry a leading [accum] microbatch axis when
``accum > 1``: the gradients of the microbatches are summed in f32 and
divided by `accum`, one optimizer application per global step, as the
reference's scan does.  Parameters and moments are updated in place.  The
step runs `models.forward_train`, which reaches no kernel wrapper.  Under
`axis_rules(train_rules(), mesh)` on a (dp, tp) mesh the same step runs
on a rank's blocks of the parameters and moments and its data group's
rows of each microbatch (global microbatch i is every data group's
microbatch i, in data order): `forward_train` gathers and
reduce-scatters (`models.DataSplit`; with tp > 1 over "model" too) and
the gradient norm sums each block over the axes it is split over.

`run_training` labels its preemption checkpoint with the number of steps
done (the reference labels it with the step the run started from: ROADMAP
queue 3).  A SIGTERM that lands inside a step is taken at the step's end,
so the checkpoint never holds a half-updated model, and the run then stops.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, make_batch, to_device
from repro_torch.models.model import data_split, forward_train, init_params
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.compression import compress_with_feedback, init_error
from repro_torch.training.optim import AdamWConfig, adamw_update, init_adamw
from repro_torch.training.tree import leaves, unflatten
from repro_torch.training.watchdog import StepWatchdog

Tree = Any
DEFAULT_CHECKPOINT_DIR = os.path.join(tempfile.gettempdir(),
                                      "repro_torch_ckpt")


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    accum: int = 1
    remat: bool = True
    compress_grads: bool = False
    checkpoint_every: int = 50
    checkpoint_dir: str = DEFAULT_CHECKPOINT_DIR
    log_every: int = 10
    seed: int = 0


def _grads(mcfg, params, batch, remat):
    """(loss, the gradient of every parameter leaf, in leaf order); the
    leaves are made to require grad."""
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss, _ = forward_train(mcfg, params, batch, remat=remat)
    return loss.detach(), list(torch.autograd.grad(loss, ps))


def make_train_step(mcfg: ModelConfig, ocfg: AdamWConfig, *, accum: int = 1,
                    remat: bool = True,
                    compress_grads: bool = False) -> Callable:
    def train_step(params, opt_state, err, batch):
        split = data_split(mcfg)
        axes = None
        if split is not None:
            if compress_grads:
                raise ValueError("int8 gradient compression over the data "
                                 "axis is not ported")
            axes = (split.mesh, [split.leaf_axes(sp)
                                 for sp in leaves(split.specs)])
        if accum > 1:
            gsum, lsum = None, 0.0
            for i in range(accum):
                loss, g = _grads(mcfg, params,
                                 {k: v[i] for k, v in batch.items()}, remat)
                if gsum is None:
                    gsum = [x.float() for x in g]
                else:
                    for a, b in zip(gsum, g):
                        a.add_(b)
                lsum = lsum + loss
            grads = [g.div_(accum) for g in gsum]
            loss = lsum / accum
        else:
            loss, grads = _grads(mcfg, params, batch, remat)
        grads = unflatten(params, grads)
        if compress_grads:
            # int8 + error feedback, where it would bracket the DP all-reduce
            grads, err = compress_with_feedback(grads, err)
        params, opt_state, om = adamw_update(ocfg, params, grads, opt_state,
                                             axes)
        return params, opt_state, err, {"loss": loss, **om}

    return train_step


@dataclasses.dataclass
class TrainResult:
    losses: list[float]
    final_step: int
    straggler_events: int
    resumed_from: int | None
    step_s: list[float] = dataclasses.field(default_factory=list)


def run_training(mcfg: ModelConfig, tcfg: TrainConfig, dcfg: DataConfig,
                 ocfg: AdamWConfig | None = None, resume: bool = False,
                 device: torch.device | str | None = None) -> TrainResult:
    """The single-device loop, on ``cuda`` unless `device` says otherwise.
    Weights come from ``init_params(cfg, Generator(device).manual_seed(
    seed))``; with `resume`, from the latest checkpoint if there is one.
    `final_step` is the number of steps done (fewer than ``tcfg.steps``
    after a preemption); `step_s` holds each step's wall seconds (the
    loss read back to the host ends each step)."""
    device = resolve_device(device)
    ocfg = ocfg or AdamWConfig(total_steps=tcfg.steps)
    ckpt = CheckpointManager(tcfg.checkpoint_dir)

    params = init_params(mcfg, torch.Generator(device).manual_seed(tcfg.seed))
    opt_state = init_adamw(params)
    err = init_error(params) if tcfg.compress_grads else {}
    start_step = 0
    resumed_from = None
    latest = ckpt.latest_step() if resume else None
    if latest is not None:
        restored = ckpt.restore(latest, {"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        start_step = resumed_from = latest

    step_fn = make_train_step(mcfg, ocfg, accum=tcfg.accum, remat=tcfg.remat,
                              compress_grads=tcfg.compress_grads)

    def save(step: int, blocking: bool = False) -> None:
        ckpt.save(step, {"params": params, "opt": opt_state},
                  blocking=blocking)

    done = start_step
    in_step = False
    deferred = []

    def on_preempt() -> None:
        # mid-step the model is half updated: save at the step's end
        if in_step:
            deferred.append(True)
        else:
            save(done, blocking=True)

    prev = ckpt.install_preemption_handler(on_preempt)
    watchdog = StepWatchdog()
    losses: list[float] = []
    step_s: list[float] = []
    try:
        for step in range(start_step, tcfg.steps):
            if ckpt.preempted:
                break
            in_step = True
            watchdog.start_step(step)
            raw = make_batch(mcfg, dcfg, step)
            if tcfg.accum > 1:
                raw = {k: v.reshape((tcfg.accum, v.shape[0] // tcfg.accum)
                                    + v.shape[1:]) for k, v in raw.items()}
            params, opt_state, err, metrics = step_fn(
                params, opt_state, err, to_device(raw, device))
            loss = float(metrics["loss"])
            losses.append(loss)
            step_s.append(watchdog.end_step())
            done = step + 1
            in_step = False
            if ckpt.preempted:
                if deferred:
                    save(done, blocking=True)
                break
            if done % tcfg.checkpoint_every == 0 or done == tcfg.steps:
                save(done)
            if done % tcfg.log_every == 0:
                print(f"step {done:5d}  loss {loss:.4f}  "
                      f"lr {float(metrics['lr']):.2e}  "
                      f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
    finally:
        ckpt.wait()
        signal.signal(signal.SIGTERM, prev)
    return TrainResult(losses, done, len(watchdog.events), resumed_from,
                       step_s)
