"""Checkpointing: async save, restore, preemption handling — the port of
`repro.training.checkpoint`, in its on-disk format.

A checkpoint is a directory ``step_XXXXXXXX`` holding one ``.npz`` per
tree under the reference's keys (`tree.flatten`: ``embed/w``, ``.step``,
``.m/layers/attn/w_q``, ...) and a ``manifest.json``; it is written to
``step_XXXXXXXX.tmp`` and published with `os.replace`.  A save snapshots
the tensors to host memory at once and writes on a background thread (the
step loop never waits on the disk); one save is in flight at a time.
bf16 leaves are written as f32 (exact), and a reference checkpoint's bf16
arrays (numpy reads them back as raw 2-byte records) are widened to f32
bit for bit, so a checkpoint written by either package restores in the
other.  A SIGTERM (preemption) runs a final blocking save.

Over a mesh (``shardings={name: tree of spec tuples}``, ``mesh=``) a save
gathers every rank's blocks whole (`distributed.sharding.full_tensor`),
rank 0 of the mesh alone writes and publishes, and every rank waits at
a barrier until it has: no rank goes on while the step is half written.
`restore` with ``shardings`` and ``mesh`` cuts each leaf to this rank's
block under them, whatever mesh wrote it (elastic restore): a (2, 1)
checkpoint restores onto one device or onto (4, 1).  The files are the
same either way.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.distributed.sharding import full_tensor, local_block
from repro_torch.training.tree import flatten, unflatten

Tree = Any


def _to_host(leaf: torch.Tensor) -> np.ndarray:
    """The leaf's own host copy (a save must not see later in-place
    updates); bf16 as f32."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def _from_host(arr: np.ndarray, like: torch.Tensor,
               device: torch.device | str | None, spec=None,
               mesh=None) -> torch.Tensor:
    """The array as a tensor of `like`'s dtype on `device` (default:
    `like`'s), cut to this rank's block of `spec` first when given."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        # a bf16 array saved by numpy without its dtype: widen the bits
        arr = (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    if not arr.flags.c_contiguous:
        arr = arr.copy()                 # (ascontiguousarray makes 0-d 1-d)
    t = torch.from_numpy(arr)
    if spec is not None:
        t = local_block(t, spec, mesh)
    return t.to(device=like.device if device is None else device,
                dtype=like.dtype)


def _specs(shardings: dict | None, name: str) -> dict:
    """{checkpoint key: spec} of tree `name` (empty: every leaf whole)."""
    if not shardings or shardings.get(name) is None:
        return {}
    return dict(flatten(shardings[name]))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._preempted = False

    # ---------------------------------------------------------------- save
    def save(self, step: int, trees: dict[str, Tree],
             blocking: bool = False, *, shardings: dict | None = None,
             mesh=None) -> None:
        """Snapshot to host memory NOW, write to disk asynchronously.  On
        a mesh (module docstring) every rank must call it; it gathers,
        rank 0 writes, and all return once the step is published."""
        if mesh is not None:
            host = {}
            for name, t in trees.items():
                specs = _specs(shardings, name)
                host[name] = {k: _to_host(full_tensor(v.detach(), specs[k],
                                                      mesh)
                                          if specs.get(k) else v)
                              for k, v in flatten(t)}
            if mesh.rank == 0:
                self.wait()
                self._write(step, host)
            mesh.barrier()
            return
        host = {name: {k: _to_host(v) for k, v in flatten(t)}
                for name, t in trees.items()}
        self.wait()                      # one in-flight save at a time

        if blocking:
            self._write(step, host)
        else:
            self._thread = threading.Thread(target=self._write,
                                            args=(step, host), daemon=True)
            self._thread.start()

    def _write(self, step: int, host: dict) -> None:
        path = os.path.join(self.directory, f"step_{step:08d}")
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        for name, flat in host.items():
            np.savez(os.path.join(tmp, f"{name}.npz"), **flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "trees": sorted(host),
                       "time": time.time()}, f)
        # idempotent publish: re-saving a step replaces the snapshot
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)        # atomic publish
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"))

    # -------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, templates: dict[str, Tree],
                device: torch.device | str | None = None, *,
                shardings: dict | None = None,
                mesh=None) -> dict[str, Tree]:
        """Restore into the structure and dtypes of `templates`, on
        `device` (default: each template leaf's own).  With `shardings`
        (``{name: tree of spec tuples}``) and `mesh`, each leaf is this
        rank's block of its spec (elastic restore); a template leaf then
        has the block's shape or the whole leaf's."""
        path = os.path.join(self.directory, f"step_{step:08d}")
        out: dict[str, Tree] = {}
        for name, template in templates.items():
            specs = _specs(shardings, name)
            with np.load(os.path.join(path, f"{name}.npz")) as data:
                values = []
                for key, leaf in flatten(template):
                    arr = data[key]
                    t = _from_host(arr, leaf, device, specs.get(key) or None,
                                   mesh)
                    if tuple(leaf.shape) not in (tuple(t.shape), arr.shape):
                        raise ValueError(f"{name}:{key}: checkpoint shape "
                                         f"{arr.shape} (this rank's block "
                                         f"{tuple(t.shape)}), template "
                                         f"{tuple(leaf.shape)}")
                    values.append(t)
            out[name] = unflatten(template, values)
        return out

    # ----------------------------------------------------------- preemption
    def install_preemption_handler(self, save_fn: Callable[[], None]):
        """On SIGTERM: write a final blocking checkpoint, then hand the
        signal to the previous handler if it was a function.  Returns the
        previous handler, for the caller to put back."""
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            self._preempted = True
            save_fn()
            if callable(prev):
                prev(signum, frame)

        signal.signal(signal.SIGTERM, handler)
        return prev

    @property
    def preempted(self) -> bool:
        return self._preempted
