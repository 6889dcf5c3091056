"""The serving mesh of the port: one process per rank over
`torch.distributed`, the counterpart of `repro.launch.mesh`.

    spawn_world(fn, world, device="cpu", timeout_s=90, args=(...))

starts `world` ranks (``torch.multiprocessing`` spawn; rendezvous through
a `FileStore` file, so no TCP port is taken and parallel worlds cannot
collide), runs ``fn(rank, device, *args)`` in each and returns their
results in rank order.  The backend is gloo on the CPU, NCCL when the
host has a card per rank, and gloo again when several ranks share one card
(NCCL refuses two ranks on one device): each rank then stages its
collectives through host copies (`ServingMesh.staged`), which the serving
engine counts as host transfers.  A rank that raises, or a world that is
not done within ``timeout_s``, kills every rank and raises here: a hang
costs seconds.  `fn` must be importable by module name in the child (a
module-level function of this package or of a test helper module).

`make_serving_mesh(dp, tp)` builds the (data, model) mesh over the world
the calling rank joined: ``model`` is the tensor axis (one FC-PIM bank and
one Attn-PIM unit per shard, PAPI §5.3), ``data`` splits the engine's slot
batch (each data group computes its own slots; the serving engine gathers
what it fetches over it).
Its collectives (`ServingMesh.all_gather`, `all_reduce`, `all_reduce_many`)
give every rank of a group the same bytes: `all_reduce` gathers the
partials and adds them in rank order, in f32, whatever the backend's own
reduction order; `all_reduce_many` sums a list of tensors so, in one
collective per dtype (the 2D weight-stationary decode's column groups).  A
world of k·dp·tp ranks holds k such meshes side by side (rank r in mesh
r // (dp·tp)), each with groups of its own.  `local_mesh(device)` is the
(1, 1) mesh of one process: no group, no collective.

Training over "data" (ZeRO-3, `launch.steps.build_step`) differentiates
through three collectives built on the same gather, so they too are
staged and counted.  The first two take a list of tensors and run one
collective for each dtype among them (a layer's weights in one gather):
  * `all_gather_grad`: each tensor's blocks concatenated along its dim;
    the backward sums the gradient over the axis in rank order and keeps
    this rank's block (a reduce-scatter);
  * `replicated_grad`: the identity; the backward sums the gradients over
    the axis (leaves kept whole on every rank);
  * `all_reduce_grad`: one tensor summed over the axis; the backward
    passes the gradient through, since every rank computes the same loss
    from the sum.

Training over "model" (sequence parallelism on the residual stream,
`models.model.SeqSplit`) adds the pair that moves the residual's
sequence dim (dim 1 of [b, s, d]) between its blocks and the whole, one
tensor a call:
  * `seq_gather`: every rank's block of the sequence concatenated in rank
    order (the input of a tensor-split sub-block); the backward sums the
    gradient over the axis and keeps this rank's block (a reduce-scatter);
  * `seq_scatter`: every rank's partial sum (a row bank's output) added
    in rank order in f32, and this rank's block of the sequence kept (a
    reduce-scatter); the backward all-gathers the blocks' gradients.

The reference's `make_production_mesh`, `make_host_mesh` and
`force_host_device_count` exist for XLA's host-device trick (one process,
N fake devices); a process per rank needs none of them.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.debug.sanitize import transfer_allowed


def parse_mesh(spec: str) -> tuple[int, int]:
    """Parse a ``--mesh dp,tp`` CLI value into (dp, tp)."""
    parts = spec.split(",")
    if len(parts) != 2:
        raise ValueError(f"--mesh wants 'dp,tp', got {spec!r}")
    dp, tp = (int(p) for p in parts)
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh axes must be >= 1, got {spec!r}")
    return dp, tp


def world_backend(world: int, device: torch.device | str) -> str:
    """gloo on the CPU and for ranks that share a card, NCCL with a card
    per rank."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(rank: int, world: int,
                device: torch.device | str) -> torch.device:
    """Rank `rank`'s device: the CPU, its own card, or card 0 shared."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if torch.cuda.device_count() >= world:
        return torch.device("cuda", rank)
    return torch.device("cuda", 0)


@dataclasses.dataclass
class ServingMesh:
    """The (data, model) mesh as one rank sees it: the axis sizes, this
    rank's coordinates, a process group per axis (None for an axis of size
    1) and a gloo group for host-side agreement."""
    shape: dict[str, int]
    coords: dict[str, int]
    groups: dict[str, Any]
    host_group: Any
    device: torch.device
    backend: str
    # collectives on CUDA tensors over gloo go through host copies
    staged: bool
    collectives: int = 0       # collectives run (all axes)
    staged_copies: int = 0     # device->host copies they made

    @property
    def rank(self) -> int:
        """This rank's index in the mesh (row-major over data, model)."""
        return self.coords["data"] * self.shape["model"] + \
            self.coords["model"]

    def all_gather(self, x: torch.Tensor, axis: str = "model",
                   dim: int = 0) -> torch.Tensor:
        """Concatenate every rank's `x` along `dim`, in rank order."""
        return torch.cat(self._gather(x, axis), dim=dim)

    def all_reduce(self, x: torch.Tensor, axis: str = "model"
                   ) -> torch.Tensor:
        """The sum of every rank's `x`, added in rank order in f32 and
        cast back to x's dtype: the same bytes on every rank."""
        parts = self._gather(x, axis)
        acc = parts[0].float()
        for p in parts[1:]:
            acc = acc + p.float()
        return acc.to(x.dtype)

    def all_reduce_many(self, xs: Sequence[torch.Tensor], axis: str
                        ) -> list[torch.Tensor]:
        """Each x of `xs` summed over `axis` as `all_reduce` sums it, in
        one collective per dtype among them."""
        if self.groups.get(axis) is None or not xs:
            return list(xs)
        return _summed(self, axis, xs)

    def all_gather_grad(self, xs: Sequence[torch.Tensor], axis: str,
                        dims: Sequence[int]) -> list[torch.Tensor]:
        """Each x of `xs` gathered along its dim of `dims` (`all_gather`),
        one collective per dtype; the backward reduce-scatters."""
        if self.groups.get(axis) is None or not xs:
            return list(xs)
        return list(_GatherBlocks.apply(self, axis, tuple(dims), *xs))

    def replicated_grad(self, xs: Sequence[torch.Tensor], axis: str
                        ) -> list[torch.Tensor]:
        """The identity, whose backward sums the gradients over `axis`
        (one collective per dtype)."""
        if self.groups.get(axis) is None or not xs:
            return list(xs)
        return list(_Replicated.apply(self, axis, *xs))

    def all_reduce_grad(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """`all_reduce` whose backward passes the gradient through."""
        if self.groups.get(axis) is None:
            return x
        return _SumOver.apply(x, self, axis)

    def seq_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Every rank's block of the sequence (dim 1) concatenated in
        rank order, one collective; the backward reduce-scatters (module
        docstring)."""
        if self.groups.get(axis) is None:
            return x
        return _SeqGather.apply(x, self, axis)

    def seq_scatter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """This rank's block of the sequence (dim 1) of the sum of every
        rank's `x`, added in rank order in f32, one collective; the
        backward all-gathers (module docstring)."""
        if self.groups.get(axis) is None:
            return x
        return _SeqScatter.apply(x, self, axis)

    def _gather(self, x: torch.Tensor, axis: str) -> list[torch.Tensor]:
        group = self.groups.get(axis)
        if group is None:
            return [x]
        self.collectives += 1
        x = x.contiguous()
        if not self.staged:
            parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
            dist.all_gather(parts, x, group=group)
            return parts
        self.staged_copies += 1
        with transfer_allowed():
            host = x.cpu()
            parts = [torch.empty_like(host) for _ in range(self.shape[axis])]
            dist.all_gather(parts, host, group=group)
            return [p.to(x.device) for p in parts]

    def host_gather(self, arr: np.ndarray) -> list[np.ndarray]:
        """Every rank's host array (same shape and dtype), in rank order,
        over the host group (no device work)."""
        if self.host_group is None:
            return [arr]
        t = torch.from_numpy(np.ascontiguousarray(arr))
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(self.host_group))]
        dist.all_gather(parts, t, group=self.host_group)
        return [p.numpy() for p in parts]

    def barrier(self) -> None:
        """Wait until every rank of the mesh gets here (host group)."""
        if self.host_group is not None:
            dist.barrier(group=self.host_group)

    def host_any(self, flags: np.ndarray) -> np.ndarray:
        """Element-wise OR of a bool array over every rank (host-side)."""
        return np.any(np.stack(self.host_gather(flags.astype(np.uint8))),
                      axis=0)


def _by_dtype(xs) -> list[list[int]]:
    """Indices of `xs` grouped by dtype, in first-seen order."""
    groups: dict = {}
    for i, x in enumerate(xs):
        groups.setdefault(x.dtype, []).append(i)
    return list(groups.values())


def _flat(xs, idx) -> torch.Tensor:
    return torch.cat([xs[i].reshape(-1) for i in idx])


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, dims, *xs):
        ctx.mesh, ctx.axis, ctx.dims = mesh, axis, dims
        ctx.shapes = [x.shape for x in xs]
        out = [None] * len(xs)
        for idx in _by_dtype(xs):
            parts = mesh._gather(_flat(xs, idx), axis)
            at = 0
            for i in idx:
                n = xs[i].numel()
                out[i] = torch.cat([p[at:at + n].view(xs[i].shape)
                                    for p in parts], dim=dims[i])
                at += n
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        me = ctx.mesh.coords[ctx.axis]
        out = []
        for g, shape, dim in zip(_summed(ctx.mesh, ctx.axis, gs),
                                 ctx.shapes, ctx.dims):
            out.append(g.narrow(dim, me * shape[dim], shape[dim])
                       .contiguous())
        return (None, None, None, *out)


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_summed(ctx.mesh, ctx.axis, gs))


def _summed(mesh, axis, gs) -> list[torch.Tensor]:
    """Each of `gs` summed over `axis` (`all_reduce`, one a dtype)."""
    out = [None] * len(gs)
    for idx in _by_dtype(gs):
        whole = mesh.all_reduce(_flat(gs, idx), axis)
        at = 0
        for i in idx:
            n = gs[i].numel()
            out[i] = whole[at:at + n].view(gs[i].shape)
            at += n
    return out


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _scattered(mesh, axis, x) -> torch.Tensor:
    """This rank's block of the sequence (dim 1) of x summed over `axis`:
    every rank's block added in rank order in f32, cast back to x's
    dtype."""
    n = x.shape[1] // mesh.shape[axis]
    lo = mesh.coords[axis] * n
    parts = mesh._gather(x, axis)
    acc = parts[0].narrow(1, lo, n).float()
    for p in parts[1:]:
        acc = acc + p.narrow(1, lo, n).float()
    return acc.to(x.dtype)


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_gather(x, axis, 1)

    @staticmethod
    def backward(ctx, g):
        return _scattered(ctx.mesh, ctx.axis, g), None, None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _scattered(mesh, axis, x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axis, 1), None, None


def make_serving_mesh(dp: int = 1, tp: int = 1, *,
                      device: torch.device | str | None = None
                      ) -> ServingMesh:
    """The (data, model) mesh over the process group the caller joined:
    rank r sits in mesh r // (dp * tp), at data (r % (dp * tp)) // tp,
    model r % tp (one mesh when the world has dp * tp ranks).  Every rank
    must call it with the same (dp, tp): it creates every mesh's groups."""
    if not dist.is_initialized():
        raise RuntimeError("make_serving_mesh needs an initialised "
                           "torch.distributed world (spawn_world)")
    world, rank = dist.get_world_size(), dist.get_rank()
    size = dp * tp
    if world % size:
        raise ValueError(f"mesh ({dp}, {tp}) needs a multiple of {size} "
                         f"ranks, the world has {world}")
    backend = dist.get_backend()
    dev = torch.device(device) if device is not None else (
        rank_device(rank, world, "cuda") if backend == "nccl"
        else torch.device("cpu"))
    groups: dict[str, Any] = {"data": None, "model": None}
    host_group = None
    base, local = rank - rank % size, rank % size
    for b in range(0, world, size):          # every rank creates every group
        for d in range(dp):
            g = dist.new_group([b + d * tp + j for j in range(tp)])
            if tp > 1 and b == base and local // tp == d:
                groups["model"] = g
        for j in range(tp):
            g = dist.new_group([b + d * tp + j for d in range(dp)])
            if dp > 1 and b == base and local % tp == j:
                groups["data"] = g
        if world > size or backend != "gloo":
            g = dist.new_group(list(range(b, b + size)), backend="gloo")
            if b == base:
                host_group = g
    if host_group is None:
        host_group = dist.group.WORLD
    return ServingMesh(shape={"data": dp, "model": tp},
                       coords={"data": local // tp, "model": local % tp},
                       groups=groups, host_group=host_group, device=dev,
                       backend=backend,
                       staged=(backend == "gloo" and dev.type == "cuda"))


def local_mesh(device: torch.device | str) -> ServingMesh:
    """The (1, 1) mesh of one process: no group, so no collective."""
    return ServingMesh(shape={"data": 1, "model": 1},
                       coords={"data": 0, "model": 0},
                       groups={"data": None, "model": None}, host_group=None,
                       device=torch.device(device), backend="none",
                       staged=False)


def _rank_entry(rank: int, world: int, backend: str, store: str,
                device: str, threads: int, timeout_s: float,
                fn: Callable, args: Sequence, results) -> None:
    try:
        torch.set_num_threads(threads)
        dev = rank_device(rank, world, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, dev, *args)
        finally:
            dist.destroy_process_group()
        # pickled here, by value: a tensor sent through the queue as is
        # would be shared by a handle that dies with this process
        results.put((rank, True, pickle.dumps(out)))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_world(fn: Callable, world: int, *,
                device: torch.device | str = "cuda",
                timeout_s: float = 90.0, args: Sequence = (),
                store_dir: str | os.PathLike | None = None,
                threads: int = 1) -> list:
    """Run ``fn(rank, device, *args)`` on `world` spawned ranks and return
    their results in rank order (module docstring).  `device` is "cpu" or
    "cuda"; the rendezvous file goes under `store_dir` (default: a fresh
    temporary directory)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spawn_world on cuda needs a CUDA device")
    backend = world_backend(world, dev)
    if store_dir is not None:
        os.makedirs(store_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="papi_world_", dir=store_dir)
    store = os.path.join(tmp, "store")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world, backend, store, str(dev), threads,
                               timeout_s, fn, tuple(args), results))
             for r in range(world)]
    deadline = time.monotonic() + timeout_s
    got: dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"world of {world} ranks not done within {timeout_s}s "
                    f"(ranks {sorted(got)} finished)")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and not results.qsize():
                    raise RuntimeError(
                        f"rank process exited with {dead[0].exitcode} "
                        "before reporting")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            got[rank] = pickle.loads(out)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(world)]


__all__ = ["ServingMesh", "local_mesh", "make_serving_mesh", "parse_mesh",
           "rank_device", "spawn_world", "world_backend"]
