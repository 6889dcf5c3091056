"""Runtime sanitizer of the engine's host-sync discipline: the port's
counterpart of `repro.debug.sanitize`, with the same names and report.

- ``sanitized(device=)`` puts a step under
  ``torch.cuda.set_sync_debug_mode("error")`` when the engine runs on the
  card: any operation that synchronises the host with the stream (a
  ``.item()``, a ``.cpu()``, a blocking copy) raises, and `sanitized`
  turns that error into a `SanitizeError`.  The engine's one counted
  device->host copy (`PapiEngine._fetch`) runs inside
  ``transfer_allowed()``.  The mode is process-global: the previous mode
  comes back in a ``finally``, whatever the step raised.  On the CPU there
  is no stream to synchronise and the guard is off (the reference's CPU
  guard never fires either); the transfer *count* below is the check that
  works everywhere.
- PyTorch's check also fires on a blocking host->device copy from
  pageable memory, which every ``torch.from_numpy(a).to("cuda")`` is.  The
  reference guards device->host only, and the engine's uploads (its
  `_to_device` and the block tables) are host->device, so the engine runs
  them inside ``transfer_allowed()`` too.  Staging them through pinned
  memory with ``non_blocking=True`` would change the hot path of every
  engine, traced or not; uploads are not counted as transfers either way.
- ``EngineSanitizer.after_step`` holds the transfer budget: a steady fused
  decode iteration (no admission, no arrivals, no prefill slots, no
  degraded step, no preemption) makes EXACTLY the engine's
  ``transfer_budget`` host transfers: its one fetch, and one per MoE
  layer of each forward (`models.moe` reads its per-expert counts; the
  reference has no such copy).  The reference's compile census reads its
  jit caches; the port has none, so its census has two parts:
  ``programs`` counts the distinct program keys the engine's `_call`
  dispatched, and a kernel built or loaded by `kernels._build` after the
  engine's first steady iteration raises `SanitizeError` (a kernel was
  built in steady state).

``rank_promotion`` and ``debug_nans`` keep the reference's keyword names
and do nothing: PyTorch has no switch that raises on implicit rank
promotion, and the engine's finite-logits guard already checks every
step's logits on the device.

Wiring: ``PapiEngine(sanitize=True)``, `PapiEngine.sanitize_report`, and
the launcher's ``--sanitize``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from repro_torch.kernels import _build

# the guard is live (set by `sanitized` on the card): transfer_allowed
# lifts it for one sanctioned copy
_GUARD = {"on": False}


class SanitizeError(RuntimeError):
    """A host-sync discipline invariant was violated at run time."""


@dataclasses.dataclass
class SanitizeReport:
    """Counters accumulated by EngineSanitizer.after_step."""

    transfer_budget: int = 1
    iterations: int = 0          # steps that recorded an IterStats
    steady_iterations: int = 0   # fused decode-only steps (budget applies)
    steady_transfers: int = 0    # host transfers over those steps
    recompiles: int = 0          # stays 0: a steady-state build raises
    programs: int = 0            # distinct program keys dispatched

    @property
    def transfers_per_steady_iter(self) -> float:
        if self.steady_iterations == 0:
            return 0.0
        return self.steady_transfers / self.steady_iterations

    def asdict(self) -> dict[str, Any]:
        out = dataclasses.asdict(self)
        out["transfers_per_steady_iter"] = self.transfers_per_steady_iter
        return out


@contextlib.contextmanager
def sanitized(*, device: torch.device | str | None = None,
              rank_promotion: str = "raise", debug_nans: bool = False):
    """Strict mode for one engine step.  On a CUDA `device`, every host
    sync outside ``transfer_allowed()`` raises `SanitizeError`; elsewhere
    it is a no-op.  ``rank_promotion`` / ``debug_nans``: no counterpart
    (module docstring)."""
    if device is None or torch.device(device).type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    _GUARD["on"] = True
    try:
        yield
    except RuntimeError as err:
        if isinstance(err, SanitizeError) or "synchroniz" not in str(err):
            raise
        raise SanitizeError(f"host sync outside the engine's sanctioned "
                            f"transfer: {err}") from err
    finally:
        _GUARD["on"] = False
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def transfer_allowed():
    """Explicit allow-scope for a sanctioned copy (a no-op while no guard
    is live)."""
    if not _GUARD["on"]:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("default")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class EngineSanitizer:
    """Per-engine runtime gate: transfer budget + program and build census.

    The engine calls ``scope(engine)`` around each step, runs its one
    sanctioned fetch and its uploads in ``allow_transfers()``, notes each
    program key it dispatches (`note_program`), and calls
    ``after_step(engine, stepped=...)`` when the step returns.
    """

    def __init__(self, *, transfer_budget: int = 1,
                 debug_nans: bool | None = None):
        self.report = SanitizeReport(transfer_budget=transfer_budget)
        self._debug_nans = debug_nans
        self._programs: set = set()
        self._loaded: frozenset | None = None   # kernels at the first steady step

    def scope(self, engine):
        return sanitized(device=getattr(engine, "device", None),
                         debug_nans=bool(self._debug_nans))

    def allow_transfers(self):
        return transfer_allowed()

    def note_program(self, key: tuple) -> None:
        self._programs.add(key)

    def after_step(self, engine, *, stepped: bool) -> None:
        # build census: once the engine reached its steady state, every
        # kernel it runs must already be built and loaded
        loaded = _build.loaded()
        if self._loaded is not None and loaded != self._loaded:
            raise SanitizeError(
                f"kernel(s) {sorted(loaded - self._loaded)} built or loaded "
                "after the engine's first steady iteration: a steady-state "
                "step paid for a build")
        self.report.programs = len(self._programs)

        if not stepped:
            return
        st = engine.stats[-1]
        self.report.iterations += 1
        steady = (getattr(engine, "fused", False)
                  and st.admitted == 0 and st.arrivals == 0
                  and st.decode_slots > 0 and st.prefill_slots == 0
                  and st.degraded == 0 and st.preemptions == 0)
        if not steady:
            return
        if self._loaded is None:
            self._loaded = loaded
        self.report.transfer_budget = engine.transfer_budget
        self.report.steady_iterations += 1
        self.report.steady_transfers += st.transfers
        if st.transfers != self.report.transfer_budget:
            raise SanitizeError(
                f"transfer budget violated at iteration {st.iteration}: "
                f"{st.transfers} host transfer(s) in a steady-state fused "
                f"decode step (budget {self.report.transfer_budget}) — an "
                "un-batched sync crept onto the hot path")
