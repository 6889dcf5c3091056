"""Deterministic fault injection for the port's serving engine — the
port's own copy of `repro.serving.faults` (numpy only).

`FaultInjector` is a seeded, per-iteration schedule of faults that
`PapiEngine.step()` consults at fixed points, so that every failure path
of the engine can be forced in a test and replayed.

Fault kinds (what each models, and which guard catches it):

  ``admit``     the pool reports "busy" even when pages are free.  The head
                of the queue defers, `IterStats.deferral_age` grows, and
                pool-pressure preemption or the watchdog bound the wait.
  ``nan``       NaN logits out of the decode step.  The finite-logits guard
                discards the step and re-runs it once, uninjected, with
                speculation clamped to one step (`IterStats.degraded`).
  ``kernel``    a kernel's overflowed accumulator: logits forced to +inf.
                Caught by the same guard (isfinite rejects inf and NaN).
  ``latency``   host latency added to a step, so that deadlines
                (`ServeRequest.deadline_s`) meet a slow engine.
  ``crash``     the engine dies at the top of the iteration: it raises
                `EngineCrashError` and cleans nothing up.

Every decision is a pure function of ``(seed, iteration)``
(`numpy.random.default_rng([seed, step])`): a step that consults twice
replays, and two injectors with the same seed give the same schedule —
the reference's draws exactly.

The logits faults apply to the guarded steps only (the plain step, the
speculative verify, the mixed wave); under ``fused=False`` the engine runs
the unguarded host loop and applies none.

CLI: ``launch.serve --fault kind[:prob]`` (repeatable) builds an injector
through `parse_fault_specs`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# fault codes of a guarded step's logits
FAULT_NONE = 0
FAULT_NAN = 1
FAULT_INF = 2

KINDS = ("admit", "nan", "kernel", "latency", "crash")


@dataclasses.dataclass
class FaultInjector:
    """Seeded per-iteration fault schedule.

    Each ``*_p`` is the per-iteration probability of that fault firing;
    ``window`` restricts injection to iterations ``start <= it < stop``
    (``stop=None``: unbounded).  ``counts`` records what fired, by kind.
    """

    seed: int = 0
    admit_p: float = 0.0
    nan_p: float = 0.0
    kernel_p: float = 0.0
    latency_p: float = 0.0
    latency_s: float = 0.002
    crash_p: float = 0.0
    start: int = 0
    stop: int | None = None

    def __post_init__(self) -> None:
        self.counts: dict[str, int] = {k: 0 for k in KINDS}

    def _draws(self, step: int) -> np.ndarray:
        """Five uniforms, one per kind, a pure function of (seed, step).
        The crash draw is the last: the first four keep their values."""
        return np.random.default_rng([self.seed, int(step)]).random(5)

    def _active(self, step: int) -> bool:
        return step >= self.start and (self.stop is None or step < self.stop)

    def admission_blocked(self, step: int) -> bool:
        """Force this iteration's admission to report the pool busy."""
        hit = self._active(step) and self._draws(step)[0] < self.admit_p
        if hit:
            self.counts["admit"] += 1
        return hit

    def logits_fault(self, step: int) -> int:
        """FAULT_NAN / FAULT_INF / FAULT_NONE for this iteration's guarded
        step; NaN wins when both fire."""
        if not self._active(step):
            return FAULT_NONE
        draws = self._draws(step)
        if draws[1] < self.nan_p:
            self.counts["nan"] += 1
            return FAULT_NAN
        if draws[2] < self.kernel_p:
            self.counts["kernel"] += 1
            return FAULT_INF
        return FAULT_NONE

    def step_delay(self, step: int) -> float:
        """Host latency (seconds) to sleep at the top of this iteration."""
        hit = self._active(step) and self._draws(step)[3] < self.latency_p
        if hit:
            self.counts["latency"] += 1
            return self.latency_s
        return 0.0

    def crash_now(self, step: int) -> bool:
        """Kill the engine at the top of this iteration."""
        hit = self._active(step) and self._draws(step)[4] < self.crash_p
        if hit:
            self.counts["crash"] += 1
        return hit


def parse_fault_specs(specs: list[str], *, seed: int = 0,
                      latency_s: float = 0.002) -> FaultInjector | None:
    """An injector from CLI specs like ``["nan:0.2", "admit"]``: each is
    ``kind[:prob]`` (prob 1.0 when left out).  None for an empty list, so
    the result goes straight to ``PapiEngine(faults=...)``."""
    if not specs:
        return None
    probs = {k: 0.0 for k in KINDS}
    for spec in specs:
        kind, _, prob = spec.partition(":")
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} (choose from {KINDS})")
        try:
            p = float(prob) if prob else 1.0
        except ValueError:
            raise ValueError(
                f"fault spec {spec!r}: probability {prob!r} is not a number"
            ) from None
        if not 0.0 <= p <= 1.0:
            raise ValueError(
                f"fault spec {spec!r}: probability {p} outside [0, 1]")
        probs[kind] = p
    return FaultInjector(seed=seed, admit_p=probs["admit"],
                         nan_p=probs["nan"], kernel_p=probs["kernel"],
                         latency_p=probs["latency"], latency_s=latency_s,
                         crash_p=probs["crash"])


__all__ = ["FAULT_INF", "FAULT_NAN", "FAULT_NONE", "FaultInjector", "KINDS",
           "parse_fault_specs"]
