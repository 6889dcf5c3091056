"""Straggler watchdog, a copy of `repro.training.watchdog`: per-step
wall-time tracking + outlier flagging.

At pod scale a single slow host (thermals, faulty ICI link, background
daemon) stretches every synchronous step.  The watchdog keeps a rolling
window of step times, flags steps above `threshold` x the rolling median as
straggler events, and exposes them for the launcher to act on (alert /
eject-and-rejoin in a real deployment; recorded + surfaced here)."""
from __future__ import annotations

import dataclasses
import time
from collections import deque


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    median_s: float


class StepWatchdog:
    def __init__(self, window: int = 50, threshold: float = 2.5) -> None:
        self.window: deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.events: list[StragglerEvent] = []
        self._t0: float | None = None
        self._step = 0

    def start_step(self, step: int) -> None:
        self._step = step
        self._t0 = time.perf_counter()

    def end_step(self) -> float:
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        if len(self.window) >= 10:
            med = sorted(self.window)[len(self.window) // 2]
            if dt > self.threshold * med:
                self.events.append(StragglerEvent(self._step, dt, med))
        self.window.append(dt)
        self._t0 = None
        return dt

    def observe(self, step: int, duration_s: float) -> None:
        """Record an externally-timed step (e.g. replayed from logs)."""
        self._step = step
        if len(self.window) >= 10:
            med = sorted(self.window)[len(self.window) // 2]
            if duration_s > self.threshold * med:
                self.events.append(StragglerEvent(step, duration_s, med))
        self.window.append(duration_s)
