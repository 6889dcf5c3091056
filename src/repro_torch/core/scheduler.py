"""PAPI's dynamic parallelism-aware scheduler (§4.1, §5.2).

RLP is tracked from the finish count of every decoding iteration plus the
requests admitted by continuous batching; TLP is a register the host
writes.  AI ~= RLP * TLP is compared with the calibrated threshold alpha:
AI > alpha means the FC kernel is compute-bound and runs on the PUs
(``"pu"``, a plain matmul); otherwise it runs on FC-PIM (``"pim"``, the
weight-streaming `fc_gemv` kernel).  Attention is always memory-bound and
pinned to Attn-PIM (the engine's ``attn_pim``).  The decision is
host-side and O(batch).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ai import effective_parallelism

FC_PU = "pu"
FC_PIM = "pim"
ATTN_PIM = "attn_pim"


@dataclasses.dataclass
class SchedulerEvent:
    iteration: int
    rlp: int
    tlp: int
    ai_estimate: float
    assignment: str
    rescheduled: bool
    alpha: float = 0.0


@dataclasses.dataclass
class PapiScheduler:
    """Online kernel-to-hardware scheduler."""
    cfg: ModelConfig
    alpha: float
    tlp: int = 1
    rlp: int = 0
    iteration: int = 0
    eos_token: int = 2

    def __post_init__(self) -> None:
        self._assignment = self._decide()
        self.events: list[SchedulerEvent] = []
        self.num_reschedules = 0

    def initial_schedule(self, batch_size: int, spec_len: int) -> str:
        self.rlp = batch_size
        self.tlp = spec_len
        self.iteration = 0
        self._assignment = self._decide()
        self._log(rescheduled=False)
        return self._assignment

    def set_tlp(self, tlp: int) -> None:
        """The host writes the TLP register.  A TLP change is a monitored
        parallelism change (§5.2.2), so the decision is re-made at once."""
        self.tlp = int(tlp)
        new = self._decide()
        if new != self._assignment:
            self.num_reschedules += 1
            self._assignment = new
            self._log(rescheduled=True)

    def observe_outputs(self, output_tokens: Sequence[int],
                        admitted: int = 0) -> str:
        """After an iteration: count the <eos> tokens among the batch's new
        tokens, fold in the admitted requests, and re-decide."""
        finished = sum(1 for t in output_tokens if t == self.eos_token)
        return self.observe_counts(finished, admitted)

    def observe_counts(self, finished, admitted: int = 0) -> str:
        """After each iteration: `finished` may be an int or an array of
        per-slot finish flags (summed here)."""
        finished = int(np.sum(finished))
        admitted = int(np.sum(admitted))
        self.iteration += 1
        self.rlp = max(self.rlp - finished + admitted, 0)
        new = self._decide()
        rescheduled = new != self._assignment
        if rescheduled:
            self.num_reschedules += 1
        self._assignment = new
        self._log(rescheduled)
        return new

    @property
    def ai_estimate(self) -> float:
        return effective_parallelism(self.cfg, self.rlp, self.tlp)

    def _decide(self) -> str:
        return FC_PU if self.ai_estimate > self.alpha else FC_PIM

    @property
    def fc_assignment(self) -> str:
        return self._assignment

    @property
    def attention_assignment(self) -> str:
        """Attention is always memory-bound (§4.1): pinned to Attn-PIM."""
        return ATTN_PIM

    def _log(self, rescheduled: bool) -> None:
        self.events.append(SchedulerEvent(
            iteration=self.iteration, rlp=self.rlp, tlp=self.tlp,
            ai_estimate=self.ai_estimate, assignment=self._assignment,
            rescheduled=rescheduled, alpha=self.alpha,
        ))
