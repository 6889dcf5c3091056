"""Dolly-like request traces (§7.1 workloads) — the port's own copy of
`repro.core.traces`, numpy only.

The paper replays creative-writing and general-qa requests from the Dolly
dataset.  The two categories are modelled by their published character:
creative writing has long, high-variance outputs (decode-dominated, strong
RLP decay); general-qa has shorter outputs.  Lengths are lognormal,
deterministic per seed, clipped to sane ranges.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    req_id: int
    input_len: int
    output_len: int


# (median input, sigma_in, median output, sigma_out, max_out)
_PROFILES = {
    "creative-writing": (64, 0.6, 320, 0.7, 2048),
    "general-qa": (96, 0.6, 80, 0.6, 512),
}


def generate_trace(task: str, n_requests: int, seed: int = 0) -> list[Request]:
    med_in, sig_in, med_out, sig_out, max_out = _PROFILES[task]
    rng = np.random.default_rng(seed)
    in_lens = np.clip(
        rng.lognormal(np.log(med_in), sig_in, n_requests).astype(int), 4, 2048
    )
    out_lens = np.clip(
        rng.lognormal(np.log(med_out), sig_out, n_requests).astype(int), 4, max_out
    )
    return [Request(i, int(a), int(b)) for i, (a, b) in
            enumerate(zip(in_lens, out_lens))]
