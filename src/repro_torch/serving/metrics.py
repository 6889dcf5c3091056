"""Latency accounting of the continuous-batching serve loop — the port's
copy of `repro.serving.metrics`.

`PapiEngine.serve` stamps every request with three serving latencies:

  queue delay   submit -> first admission
  TTFT          submit -> first output token (queue delay + prefill)
  TPOT          mean gap between later tokens,
                (finish - first token) / (n_tokens - 1)

each in wall-clock seconds and in engine iterations (deterministic for a
fixed arrival schedule).  `latency_summary` aggregates a batch of results
into p50 / p99 / mean per metric.
"""
from __future__ import annotations

from typing import Iterable, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 for an empty input.
    Nearest rank, not interpolated, so iteration-valued metrics stay
    integers."""
    if not values:
        return 0.0
    vals = sorted(values)
    if q <= 0:
        return vals[0]
    rank = max(1, -(-len(vals) * q // 100))  # ceil(len * q / 100)
    return vals[min(int(rank), len(vals)) - 1]


# ServeResult fields aggregated by latency_summary (each -> {p50, p99, mean})
METRIC_FIELDS = ("queue_delay_s", "ttft_s", "tpot_s",
                 "queue_delay_iters", "ttft_iters")


def latency_summary(results: Iterable) -> dict:
    """p50 / p99 / mean and the count of contributors per metric over
    objects with the `METRIC_FIELDS` attributes (normally `ServeResult`s).
    A None (a phase that never happened: no token, or no gap below two
    tokens) is left out of its metric; ``n`` is the number of results."""
    results = list(results)
    out: dict = {"n": len(results)}
    for field in METRIC_FIELDS:
        vals = [getattr(r, field) for r in results]
        vals = [v for v in vals if v is not None]
        out[field] = {
            "p50": percentile(vals, 50),
            "p99": percentile(vals, 99),
            "mean": (sum(vals) / len(vals)) if vals else 0.0,
            "count": len(vals),
        }
    return out
