"""The port's serving layer: the PAPI engine, its sampler and the serve
loop's latency metrics."""
from repro_torch.serving.engine import (IterStats, PapiEngine, ServeRequest,
                                        ServeResult, TokenEvent)
from repro_torch.serving.metrics import latency_summary, percentile
from repro_torch.serving.sampler import accept_speculative, greedy, sample

__all__ = ["IterStats", "PapiEngine", "ServeRequest", "ServeResult",
           "TokenEvent", "accept_speculative", "greedy", "latency_summary",
           "percentile", "sample"]
