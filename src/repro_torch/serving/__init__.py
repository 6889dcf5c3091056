"""The port's serving layer: the PAPI engine and its sampler."""
from repro_torch.serving.engine import (IterStats, PapiEngine, ServeRequest,
                                        ServeResult)
from repro_torch.serving.sampler import accept_speculative, greedy, sample

__all__ = ["IterStats", "PapiEngine", "ServeRequest", "ServeResult",
           "accept_speculative", "greedy", "sample"]
