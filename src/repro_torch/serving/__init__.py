"""The port's serving layer: the PAPI engine and its sampler."""
from repro_torch.serving.engine import (IterStats, PapiEngine, ServeRequest,
                                        ServeResult)
from repro_torch.serving.sampler import greedy

__all__ = ["IterStats", "PapiEngine", "ServeRequest", "ServeResult", "greedy"]
