"""The port's serving layer: the PAPI engine with its failure model, the
fault injector, the sampler and the serve loop's latency metrics."""
from repro_torch.serving.engine import (AllocatorInvariantError,
                                        EngineCrashError, EngineStallError,
                                        IterStats, PapiEngine, ServeRequest,
                                        ServeResult, TokenEvent)
from repro_torch.serving.faults import FaultInjector, parse_fault_specs
from repro_torch.serving.metrics import latency_summary, percentile
from repro_torch.serving.sampler import accept_speculative, greedy, sample

__all__ = ["AllocatorInvariantError", "EngineCrashError", "EngineStallError",
           "FaultInjector", "IterStats", "PapiEngine", "ServeRequest",
           "ServeResult", "TokenEvent", "accept_speculative", "greedy",
           "latency_summary", "parse_fault_specs", "percentile", "sample"]
