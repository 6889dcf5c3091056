"""The port's serving layer: the PAPI engine with its failure model, the
write-ahead journal, the tracer and its exporters, the fault injector, the
sampler and the serve loop's latency metrics."""
from repro_torch.serving.engine import (AllocatorInvariantError,
                                        EngineCrashError, EngineStallError,
                                        IterStats, PapiEngine, ServeRequest,
                                        ServeResult, TokenEvent)
from repro_torch.serving.faults import FaultInjector, parse_fault_specs
from repro_torch.serving.journal import (FinishedRequest, Journal,
                                         RecoveredRequest, RecoveredState,
                                         read_records, recover, replay,
                                         write_snapshot)
from repro_torch.serving.metrics import latency_summary, percentile
from repro_torch.serving.sampler import accept_speculative, greedy, sample
from repro_torch.serving.telemetry import (NULL_TRACER, Event, NullTracer,
                                           ProgramTiming, Tracer,
                                           export_chrome, export_jsonl,
                                           export_prometheus, write_trace)

__all__ = ["AllocatorInvariantError", "EngineCrashError", "EngineStallError",
           "Event", "FaultInjector", "FinishedRequest", "IterStats",
           "Journal", "NULL_TRACER", "NullTracer", "PapiEngine",
           "ProgramTiming", "RecoveredRequest", "RecoveredState",
           "ServeRequest", "ServeResult", "TokenEvent", "Tracer",
           "accept_speculative", "export_chrome", "export_jsonl",
           "export_prometheus", "greedy", "latency_summary",
           "parse_fault_specs", "percentile", "read_records", "recover",
           "replay", "sample", "write_snapshot", "write_trace"]
