"""PAPI's host-side core: the AI estimate, the runtime scheduler and the
request traces."""
from repro_torch.core.ai import effective_parallelism
from repro_torch.core.scheduler import (FC_PIM, FC_PU, PapiScheduler,
                                        SchedulerEvent)
from repro_torch.core.traces import Request, generate_trace

__all__ = ["FC_PIM", "FC_PU", "PapiScheduler", "Request", "SchedulerEvent",
           "effective_parallelism", "generate_trace"]
