"""PAPI's host-side core: the AI estimate and the runtime scheduler."""
from repro_torch.core.ai import effective_parallelism
from repro_torch.core.scheduler import (FC_PIM, FC_PU, PapiScheduler,
                                        SchedulerEvent)

__all__ = ["FC_PIM", "FC_PU", "PapiScheduler", "SchedulerEvent",
           "effective_parallelism"]
