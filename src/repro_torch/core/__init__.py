"""PAPI's host-side core: the arithmetic-intensity estimate, the runtime
scheduler, the paper's PIM device models and system simulators, the α
calibration and the request traces — the port's copy of `repro.core`."""
from repro_torch.core.ai import (attention_ai, effective_parallelism,
                                 fc_ai_estimate, fc_ai_exact)
from repro_torch.core.calibration import (calibrate_alpha_measured,
                                          calibrate_alpha_model)
from repro_torch.core.scheduler import (ATTN_PIM, FC_PIM, FC_PU,
                                        PapiScheduler, SchedulerEvent)
from repro_torch.core.system import (SYSTEMS, SimResult,
                                     calibrate_alpha_system, compare_systems,
                                     simulate_decode, simulate_prefill_gpu)
from repro_torch.core.traces import Request, generate_trace

__all__ = [
    "ATTN_PIM", "FC_PIM", "FC_PU", "SYSTEMS",
    "PapiScheduler", "Request", "SchedulerEvent", "SimResult",
    "attention_ai", "calibrate_alpha_measured", "calibrate_alpha_model",
    "calibrate_alpha_system", "compare_systems", "effective_parallelism",
    "fc_ai_estimate", "fc_ai_exact", "generate_trace", "simulate_decode",
    "simulate_prefill_gpu",
]
