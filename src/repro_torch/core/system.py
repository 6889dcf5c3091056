"""End-to-end decode simulators for the paper's four systems (§7) — the
port's copy of `repro.core.system`.

Systems (device inventory identical across systems: 90 HBM stacks — 30
holding FC weights, 60 holding KV caches — plus, where applicable, the
compute of 6 A100 GPUs):

  a100_attacc   — FC always on GPUs; attention on AttAcc (1P1B)   [baseline]
  a100_hbmpim   — FC always on GPUs; attention on HBM-PIM (1P2B)
  attacc_only   — FC *and* attention on AttAcc PIM (no GPU compute)
  papi          — FC dynamically on GPUs or FC-PIM (4P1B) via the online
                  scheduler; attention on Attn-PIM (1P2B)
  pim_only_papi — FC always on FC-PIM; attention on Attn-PIM (§7.4 ablation)

The simulation replays a Dolly-like trace with static batching: RLP decays
as requests finish (Fig. 3), context lengths grow per decode iteration, and
PAPI's scheduler re-evaluates AI = RLP*TLP against alpha each iteration.

Latency/energy per kernel come from `core.pim`'s calibrated device models.
AttAcc's FC path has no batch-level data reuse (that capability *is* the
FC-PIM contribution), so its FC cost scales with m in both time and DRAM
energy; FC-PIM fetches each weight row once per iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core import pim
from repro_torch.core.scheduler import FC_PIM, FC_PU, PapiScheduler
from repro_torch.core.traces import Request

N_FC_DEVICES = 30
N_ATTN_DEVICES = 60
N_GPUS = 6
E_LINK_PJ_PER_BYTE = 10.0


@dataclasses.dataclass
class FCDims:
    """Per-layer FC kernels as (h_in, h_out) pairs."""
    kernels: list[tuple[int, int]]

    @classmethod
    def from_config(cls, cfg: ModelConfig) -> "FCDims":
        h, hd = cfg.d_model, cfg.resolved_head_dim
        ks = [
            (h, cfg.num_heads * hd + 2 * cfg.num_kv_heads * hd),  # QKV
            (cfg.num_heads * hd, h),                              # out proj
        ]
        if cfg.moe is not None and cfg.moe.num_experts:
            f = cfg.moe.d_ff
            # active expert FCs per token: top_k experts
            ks += [(h, 3 * f * cfg.moe.top_k // 1)]
            ks += [(f * cfg.moe.top_k, h)]
        elif cfg.mlp == "swiglu":
            ks += [(h, 2 * cfg.d_ff), (cfg.d_ff, h)]
        else:
            ks += [(h, cfg.d_ff), (cfg.d_ff, h)]
        return cls(ks)

    def flops(self, m: int) -> float:
        return sum(2.0 * m * a * b for a, b in self.kernels)

    def weight_bytes(self, bytes_per_el: int = 2) -> float:
        return sum(a * b * bytes_per_el for a, b in self.kernels)


@dataclasses.dataclass
class SimResult:
    time_s: float
    energy_j: float
    tokens: int
    iterations: int
    fc_time_s: float = 0.0
    attn_time_s: float = 0.0
    comm_time_s: float = 0.0
    reschedules: int = 0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / max(self.time_s, 1e-12)

    @property
    def energy_per_token(self) -> float:
        return self.energy_j / max(self.tokens, 1)


# ---------------------------------------------------------------------------
# Per-iteration kernel costs
# ---------------------------------------------------------------------------

def _fc_iter_cost(system: str, assignment: str, cfg: ModelConfig, m: int):
    """(time, energy) for ALL FC kernels of one decode iteration."""
    fc = FCDims.from_config(cfg)
    n_layers = cfg.num_layers
    flops = fc.flops(m) * n_layers
    wbytes = fc.weight_bytes() * n_layers
    act_bytes = sum(m * (a + b) * 2 for a, b in fc.kernels) * n_layers

    if assignment == FC_PU:
        t = sum(pim.gpu_fc_time(m, a, b, N_GPUS) for a, b in fc.kernels)
        t *= n_layers
        e = pim.gpu_kernel_energy(flops, wbytes + act_bytes)
        return t, e

    if system in ("papi", "pim_only_papi"):
        dev = pim.FC_PIM
        reuse = max(float(m), 1.0)
        dram_bytes = wbytes          # fetched once, reused across m rows
    else:                            # attacc_only: bounded batch-level reuse
        dev = pim.ATTACC
        cap = pim.ATTACC_FC_REUSE_CAP
        reuse = float(min(max(m, 1), cap))
        dram_bytes = wbytes * -(-m // cap)   # re-streamed per reuse window
    util = dev.sustainable_utilization(reuse)
    t_compute = flops / (dev.peak_flops * N_FC_DEVICES * util)
    t_memory = dram_bytes / (dev.internal_bw * N_FC_DEVICES)
    # host dispatch: one command stream per FC kernel per layer (§5.2)
    t_dispatch = n_layers * len(fc.kernels) * pim.PIM_KERNEL_OVERHEAD_S
    t = max(t_compute, t_memory) + t_dispatch
    e = dev.kernel_energy(flops, dram_bytes, act_bytes)
    return t, e


def _attn_iter_cost(system: str, cfg: ModelConfig, tlp: int,
                    ctxs: Sequence[int]):
    """(time, energy) for attention of one decode iteration over the active
    requests' context lengths."""
    n_layers = cfg.num_attention_applications()
    if n_layers == 0 or not ctxs:
        return 0.0, 0.0
    nkv, nq, hd = cfg.num_kv_heads, cfg.num_heads, cfg.resolved_head_dim
    kv_bytes = sum(2.0 * c * nkv * hd * 2 for c in ctxs) * n_layers
    flops = sum(4.0 * tlp * c * nq * hd for c in ctxs) * n_layers

    if system == "a100_hbmpim":
        dev = pim.HBM_PIM
    elif system in ("papi", "pim_only_papi"):
        dev = pim.ATTN_PIM
    else:
        dev = pim.ATTACC
    group = max(nq // max(nkv, 1), 1)
    util = dev.sustainable_utilization(max(float(tlp * group), 1.0))
    t_compute = flops / (dev.peak_flops * N_ATTN_DEVICES * util)
    t_memory = kv_bytes / (dev.internal_bw * N_ATTN_DEVICES)
    t = max(t_compute, t_memory) + n_layers * pim.LINK_LATENCY_S
    e = dev.kernel_energy(flops, kv_bytes, 0.0)
    return t, e


def _comm_iter_cost(system: str, cfg: ModelConfig, m: int, rlp: int,
                    fc_assignment: str):
    """Inter-device traffic per iteration: Q vectors + attention outputs
    cross PU <-> Attn-PIM (PCIe/CXL); activations cross PU <-> FC-PIM
    (NVLink) when FC runs on PIM."""
    h = cfg.d_model
    n_attn = cfg.num_attention_applications()
    # per attention layer: q out + attn result back, per active token
    attn_traffic = 2.0 * m * h * 2 * n_attn
    t = attn_traffic / pim.PCIE_BW + 2 * n_attn * pim.LINK_LATENCY_S
    e = attn_traffic * E_LINK_PJ_PER_BYTE * 1e-12
    if fc_assignment == FC_PIM:
        # weights are 2D-block distributed over N_FC_DEVICES (§6.4): the
        # activation broadcasts to every device holding a block row, and the
        # row-partitioned partial sums reduce back — 2x broadcast + 2x
        # tree-reduce traffic per layer boundary.
        fc_traffic = 4.0 * 2.0 * m * h * 2 * cfg.num_layers
        bw = pim.NVLINK_BW if system in ("papi", "pim_only_papi") else pim.PCIE_BW
        t += fc_traffic / bw + 2 * cfg.num_layers * pim.LINK_LATENCY_S
        e += fc_traffic * E_LINK_PJ_PER_BYTE * 1e-12
    return t, e


# ---------------------------------------------------------------------------
# Decode-phase simulation
# ---------------------------------------------------------------------------

def calibrate_alpha_system(cfg: ModelConfig,
                           ms: Sequence[int] | None = None) -> float:
    """Offline alpha calibration against the *full* per-iteration cost the
    system observes (kernel + dispatch + interconnect), per §5.2.1: 'using
    the observed execution times to establish the best alpha'."""
    if ms is None:
        ms = [1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512]

    def iter_cost(assignment: str, m: int) -> float:
        t_fc, _ = _fc_iter_cost("papi", assignment, cfg, m)
        t_cm, _ = _comm_iter_cost("papi", cfg, m, m, assignment)
        return t_fc + t_cm

    candidates = [0.5] + [m + 0.5 for m in ms]
    best_a, best_cost = candidates[0], float("inf")
    for a in candidates:
        cost = sum(
            iter_cost(FC_PU if m > a else FC_PIM, m) for m in ms
        )
        if cost < best_cost:
            best_cost, best_a = cost, a
    return best_a


def simulate_decode(
    system: str,
    cfg: ModelConfig,
    requests: Sequence[Request],
    batch_size: int,
    spec_len: int,
    alpha: float | None = None,
) -> SimResult:
    """Static batching (§7.1): batches of `batch_size` run to completion;
    RLP decays within each batch as requests finish."""
    if alpha is None:
        alpha = calibrate_alpha_system(cfg)
    sched = PapiScheduler(cfg, alpha=alpha, tlp=spec_len)

    total = SimResult(0.0, 0.0, 0, 0)
    for start in range(0, len(requests), batch_size):
        batch = list(requests[start : start + batch_size])
        sched.initial_schedule(len(batch), spec_len)
        remaining = {r.req_id: r.output_len for r in batch}
        ctx = {r.req_id: r.input_len for r in batch}

        while remaining:
            rlp = len(remaining)
            tlp = spec_len
            m = rlp * tlp

            if system == "papi":
                assignment = sched.fc_assignment
            elif system in ("a100_attacc", "a100_hbmpim"):
                assignment = FC_PU
            else:
                assignment = FC_PIM

            t_fc, e_fc = _fc_iter_cost(system, assignment, cfg, m)
            t_at, e_at = _attn_iter_cost(system, cfg, tlp, list(ctx[i] for i in remaining))
            t_cm, e_cm = _comm_iter_cost(system, cfg, m, rlp, assignment)

            total.time_s += t_fc + t_at + t_cm
            total.fc_time_s += t_fc
            total.attn_time_s += t_at
            total.comm_time_s += t_cm
            total.energy_j += e_fc + e_at + e_cm
            total.iterations += 1

            finished = 0
            for rid in list(remaining):
                remaining[rid] -= tlp
                ctx[rid] += tlp
                total.tokens += min(tlp, remaining[rid] + tlp)
                if remaining[rid] <= 0:
                    del remaining[rid]
                    finished += 1
            sched.observe_counts(finished)
        total.reschedules = sched.num_reschedules
    return total


def simulate_prefill_gpu(cfg: ModelConfig, requests: Sequence[Request]) -> float:
    """Prefill is compute-bound and runs on the GPU pool in every system
    (§7.4).  Returns time only (identical across systems)."""
    fc = FCDims.from_config(cfg)
    t = 0.0
    for r in requests:
        flops = fc.flops(r.input_len) * cfg.num_layers
        # attention flops (quadratic, small at these input lengths)
        flops += (4.0 * r.input_len ** 2 * cfg.num_heads * cfg.resolved_head_dim
                  * cfg.num_attention_applications())
        t += flops / (pim.GPU_PEAK_FLOPS * N_GPUS)
    return t


SYSTEMS = ("a100_attacc", "a100_hbmpim", "attacc_only", "papi", "pim_only_papi")


def compare_systems(
    cfg: ModelConfig,
    requests: Sequence[Request],
    batch_size: int,
    spec_len: int,
    systems: Sequence[str] = SYSTEMS,
) -> dict[str, SimResult]:
    return {
        s: simulate_decode(s, cfg, requests, batch_size, spec_len)
        for s in systems
    }
