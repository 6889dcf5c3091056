"""The port's core (`repro_torch.core`, `configs.paper_models`,
`kernels.ops`) against the JAX package's (`repro.core`).

Both packages run the same Python arithmetic on the same inputs, so every
float must be EQUAL, not close: the AI estimates (Eq. 1 / Eq. 2, the MoE
branch), the scheduler's event sequences (`set_tlp`, `observe_outputs`,
`observe_counts`), the PIM device models and energy, the system
simulators and the three α calibrations (`_crossover_alpha` on fixed
grids, `calibrate_alpha_measured` on deterministic fake callables whose
costs advance a fake clock).  Mirrors tests/test_core.py's TestAI,
TestScheduler, TestPIM and TestSystem.  The reference's configs are carried
to the port field by field (`_port_cfg`), so the MoE and paper models the
port does not register are compared too.
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import paper_models as ref_paper  # noqa: E402
from repro.core import ai as ref_ai  # noqa: E402
from repro.core import calibration as ref_cal  # noqa: E402
from repro.core import pim as ref_pim  # noqa: E402
from repro.core import scheduler as ref_sched  # noqa: E402
from repro.core import system as ref_sys  # noqa: E402
from repro.core.traces import generate_trace as ref_trace  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.configs import base as port_base  # noqa: E402
from repro_torch.configs import paper_models as port_paper  # noqa: E402
from repro_torch.core import ai  # noqa: E402
from repro_torch.core import calibration as cal  # noqa: E402
from repro_torch.core import pim  # noqa: E402
from repro_torch.core import scheduler as sched  # noqa: E402
from repro_torch.core import system  # noqa: E402
from repro_torch.core.traces import generate_trace  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

ARCHES = ("qwen2-0.5b", "granite-8b", "olmoe-1b-7b", "granite-moe-1b-a400m",
          "command-r-plus-104b", "zamba2-1.2b", "mamba2-1.3b")
PAPER = ("LLAMA_65B", "GPT3_66B", "GPT3_175B", "OPT_30B")


def _port_cfg(ref):
    """The reference's ModelConfig as the port's, field by field (the
    fields the port keeps; the nested MoE / SSM / hybrid configs too)."""
    nested = {"moe": port_base.MoEConfig, "ssm": port_base.SSMConfig,
              "hybrid": port_base.HybridConfig}
    kw = {}
    for f in dataclasses.fields(port_base.ModelConfig):
        v = getattr(ref, f.name)
        if f.name in nested and v is not None:
            v = nested[f.name](**dataclasses.asdict(v))
        kw[f.name] = v
    return port_base.ModelConfig(**kw)


def _cfgs(name):
    ref = (getattr(ref_paper, name) if name in PAPER else ref_config(name))
    return ref, _port_cfg(ref)


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("name", PAPER)
def test_paper_models_equal_reference(name):
    ref = getattr(ref_paper, name)
    port = getattr(port_paper, name)
    assert port == _port_cfg(ref)
    assert port_configs.get_config(port.name) is port


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "granite-moe-1b-a400m"])
def test_moe_config_and_reduced_twin_match_reference(name):
    ref, port = _cfgs(name)
    assert dataclasses.asdict(port.moe) == dataclasses.asdict(ref.moe)
    assert port.reduced() == _port_cfg(ref.reduced())


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "LLAMA_65B", "GPT3_66B"])
def test_model_refuses_moe_and_paper_models(name):
    """MoE, layernorm, untied heads and a gelu MLP (GPT-3, OPT) are all
    served, so olmoe's, LLaMA-65B's and GPT-3 66B's smoke twins build: the
    MoE leaves in place of the MLP's, a gelu MLP's biased two-layer
    leaves in place of swiglu's three.  What the model refuses is an MLP
    it does not know."""
    _, port = _cfgs(name)
    gen = torch.Generator().manual_seed(0)
    params = init_params(port.reduced(), gen)
    assert ("moe" in params["layers"]) == (port.moe is not None)
    assert ("mlp" in params["layers"]) == (port.moe is None)
    if port.mlp == "gelu":
        assert set(params["layers"]["mlp"]) == {"w_in", "b_in", "w_out",
                                                "b_out"}
    with pytest.raises(NotImplementedError, match="swiglu or gelu"):
        init_params(dataclasses.replace(port.reduced(), mlp="relu"), gen)


# --------------------------------------------------------------------- AI
@pytest.mark.parametrize("h", [896, 2048, 7168, 12288])
def test_fc_ai_exact_and_estimate_equal_reference(h):
    for m in (1, 2, 7, 32, 64, 512):
        for h_out in (None, 128, 4 * h):
            for b in (1, 2, 4):
                assert ai.fc_ai_exact(m, h, h_out, b) == ref_ai.fc_ai_exact(
                    m, h, h_out, b)
        assert ai.ai_error(m, h) == ref_ai.ai_error(m, h)
    for rlp, tlp in ((1, 1), (8, 4), (64, 2)):
        assert ai.fc_ai_estimate(rlp, tlp) == ref_ai.fc_ai_estimate(rlp, tlp)


def test_attention_ai_equals_reference():
    for tlp in (1, 2, 4, 8):
        for b in (1, 2):
            assert ai.attention_ai(tlp, b) == ref_ai.attention_ai(tlp, b)


@pytest.mark.parametrize("name", ARCHES + PAPER)
def test_effective_parallelism_equals_reference(name):
    """Including §6.5's MoE branch: per-expert m = RLP*TLP*top_k/E."""
    ref, port = _cfgs(name)
    for rlp, tlp in ((1, 1), (8, 4), (64, 2), (3, 7)):
        assert ai.effective_parallelism(port, rlp, tlp) == (
            ref_ai.effective_parallelism(ref, rlp, tlp))
    if port.moe is not None:
        assert ai.effective_parallelism(port, 64, 2) == (
            64 * 2 * port.moe.top_k / port.moe.num_experts)


# -------------------------------------------------------------- scheduler
def _drive(mod, cfg, alpha):
    """One scripted run of a scheduler module: initial schedule, eos-driven
    decay, admissions, TLP register writes and array-valued finish flags."""
    s = mod.PapiScheduler(cfg, alpha=alpha, tlp=1)
    s.initial_schedule(48, 1)
    rng = np.random.default_rng(int(alpha))
    for it in range(30):
        toks = rng.choice([2, 5, 9], size=max(s.rlp, 1), p=[0.1, 0.5, 0.4])
        s.observe_outputs(toks.tolist(), admitted=int(it % 7 == 0))
        if it == 10:
            s.set_tlp(4)
        if it == 20:
            s.set_tlp(1)
    s.observe_counts(np.array([True, False, True]), admitted=np.int64(2))
    s.observe_counts(np.array([1, 0]), admitted=np.array([1, 1]))
    return s


@pytest.mark.parametrize("alpha", [4.0, 12.0, 32.0])
@pytest.mark.parametrize("name", ["granite-8b", "olmoe-1b-7b"])
def test_scheduler_event_sequence_equals_reference(name, alpha):
    ref, port = _cfgs(name)
    got, want = _drive(sched, port, alpha), _drive(ref_sched, ref, alpha)
    assert [dataclasses.astuple(e) for e in got.events] == [
        dataclasses.astuple(e) for e in want.events]
    assert got.num_reschedules == want.num_reschedules
    assert got.fc_assignment == want.fc_assignment
    assert got.attention_assignment == want.attention_assignment == "attn_pim"


def test_tlp_register_update_reschedules_at_once():
    """set_tlp is a monitored parallelism change: the flip is logged
    without waiting for the next iteration (as test_core.py's
    test_tlp_register_update)."""
    _, port = _cfgs("granite-8b")
    s = sched.PapiScheduler(port, alpha=32.0, tlp=1)
    s.initial_schedule(16, 1)
    assert s.fc_assignment == sched.FC_PIM
    s.set_tlp(8)
    assert s.fc_assignment == sched.FC_PU and s.events[-1].rescheduled
    assert (s.events[-1].tlp, s.num_reschedules) == (8, 1)
    s.set_tlp(8)                       # no change: no event
    assert len(s.events) == 2


# -------------------------------------------------------------------- PIM
def test_pim_constants_and_devices_equal_reference():
    for name in dir(ref_pim):
        v = getattr(ref_pim, name)
        if name.isupper() and isinstance(v, (int, float)):
            assert getattr(pim, name) == v, name
    for dev in ("ATTACC", "HBM_PIM", "FC_PIM", "ATTN_PIM"):
        a, b = getattr(pim, dev), getattr(ref_pim, dev)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert (a.banks, a.fpus, a.peak_flops, a.internal_bw,
                a.capacity_bytes, a.area_per_die_mm2()) == (
            b.banks, b.fpus, b.peak_flops, b.internal_bw, b.capacity_bytes,
            b.area_per_die_mm2())
    for f in (0.5, 1.0, 2.0, 4.0):
        assert pim.max_banks_per_die(f) == ref_pim.max_banks_per_die(f)


@pytest.mark.parametrize("dev", ["ATTACC", "HBM_PIM", "FC_PIM", "ATTN_PIM"])
def test_pim_device_models_equal_reference(dev):
    a, b = getattr(pim, dev), getattr(ref_pim, dev)
    for r in (1, 2, 3, 4, 16, 64, 256):
        assert a.power_at(r) == b.power_at(r)
        assert a.power_at(r, 0.5) == b.power_at(r, 0.5)
        assert a.sustainable_utilization(r) == b.sustainable_utilization(r)
    for m in (1, 4, 8, 32, 128, 512):
        for h, h_out in ((896, 896), (7168, 7168 // 30), (4096, 11008)):
            assert a.gemv_time(m, h, h_out) == b.gemv_time(m, h, h_out)
    for tlp in (1, 2, 4, 8):
        for ctx in (128, 2048):
            assert a.attention_time(tlp, ctx, 8, 64, 128) == (
                b.attention_time(tlp, ctx, 8, 64, 128))
    assert a.kernel_energy(1e12, 3e9, 1e8) == b.kernel_energy(1e12, 3e9, 1e8)


def test_gpu_models_and_energy_breakdown_equal_reference():
    for r in (1, 4, 64, 1000):
        assert pim.energy_breakdown(r) == ref_pim.energy_breakdown(r)
    for m in (1, 8, 64, 512):
        for n in (1, 6):
            assert pim.gpu_fc_time(m, 7168, 7168, n) == ref_pim.gpu_fc_time(
                m, 7168, 7168, n)
            assert pim.gpu_attention_time(m, 2, 1024, 8, 64, 128, n) == (
                ref_pim.gpu_attention_time(m, 2, 1024, 8, 64, 128, n))
    assert pim.gpu_kernel_energy(1e12, 1e9) == ref_pim.gpu_kernel_energy(
        1e12, 1e9)
    # Fig. 7's claims hold in the copy
    assert pim.energy_breakdown(1)["dram"] == pytest.approx(0.967, abs=0.003)
    assert pim.FC_PIM.banks_per_die == 96


# ----------------------------------------------------------------- system
@pytest.mark.parametrize("name", ARCHES + PAPER)
def test_fc_dims_equal_reference(name):
    ref, port = _cfgs(name)
    a, b = system.FCDims.from_config(port), ref_sys.FCDims.from_config(ref)
    assert a.kernels == b.kernels
    assert (a.flops(8), a.weight_bytes()) == (b.flops(8), b.weight_bytes())


@pytest.mark.parametrize("spec_len", [1, 2, 4])
@pytest.mark.parametrize("name", PAPER)
def test_simulate_decode_equals_reference(name, spec_len):
    ref, port = _cfgs(name)
    trace = ref_trace("creative-writing", 16, seed=0)
    assert trace == [ref_sys.Request(*dataclasses.astuple(r))
                     for r in generate_trace("creative-writing", 16, 0)]
    for s in system.SYSTEMS:
        got = system.simulate_decode(s, port, trace, 16, spec_len)
        want = ref_sys.simulate_decode(s, ref, trace, 16, spec_len)
        assert dataclasses.astuple(got) == dataclasses.astuple(want), s
    assert system.simulate_prefill_gpu(port, trace) == (
        ref_sys.simulate_prefill_gpu(ref, trace))


def test_compare_systems_equals_reference_and_papi_is_fastest():
    ref, port = _cfgs("LLAMA_65B")
    trace = ref_trace("creative-writing", 16, seed=0)
    got = system.compare_systems(port, trace, batch_size=16, spec_len=2)
    want = ref_sys.compare_systems(ref, trace, batch_size=16, spec_len=2)
    assert {k: dataclasses.astuple(v) for k, v in got.items()} == {
        k: dataclasses.astuple(v) for k, v in want.items()}
    assert all(got["papi"].time_s <= r.time_s * 1.0001 for r in got.values())
    assert got["papi"].tokens_per_s == want["papi"].tokens_per_s
    assert got["papi"].energy_per_token == want["papi"].energy_per_token


# ------------------------------------------------------------ calibration
GRIDS = [
    ([1, 2, 4, 8, 16, 32, 64, 128],
     [1.0, 1.0, 1.1, 1.2, 2.5, 3.9, 7.8, 15.5],
     [2.0, 2.0, 2.0, 2.1, 2.1, 2.2, 2.4, 3.0]),
    ([1, 2, 4, 8], [1.0, 2.0, 3.0, 4.0], [0.5, 0.5, 0.5, 0.5]),   # pu always
    ([1, 2, 4, 8], [0.1, 0.2, 0.3, 0.4], [9.0, 9.0, 9.0, 9.0]),   # pim always
    ([1, 2, 4, 8, 16], [3.0, 1.0, 3.0, 1.0, 3.0], [2.0] * 5),     # ragged
    ([1, 2, 4], [1.0, 1.0, 1.0], [1.0, 1.0, 1.0]),                # ties
]


@pytest.mark.parametrize("ms,t_pim,t_pu", GRIDS)
def test_crossover_alpha_equals_reference(ms, t_pim, t_pu):
    assert cal._crossover_alpha(ms, t_pim, t_pu) == ref_cal._crossover_alpha(
        ms, t_pim, t_pu)


def test_crossover_alpha_picks_the_crossover():
    ms, t_pim, t_pu = GRIDS[0]
    assert cal._crossover_alpha(ms, t_pim, t_pu) == 8.5
    assert cal._crossover_alpha(*GRIDS[1]) == 0.5        # pu from m = 1
    assert cal._crossover_alpha(*GRIDS[2]) == 8.5        # pim to the end


@pytest.mark.parametrize("name", ARCHES[:5] + PAPER)
def test_calibrate_alpha_model_and_system_equal_reference(name):
    ref, port = _cfgs(name)
    assert cal.calibrate_alpha_model(port) == ref_cal.calibrate_alpha_model(
        ref)
    assert cal.calibrate_alpha_model(port, 10, 2, [1, 8, 64]) == (
        ref_cal.calibrate_alpha_model(ref, 10, 2, [1, 8, 64]))
    if name in PAPER:
        a = system.calibrate_alpha_system(port)
        assert a == ref_sys.calibrate_alpha_system(ref)
        assert 4 < a < 512


def _fake_measure(monkeypatch, module, pu_cost, pim_cost, **kw):
    """calibrate_alpha_measured over callables that advance a fake clock
    by a deterministic cost of m; returns (alpha, calls per callable)."""
    clock = [0.0]
    calls = {"pu": [], "pim": []}
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])

    def run_pu(m):
        calls["pu"].append(m)
        clock[0] += pu_cost(m)

    def run_pim(m):
        calls["pim"].append(m)
        clock[0] += pim_cost(m)

    return module.calibrate_alpha_measured(run_pu, run_pim, **kw), calls


@pytest.mark.parametrize("pu_cost,pim_cost,want", [
    (lambda m: 2e-5 + 1e-8 * m, lambda m: 1e-6 * m, 16.5),
    (lambda m: 5e-6, lambda m: 1e-5, 0.5),
    (lambda m: 1.0, lambda m: 1e-3 * m, 128.5),
])
def test_calibrate_alpha_measured_equals_reference(monkeypatch, pu_cost,
                                                   pim_cost, want):
    got, calls = _fake_measure(monkeypatch, cal, pu_cost, pim_cost)
    ref, ref_calls = _fake_measure(monkeypatch, ref_cal, pu_cost, pim_cost)
    assert got == ref == want
    ms = [1, 2, 4, 8, 16, 32, 64, 128]
    # a warm-up and 5 timed calls per m, every pu m before any pim m
    assert calls == ref_calls
    assert calls["pu"] == [m for m in ms for _ in range(6)]
    got2, calls2 = _fake_measure(monkeypatch, cal, pu_cost, pim_cost,
                                 ms=[1, 4, 64], repeats=2)
    assert got2 == _fake_measure(monkeypatch, ref_cal, pu_cost, pim_cost,
                                 ms=[1, 4, 64], repeats=2)[0]
    assert calls2["pim"] == [1, 1, 1, 4, 4, 4, 64, 64, 64]


# -------------------------------------------------------------------- ops
@pytest.mark.parametrize("variant", ["pu", "pim"])
def test_fc_forward_matches_reference(variant):
    """Both paths compute x @ w; the reference's "pim" is the Pallas
    fc_gemv in interpret mode on the CPU."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ops import fc_forward as ref_fc_forward
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 160)) / 10).astype(np.float32)
    got = ops.fc_forward(torch.from_numpy(x), torch.from_numpy(w), variant)
    want = np.asarray(ref_fc_forward(jnp.asarray(x), jnp.asarray(w),
                                     variant, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        ops.fc_forward(torch.from_numpy(x), torch.from_numpy(w), "gpu")


def test_fc_layer_runners_drive_calibration_on_the_cpu():
    """The runners run one layer's FC groups on the first m rows (pu: one
    matmul per weight; pim: one fc_gemv_group call per group, its plain
    version on the CPU) and cycle through their weight copies."""
    groups = [(32, [32, 8, 8]), (32, [32]), (32, [64, 64]), (64, [32])]
    run_pu, run_pim = ops.fc_layer_runners(
        groups, max_m=16, dtype=torch.float32, device="cpu",
        generator=torch.Generator().manual_seed(0), copies=2)
    for m in (1, 5, 16):
        run_pu(m)
        run_pim(m)
    alpha = cal.calibrate_alpha_measured(run_pu, run_pim, ms=[1, 2, 4],
                                         repeats=1)
    assert alpha in (0.5, 1.5, 2.5, 4.5)
    assert [len(ns) for _, ns in ops.QWEN2_FC_GROUPS] == [3, 1, 2, 1]
    assert ops.ZAMBA2_FC_GROUPS[-1] == (8192, [2048])
