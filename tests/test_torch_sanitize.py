"""The port's runtime sanitizer (`repro_torch.debug.sanitize`) against the
reference's contract, on the CPU.

Every case of `tests/test_sanitize.py` that has a port counterpart:

  * a `PapiEngine(sanitize=True)` run completes with steady iterations at
    EXACTLY the transfer budget, greedy and speculative, and
    `sanitize_report()` is None with the gate off;
  * `EngineSanitizer.after_step` raises on an over-budget steady
    iteration, exempts non-steady ones, and counts the distinct program
    keys the engine dispatched (the port has no jit caches: `_call`
    notes each key);
  * `SanitizeReport.asdict` round-trips.

The reference's compile census flags a jit retrace; its port counterpart
flags a kernel built or loaded by `kernels._build` after the engine's
first steady iteration.  Nothing compiles on the CPU, so that case fakes
a load in `_build`'s table.  The reference's rank-promotion case has no
counterpart: PyTorch has no switch that raises on implicit rank
promotion, and `sanitized(rank_promotion=)` keeps the name only.

The sync guard (`torch.cuda.set_sync_debug_mode("error")`) exists only on
the card; the ``gpu`` cases check that a ``.item()`` inside a sanitized
step raises `SanitizeError` and that the previous mode comes back, and
that a traced run on the card (CUDA event pairs) keeps one transfer per
steady iteration.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.debug import (EngineSanitizer, SanitizeError,  # noqa: E402
                               SanitizeReport, sanitized, transfer_allowed)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import PapiEngine, ServeRequest  # noqa: E402
from repro_torch.serving.engine import IterStats  # noqa: E402


@pytest.fixture(scope="module")
def small_model():
    cfg = get_config("qwen2-0.5b-smoke")
    return cfg, init_params(cfg, torch.Generator().manual_seed(0))


def _run(cfg, params, device="cpu", **kw):
    eng = PapiEngine(cfg, params, max_slots=2, cache_capacity=64,
                     prefill_len=8, alpha=6.0, eos_token=cfg.vocab_size - 1,
                     fused=True, sanitize=True, device=device, **kw)
    for i in range(3):
        eng.submit(ServeRequest(i, [3 + i, 5, 7], max_new_tokens=8))
    results = eng.run(max_iterations=100)
    return eng, results


def test_sanitized_is_a_no_op_off_the_card():
    """On the CPU there is no stream to synchronise: the strict context
    and the allow-scope pass through, whatever runs inside."""
    x = torch.arange(4)
    with sanitized(device="cpu"):
        assert x.sum().item() == 6
        with transfer_allowed():
            assert x.cpu().tolist() == [0, 1, 2, 3]
    with sanitized():
        assert int(x[1]) == 1


def test_sanitized_engine_run_meets_budget(small_model):
    cfg, params = small_model
    eng, results = _run(cfg, params)
    assert len(results) == 3
    rep = eng.sanitize_report()
    assert rep is not None
    assert rep.steady_iterations > 0
    assert rep.transfers_per_steady_iter == rep.transfer_budget == 1
    assert rep.recompiles == 0
    assert rep.programs >= 1


def test_sanitized_speculative_run_meets_budget(small_model):
    cfg, params = small_model
    draft = init_params(cfg, torch.Generator().manual_seed(9))
    eng, results = _run(cfg, params, spec_len=3, draft=(cfg, draft))
    assert len(results) == 3
    rep = eng.sanitize_report()
    assert rep.steady_iterations > 0
    assert rep.transfers_per_steady_iter == 1.0
    assert rep.recompiles == 0


def test_sanitized_streams_equal_unsanitized(small_model):
    cfg, params = small_model
    eng, results = _run(cfg, params)
    plain = PapiEngine(cfg, params, max_slots=2, cache_capacity=64,
                       prefill_len=8, alpha=6.0,
                       eos_token=cfg.vocab_size - 1, device="cpu")
    for i in range(3):
        plain.submit(ServeRequest(i, [3 + i, 5, 7], max_new_tokens=8))
    want = {r.req_id: r.tokens for r in plain.run(max_iterations=100)}
    assert {r.req_id: r.tokens for r in results} == want
    assert [s.transfers for s in eng.stats] == [s.transfers
                                                for s in plain.stats]


def test_report_absent_when_gate_off(small_model):
    cfg, params = small_model
    eng = PapiEngine(cfg, params, max_slots=2, cache_capacity=64,
                     prefill_len=8, alpha=6.0, fused=True, device="cpu")
    assert eng.sanitize_report() is None


# ----------------------------------------------- after_step unit checks

def _stats(transfers, **kw):
    base = dict(iteration=5, rlp=1, tlp=1, ai_estimate=1.0,
                fc_variant="pu", new_tokens=1, accepted=1.0, wall_s=0.01,
                transfers=transfers, decode_slots=1)
    base.update(kw)
    return IterStats(**base)


class _FakeEngine:
    fused = True
    device = torch.device("cpu")
    transfer_budget = 1

    def __init__(self, stats):
        self.stats = stats


def test_after_step_flags_budget_overrun():
    san = EngineSanitizer()
    with pytest.raises(SanitizeError, match="transfer budget"):
        san.after_step(_FakeEngine([_stats(transfers=2)]), stepped=True)


def test_after_step_exempts_non_steady_iterations():
    san = EngineSanitizer()
    for extra in ({"admitted": 1}, {"arrivals": 1}, {"prefill_slots": 1},
                  {"degraded": 1}, {"preemptions": 1}):
        san.after_step(_FakeEngine([_stats(transfers=3, **extra)]),
                       stepped=True)
    assert san.report.steady_iterations == 0
    assert san.report.iterations == 5


def test_after_step_flags_a_steady_state_build(monkeypatch):
    """A kernel built or loaded after the first steady iteration raises;
    loads before it (admission's) do not."""
    monkeypatch.setattr(_build, "_LIBS", {})
    san = EngineSanitizer()
    eng = _FakeEngine([_stats(transfers=1, admitted=1)])
    _build._LIBS["fc_gemv"] = object()           # admission loaded one
    san.after_step(eng, stepped=True)
    eng.stats.append(_stats(transfers=1))        # the first steady step
    san.after_step(eng, stepped=True)
    san.after_step(eng, stepped=True)            # nothing new: fine
    _build._LIBS["decode_attention"] = object()  # a build in steady state
    with pytest.raises(SanitizeError, match="decode_attention"):
        san.after_step(eng, stepped=True)
    assert san.report.recompiles == 0


def test_after_step_counts_programs():
    san = EngineSanitizer()
    for key in (("a",), ("b",), ("a",)):
        san.note_program(key)
    san.after_step(_FakeEngine([_stats(transfers=1)]), stepped=True)
    assert san.report.programs == 2
    assert san.report.steady_iterations == 1
    assert san.report.steady_transfers == 1


def test_engine_programs_are_its_call_keys(small_model):
    cfg, params = small_model
    eng, _ = _run(cfg, params)
    assert eng.sanitize_report().programs == len(eng._sanitizer._programs)
    kinds = {k[0] for k in eng._sanitizer._programs}
    assert kinds == {"main", "plain_fused"}


def test_report_asdict_round_trip():
    san = EngineSanitizer()
    san.after_step(_FakeEngine([_stats(transfers=1)]), stepped=True)
    d = san.report.asdict()
    assert d["transfers_per_steady_iter"] == 1.0
    assert set(d) >= {"transfer_budget", "iterations", "steady_iterations",
                      "steady_transfers", "recompiles", "programs"}
    assert dataclasses.asdict(san.report)["steady_iterations"] == 1
    assert SanitizeReport(**dataclasses.asdict(san.report)) == san.report


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sync guard exists only there)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_item_inside_a_sanitized_step_raises_on_the_card(cuda):
    x = torch.arange(4, device=cuda)
    before = torch.cuda.get_sync_debug_mode()
    with pytest.raises(SanitizeError, match="synchroniz"):
        with sanitized(device=cuda):
            x.sum().item()
    assert torch.cuda.get_sync_debug_mode() == before
    with sanitized(device=cuda):
        with transfer_allowed():
            assert x.cpu().numpy().tolist() == [0, 1, 2, 3]
        assert torch.cuda.get_sync_debug_mode() == 2
    assert torch.cuda.get_sync_debug_mode() == before


@pytest.mark.gpu
def test_sanitized_engine_on_the_card(cuda, small_model):
    cfg, _ = small_model
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    eng, results = _run(cfg, params, device=cuda)
    assert len(results) == 3
    assert eng.sanitize_report().transfers_per_steady_iter == 1.0
    real = eng._fetch

    def leaky(*tensors):
        tensors[0].sum().item()          # a sync outside the allow-scope
        return real(*tensors)

    eng._fetch = leaky
    eng.submit(ServeRequest(9, [3, 5, 7], max_new_tokens=4))
    with pytest.raises(SanitizeError):
        eng.run(max_iterations=20)
    assert torch.cuda.get_sync_debug_mode() == 0
    assert np.isfinite(eng.sanitize_report().transfers_per_steady_iter)


@pytest.mark.gpu
def test_traced_run_on_the_card_keeps_one_transfer(cuda, small_model):
    """On the card programs are timed by CUDA event pairs resolved after
    the fetch: a steady iteration still makes one host transfer, and the
    table has a positive time for every key."""
    from repro_torch.serving import Tracer
    cfg, _ = small_model
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    tr = Tracer()
    eng = PapiEngine(cfg, params, max_slots=4, cache_capacity=64,
                     prefill_len=8, alpha=6.0, eos_token=cfg.vocab_size - 1,
                     tracer=tr, device=cuda)
    for i in range(3):
        eng.submit(ServeRequest(i, [3 + i, 5, 7], max_new_tokens=8))
    eng.run(max_iterations=60)
    steady = [s for s in eng.stats if not s.admitted]
    assert steady and all(s.transfers == 1 for s in steady)
    table = tr.program_table()
    assert table and all(t["total_s"] > 0 for t in table.values())
    assert tr._pending == []
