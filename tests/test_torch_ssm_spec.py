"""Lossless speculative decoding on the SSM families in the port.

A verify window advances every layer's SSM state and conv history by k
tokens.  The port's verify keeps the state after each token of its window
(`decode_step(..., ssm_steps)`), the draft keeps its k steps' states, and
a partial accept selects both at the accepted prefix (`rewind_ssm`) beside
the position rewind.  The oracle is the port's own TLP = 1 stream: the
reference rewinds only the position, so its speculative mamba2 streams
leave its TLP = 1 streams (tests/test_torch_spec.py keeps that strict
xfail).  The mamba2-1.3b and zamba2-1.2b smoke twins, f32, weights from
seeds:

* the per-token states: the state selected after j tokens of a window
  equals j single t = 1 steps within 1e-6, per slot; the state the window
  read is unchanged; the conv history after j rows equals the history
  `_causal_conv` gives the first j rows;
* the engine at spec_len 2 and 4 with three drafts (the target itself,
  the target cut to its first layer or two, a seed-9 model): streams
  equal the TLP = 1 streams, the cut draft accepts a partial prefix (1 <
  accepted < 4) in some window; the fused iteration equals the host loop
  with one transfer per speculative iteration; NaN faults on a
  speculative mamba2 run give the clean streams; `set_spec_len` widens
  a live engine's window;
* a mamba2 draft for a qwen2 target serves where their vocabularies agree
  (the smoke twins) and is refused where they differ (the published
  configs); paged speculation stays refused;
* the launcher with ``--spec-len 3 --draft-arch mamba2-1.3b-smoke``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.serving import (FaultInjector, PapiEngine,  # noqa: E402
                                 ServeRequest)

ARCHES = ("mamba2-1.3b", "zamba2-1.2b")
ENGINE = dict(max_slots=4, cache_capacity=128, prefill_len=32, alpha=2.0,
              eos_token=1)
# the cut draft's depth: mamba2's first layer, zamba2's first shared-block
# segment (period 2)
CUT = {"mamba2-1.3b": 1, "zamba2-1.2b": 2}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut(cfg, params, n):
    """The model cut to its first n layers (the shared block kept)."""
    def take(tree):
        return {k: take(v) if isinstance(v, dict) else v[:n]
                for k, v in tree.items()}
    return dataclasses.replace(cfg, num_layers=n), dict(
        params, layers=take(params["layers"]))


@pytest.fixture(scope="module")
def models():
    """{arch: {draft name: (cfg, params)}}: "target" is the target."""
    out = {}
    for arch in ARCHES:
        cfg = get_config(arch + "-smoke")
        params = tm.init_params(cfg, torch.Generator().manual_seed(0))
        out[arch] = {
            "target": (cfg, params),
            "cut": _cut(cfg, params, CUT[arch]),
            "seed9": (cfg, tm.init_params(cfg,
                                          torch.Generator().manual_seed(9))),
        }
    return out


def _requests():
    """Ragged prompts up to the 32-token window, one of 40 tokens that
    every engine rejects, 5 admitted into 4 slots (a second admission
    wave while the others speculate)."""
    rng = np.random.default_rng(0)
    lens = [5, 30, 17, 40, 2, 9]
    return [(i, rng.integers(3, 256, size=n).tolist(), 10 + 3 * i)
            for i, n in enumerate(lens)]


def _engine(models, arch, draft=None, **kw):
    cfg, params = models[arch]["target"]
    d = models[arch][draft] if draft else None
    return PapiEngine(cfg, params, draft=d, device="cpu", **{**ENGINE, **kw})


def _serve(eng):
    """Streams of `_requests()`; the accepted counts of the live slots of
    every speculative window are kept in ``eng.accepted_by_slot``."""
    eng.accepted_by_slot = []
    rewind = eng._rewind

    def record(accepted, *rest):
        live = eng.active_slots
        eng.accepted_by_slot.append(
            [a for s, a in enumerate(accepted.tolist()) if s in live])
        return rewind(accepted, *rest)
    eng._rewind = record
    for i, prompt, budget in _requests():
        eng.submit(ServeRequest(i, prompt, budget))
    return {r.req_id: (r.tokens, r.finished_reason)
            for r in eng.run(max_iterations=300)}


@pytest.fixture(scope="module")
def plain(models):
    """The TLP = 1 streams per arch."""
    return {arch: _serve(_engine(models, arch)) for arch in ARCHES}


# ------------------------------------------------------- per-token states
@pytest.mark.parametrize("arch", ARCHES)
def test_selected_state_equals_single_steps(models, arch):
    """A 4-token window with per-token buffers, then each slot rewound to
    its own count (1..4): each slot's SSM state and conv histories equal
    those of that many t = 1 steps over the same tokens, and the state the
    window read is untouched."""
    cfg, params = models[arch]["target"]
    rng = np.random.default_rng(3)
    b, k = 4, 4
    toks = torch.from_numpy(rng.integers(3, 256, size=(b, 12)).astype(
        np.int32))
    _, cache = tm.prefill(cfg, params, {
        "tokens": toks, "prompt_lens": torch.tensor([12, 7, 3, 10],
                                                    dtype=torch.int32)},
        tm.init_cache(cfg, b, 64, "cpu"))
    window = torch.from_numpy(rng.integers(3, 256, size=(b, k)).astype(
        np.int32))
    pre = dict(cache)
    kept = [x.clone() for x in pre["ssm"]]
    steps = tm.ssm_step_buffers(cache, k)
    wl, cache = tm.decode_step(cfg, params, cache, window, steps)
    assert all(torch.equal(x, y) for x, y in zip(pre["ssm"], kept))
    n = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    tm.rewind_ssm(cache, steps, n)
    single = dict(pre)
    for j in range(k):
        sl, single = tm.decode_step(cfg, params, single, window[:, j:j + 1])
        torch.testing.assert_close(wl[:, j], sl[:, 0], rtol=1e-5, atol=1e-5)
        s = j                                   # the slot rewound to j + 1
        for mine, want in zip(cache["ssm"], single["ssm"]):
            # zamba2's deeper layers see the shared attention's window
            # and single-step roundings: 1e-6 absolute, 1e-5 relative
            torch.testing.assert_close(mine[:, s], want[:, s], rtol=1e-5,
                                       atol=1e-6)
    assert all(torch.equal(x, y) for x, y in zip(pre["ssm"], kept))


def test_conv_histories_after_each_row():
    """`_causal_conv(..., steps=True)`'s history after j rows is the
    history the first j rows alone leave, from a random history."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 5, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    hist = torch.from_numpy(rng.standard_normal((2, 3, 6)).astype(
        np.float32))
    y, per_row = tssm._causal_conv(x, w, hist, steps=True)
    assert per_row.shape == (5, 2, 3, 6)
    for j in range(1, 6):
        yj, want = tssm._causal_conv(x[:, :j], w, hist)
        assert torch.equal(per_row[j - 1], want)
        assert torch.equal(y[:, :j], yj)


# --------------------------------------------------------------- engine
@pytest.mark.parametrize("draft", ["target", "cut", "seed9"])
@pytest.mark.parametrize("spec_len", [2, 4])
@pytest.mark.parametrize("arch", ARCHES)
def test_spec_streams_equal_tlp1_streams(models, plain, arch, spec_len,
                                         draft):
    eng = _engine(models, arch, draft, spec_len=spec_len)
    got = _serve(eng)
    assert got == plain[arch]
    assert got[3] == ([], "rejected")                 # 40 > prefill_len
    acc = [a for w in eng.accepted_by_slot for a in w]
    assert acc and all(1 <= a <= spec_len for a in acc)
    if draft == "target":
        assert all(a == spec_len for a in acc)
    if draft == "cut" and spec_len == 4:          # the rewind ran
        assert any(1 < a < spec_len for a in acc)
    steady = [s for s in eng.stats if s.admitted == 0]
    assert steady and all(s.transfers == 1 for s in steady)


@pytest.mark.parametrize("arch", ARCHES)
def test_fused_equals_host_loop_with_one_transfer(models, arch):
    k = 4
    fused = _engine(models, arch, "cut", spec_len=k)
    host = _engine(models, arch, "cut", spec_len=k, fused=False)
    assert _serve(fused) == _serve(host)
    assert fused.accepted_by_slot == host.accepted_by_slot
    assert any(1 < a < k for w in fused.accepted_by_slot for a in w)
    assert {s.transfers for s in fused.stats if s.admitted == 0} == {1}
    assert {s.transfers for s in host.stats if s.admitted == 0} == {k + 1}


def test_nan_faults_on_speculative_mamba2_give_the_clean_streams(models,
                                                                 plain):
    """Poisoned verify windows put back both caches' pre-step entries
    (none aliases a per-token buffer) and re-run one plain step."""
    eng = _engine(models, "mamba2-1.3b", "cut", spec_len=4,
                  faults=FaultInjector(seed=2, start=1, stop=9, nan_p=0.6))
    assert _serve(eng) == plain["mamba2-1.3b"]
    assert eng.degraded_steps >= 2
    assert sum(s.degraded for s in eng.stats) == eng.degraded_steps


@pytest.mark.parametrize("arch", ARCHES)
def test_set_spec_len_widens_a_live_ssm_engine(models, plain, arch):
    eng = _engine(models, arch, "cut", spec_len=1)
    for i, prompt, budget in _requests():
        eng.submit(ServeRequest(i, prompt, budget))
    for _ in range(3):
        eng.step()
    eng.set_spec_len(3)
    assert eng.spec_len == 3
    got = {r.req_id: (r.tokens, r.finished_reason) for r in eng.run(300)}
    assert got == plain[arch]
    assert any(s.tlp == 3 and s.accepted > 1 for s in eng.stats)


def test_mixed_pair_serves_where_vocabularies_agree(models):
    """A mamba2 draft for a qwen2 target: the smoke twins share a
    256-token vocabulary and speculate losslessly (the 40-token prompt is
    rejected: the draft's state takes no chunk waves); the published
    configs do not, and the engine refuses the pair by vocabulary."""
    cfg = get_config("qwen2-0.5b-smoke")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    draft = models["mamba2-1.3b"]["target"]
    engines = [PapiEngine(cfg, params, device="cpu", **ENGINE),
               PapiEngine(cfg, params, draft=draft, spec_len=3,
                          device="cpu", **ENGINE)]
    want, got = (_serve(e) for e in engines)
    assert want[3][1] == "length" and got[3] == ([], "rejected")
    assert {i: s for i, s in got.items() if i != 3} == {
        i: s for i, s in want.items() if i != 3}
    assert get_config("qwen2-0.5b").vocab_size != get_config(
        "mamba2-1.3b").vocab_size
    dcfg = dataclasses.replace(draft[0], vocab_size=cfg.vocab_size + 1)
    with pytest.raises(ValueError, match="vocabulary"):
        PapiEngine(cfg, params, draft=(dcfg, draft[1]), spec_len=3,
                   device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="no sequence dim to page"):
        _engine(models, "zamba2-1.2b", "cut", spec_len=2, kv_layout="paged")


def test_launcher_speculates_on_mamba2(capsys):
    argv = ["--arch", "mamba2-1.3b-smoke", "--device", "cpu", "--requests",
            "6", "--max-prompt", "32"]
    out = {}
    for k in (1, 3):
        extra = ["--spec-len", "3", "--draft-arch",
                 "mamba2-1.3b-smoke"] if k > 1 else []
        serve_cli.main(argv + extra)
        out[k] = capsys.readouterr().out
    assert "completed 6 requests" in out[3]
    assert ("speculation: spec_len 3, draft mamba2-1.3b-smoke, mean "
            "accepted per window") in out[3]
    # lossless: the same tokens as the TLP = 1 launch of the same requests
    tokens = [next(line for line in o.splitlines()
                   if line.startswith("tokens:")).split()[1]
              for o in (out[1], out[3])]
    assert tokens[0] == tokens[1]
