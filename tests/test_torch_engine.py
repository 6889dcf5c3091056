"""The port's serving engine against `repro.serving.PapiEngine`.

Reduced qwen2 (f32, 2 layers, d=128), the same weights through
`params_from_jax`, the same requests: greedy token streams must be
identical, under the scheduler's pu/pim flip and with ``attn_pim`` on and
off.  Mirrors tests/test_serving.py, plus long prompts (chunked prefill),
honest rejection and the one-transfer-per-steady-iteration contract.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving import PapiEngine as JaxEngine  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import (decode_step, init_cache,  # noqa: E402
                                params_from_jax, prefill)
from repro_torch.serving import PapiEngine, ServeRequest  # noqa: E402

ENGINE = dict(max_slots=4, cache_capacity=64, prefill_len=8, alpha=6.0,
              eos_token=1)


@pytest.fixture(scope="module")
def small_model():
    jcfg = jax_config("qwen2-0.5b").reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("qwen2-0.5b-smoke")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


def _engine(cfg, params, **kw):
    return PapiEngine(cfg, params, device="cpu", **{**ENGINE, **kw})


def _streams(results):
    return {r.req_id: (r.tokens, r.finished_reason) for r in results}


def _mixed_requests():
    """Staggered budgets; prompts shorter than, equal to and longer than
    the 8-token prefill window (up to eight chunks), one that nearly fills
    the 64-token slab."""
    rng = np.random.default_rng(0)
    lens = [3, 8, 20, 5, 31, 2, 12, 60]
    return [(i, rng.integers(3, 256, size=n).tolist(), 2 + 3 * i)
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("attn_pim", [False, True])
def test_streams_match_reference_engine(small_model, attn_pim):
    """8 mixed requests on 8 slots at alpha=4: the run starts on "pu" and
    flips to "pim" as RLP decays; every stream equals the reference's."""
    jcfg, jparams, cfg, params = small_model
    kw = dict(max_slots=8, alpha=4.0, attn_pim=attn_pim)
    ref = JaxEngine(jcfg, jparams, **{**ENGINE, **kw})
    eng = _engine(cfg, params, **kw)
    for i, prompt, budget in _mixed_requests():
        ref.submit(JaxRequest(i, prompt, budget))
        eng.submit(ServeRequest(i, prompt, budget))
    want = _streams(ref.run(max_iterations=200))
    got = _streams(eng.run(max_iterations=200))
    assert got == want
    assert [s.fc_variant for s in eng.stats] == [
        s.fc_variant for s in ref.stats]
    assert {"pu", "pim"} <= {s.fc_variant for s in eng.stats}


def test_continuous_batching_completes_all(small_model):
    _, _, cfg, params = small_model
    eng = _engine(cfg, params)
    for i in range(7):           # more requests than slots
        eng.submit(ServeRequest(i, [3 + i, 5, 7], max_new_tokens=6))
    results = eng.run(max_iterations=200)
    assert sorted(r.req_id for r in results) == list(range(7))
    assert all(1 <= len(r.tokens) <= 6 for r in results)


def test_scheduler_flips_variant_as_rlp_decays(small_model):
    _, _, cfg, params = small_model
    eng = _engine(cfg, params, max_slots=8, alpha=4.0)
    for i in range(8):
        eng.submit(ServeRequest(i, [3, 5], max_new_tokens=2 + 3 * i))
    eng.run(max_iterations=200)
    variants = [s.fc_variant for s in eng.stats if s.rlp > 0]
    assert "pu" in variants      # 8 active > alpha=4
    assert "pim" in variants     # tail with < 4 active
    assert eng.scheduler.num_reschedules >= 1


def test_engine_output_matches_raw_decode(small_model):
    """A single request through the engine equals a direct prefill + decode
    loop on the port's raw model."""
    _, _, cfg, params = small_model
    prompt, n_new = [3, 5, 7, 11], 5
    cache = init_cache(cfg, 1, 64, "cpu")
    logits, cache = prefill(cfg, params, {
        "tokens": torch.tensor([prompt], dtype=torch.int32),
        "prompt_lens": torch.tensor([len(prompt)], dtype=torch.int32)},
        cache)
    want = [int(logits[0].argmax())]
    for _ in range(n_new - 1):
        lg, cache = decode_step(cfg, params, cache,
                                torch.tensor([[want[-1]]], dtype=torch.int32))
        want.append(int(lg[0, 0].argmax()))
    eng = _engine(cfg, params, max_slots=2)
    eng.submit(ServeRequest(0, prompt, max_new_tokens=n_new))
    got = eng.run(max_iterations=50)[0].tokens
    assert got == want[:len(got)]


@pytest.mark.parametrize("attn_pim", [False, True])
def test_pu_and_pim_variants_agree(small_model, attn_pim):
    """alpha=0 schedules "pu" whenever a request is live, alpha=99 always
    "pim"; the streams agree."""
    _, _, cfg, params = small_model

    def run(alpha):
        eng = _engine(cfg, params, alpha=alpha, attn_pim=attn_pim)
        eng.submit(ServeRequest(0, [3, 5, 7, 11], max_new_tokens=6))
        eng.submit(ServeRequest(1, list(range(3, 23)), max_new_tokens=4))
        res = eng.run(max_iterations=50)
        return _streams(res), {s.fc_variant for s in eng.stats if s.rlp}

    pu, pu_variants = run(0.0)
    pim, pim_variants = run(99.0)
    assert pu_variants == {"pu"} and pim_variants == {"pim"}
    assert pu == pim


def test_attn_pim_path_matches_plain_attention(small_model):
    _, _, cfg, params = small_model

    def run(**kw):
        eng = _engine(cfg, params, **kw)
        for i, prompt, budget in _mixed_requests()[:4]:
            eng.submit(ServeRequest(i, prompt, budget))
        return _streams(eng.run(max_iterations=100))

    assert run(attn_pim=True) == run()


def test_long_prompt_chunks_like_one_shot_prefill(small_model):
    """A 31-token prompt through an 8-token window (chunk 0 + 3 waves)
    gives the stream of an engine whose window holds it in one shot."""
    _, _, cfg, params = small_model
    prompt = np.random.default_rng(1).integers(3, 256, size=31).tolist()

    def run(prefill_len):
        eng = _engine(cfg, params, prefill_len=prefill_len)
        eng.submit(ServeRequest(0, prompt, max_new_tokens=5))
        return eng.run(max_iterations=50)[0].tokens

    assert run(8) == run(32)


def test_rejects_prompt_the_slab_cannot_hold(small_model):
    _, _, cfg, params = small_model
    eng = _engine(cfg, params)
    eng.submit(ServeRequest(0, list(range(3, 66)), max_new_tokens=4))
    eng.submit(ServeRequest(1, [3, 5, 7], max_new_tokens=3))
    res = {r.req_id: r for r in eng.run(max_iterations=50)}
    assert res[0].finished_reason == "rejected" and res[0].tokens == []
    assert res[1].finished_reason == "length" and len(res[1].tokens) == 3


def test_one_host_transfer_per_steady_iteration(small_model):
    _, _, cfg, params = small_model
    eng = _engine(cfg, params)
    for i, prompt, budget in _mixed_requests()[:6]:
        eng.submit(ServeRequest(i, prompt, budget))
    eng.run(max_iterations=200)
    steady = [s for s in eng.stats if s.admitted == 0]
    assert steady and all(s.transfers == 1 for s in steady)
    # an admission iteration adds exactly one copy, however many chunk
    # waves it ran
    assert all(s.transfers == 2 for s in eng.stats if s.admitted > 0)


def test_run_exhaustion_returns_in_flight_requests_as_aborted(small_model):
    _, _, cfg, params = small_model
    eng = _engine(cfg, params)
    eng.submit(ServeRequest(0, [3, 5, 7], max_new_tokens=20))
    res = eng.run(max_iterations=3)
    assert [r.finished_reason for r in res] == ["aborted"]
    assert len(res[0].tokens) == 4          # first token + 3 decode steps
    assert eng.active_slots == []


def test_scheduler_copy_matches_reference(small_model):
    """The port's scheduler and the reference's see the same finish and
    admission counts and make the same decisions."""
    from repro.core.scheduler import PapiScheduler as JaxScheduler
    from repro_torch.core.scheduler import PapiScheduler
    jcfg, _, cfg, _ = small_model
    ref, got = JaxScheduler(jcfg, alpha=4.0), PapiScheduler(cfg, alpha=4.0)
    ref.initial_schedule(0, 1)
    got.initial_schedule(0, 1)
    for finished, admitted in [(0, 8), (np.array([1, 0, 1]), 0), (1, 0),
                               (0, 3), (5, 0), (2, 0), (0, 0)]:
        assert got.observe_counts(finished, admitted) == ref.observe_counts(
            finished, admitted)
    assert [dataclasses.astuple(e) for e in got.events] == [
        dataclasses.astuple(e) for e in ref.events]
    assert got.num_reschedules == ref.num_reschedules >= 2


def test_launcher_runs_on_cpu(small_model, capsys):
    serve_cli.main(["--arch", "qwen2-0.5b-smoke", "--device", "cpu",
                    "--requests", "4", "--capacity", "128",
                    "--prefill-len", "16", "--max-prompt", "40",
                    "--attn-pim"])
    out = capsys.readouterr().out
    assert "completed 4 requests" in out
    assert "fc_path" in out
