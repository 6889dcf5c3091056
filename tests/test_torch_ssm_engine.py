"""The port's serving engine on the SSM families against the JAX package.

The mamba2-1.3b and zamba2-1.2b smoke twins (f32; d_state 16, head_dim 32,
chunk 32), the same weights through `params_from_jax`, the same requests.
The prefill window of 64 tokens gives two 32-row scan chunks per
admission wave; alpha=2 on 4 slots crosses pu -> pim as RLP decays; a
prompt longer than the window is rejected in both packages (SSM state has
no sequence dim to mask, so there are no chunk waves).  zamba2 runs with
``attn_pim`` off and on.

The port's prefill stops each row's SSM state at its prompt's end, and
the reference's takes in the window's zero padding (ROADMAP queue 3).  So
the greedy token streams are held against the reference run on each
prompt alone (`_ssm_oracle.greedy_streams`), and the per-iteration FC
variants, which follow only the schedule, against the reference engine
on the same requests.  The last tests hold a prompt padded into a larger
window to its decode state alone: the port's own, and the reference's on
the prompt alone.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.serving import PapiEngine as JaxEngine  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import (decode_step, init_cache,  # noqa: E402
                                params_from_jax, prefill_to_slots)
from repro_torch.serving import PapiEngine, ServeRequest  # noqa: E402
from _ssm_oracle import greedy_streams, prompt_alone  # noqa: E402

ENGINE = dict(max_slots=4, cache_capacity=128, prefill_len=64, alpha=2.0,
              eos_token=1)
ARCHES = ("mamba2-1.3b", "zamba2-1.2b")


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHES:
        jcfg = jax_config(arch).reduced()
        jparams = jax.jit(jm.init_params, static_argnums=0)(
            jcfg, jax.random.PRNGKey(0))
        cfg = get_config(arch + "-smoke")
        params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                 "cpu")
        out[arch] = (jcfg, jparams, cfg, params)
    return out


def _requests():
    """Ragged prompts up to the 64-token window (a full window, one 2-token
    prompt) and one of 70 tokens that both engines reject; staggered
    budgets, so RLP decays from 4."""
    rng = np.random.default_rng(0)
    lens = [5, 64, 17, 70, 33, 2, 48]
    return [(i, rng.integers(3, 256, size=n).tolist(), 3 + 2 * i)
            for i, n in enumerate(lens)]


def _streams(results):
    return {r.req_id: (r.tokens, r.finished_reason) for r in results}


@pytest.mark.parametrize("arch,attn_pim", [("mamba2-1.3b", False),
                                           ("zamba2-1.2b", False),
                                           ("zamba2-1.2b", True)])
def test_streams_match_reference_engine(models, arch, attn_pim):
    """The streams equal the reference on each prompt alone.  The
    schedule is held against the reference engine where it does not
    depend on the tokens: with eos off in both engines, every request's
    length and reason and the FC variant of every iteration are equal
    (with eos on, a padded reference stream may emit eos elsewhere)."""
    jcfg, jparams, cfg, params = models[arch]
    eng = PapiEngine(cfg, params, attn_pim=attn_pim, device="cpu", **ENGINE)
    for i, prompt, budget in _requests():
        eng.submit(ServeRequest(i, prompt, budget))
    got = _streams(eng.run(max_iterations=200))
    want = greedy_streams(jcfg, jparams, [r for r in _requests() if r[0] != 3],
                          ENGINE["eos_token"], ENGINE["cache_capacity"])
    assert got.pop(3) == ([], "rejected")            # 70 > prefill_len
    assert got == want
    assert all(reason in ("eos", "length") for _, reason in got.values())
    steady = [s for s in eng.stats if s.admitted == 0]
    assert steady and all(s.transfers == 1 for s in steady)

    no_eos = dict(ENGINE, eos_token=cfg.vocab_size)   # never emitted
    ref = JaxEngine(jcfg, jparams, attn_pim=attn_pim, **no_eos)
    eng = PapiEngine(cfg, params, attn_pim=attn_pim, device="cpu", **no_eos)
    for i, prompt, budget in _requests():
        ref.submit(JaxRequest(i, prompt, budget))
        eng.submit(ServeRequest(i, prompt, budget))
    lengths = [{i: (len(t), r) for i, (t, r) in _streams(e.run(200)).items()}
               for e in (ref, eng)]
    assert lengths[1] == lengths[0]
    assert [s.fc_variant for s in eng.stats] == [
        s.fc_variant for s in ref.stats]
    assert {"pu", "pim"} <= {s.fc_variant for s in eng.stats}


def test_launcher_serves_ssm_families_on_cpu(capsys):
    for arch in ARCHES:
        serve_cli.main(["--arch", arch + "-smoke", "--device", "cpu",
                        "--requests", "4", "--capacity", "128",
                        "--prefill-len", "32", "--max-prompt", "40",
                        "--attn-pim"])
        out = capsys.readouterr().out
        assert "completed 4 requests" in out and "fc_path" in out
    with pytest.raises(ValueError, match="no sequence dim to page"):
        serve_cli.main(["--arch", "mamba2-1.3b-smoke", "--device", "cpu",
                        "--kv", "paged"])


def _first_decode_logits(cfg, params, prompt, window):
    """Admit `prompt` alone in a prefill window of `window` tokens and
    return the logits of the first decode step."""
    toks = np.zeros((1, window), np.int32)
    toks[0, :len(prompt)] = prompt
    cache = init_cache(cfg, 1, 32, "cpu")
    first, cache = prefill_to_slots(
        cfg, params, {"tokens": torch.from_numpy(toks),
                      "prompt_lens": torch.tensor([len(prompt)],
                                                  dtype=torch.int32)},
        cache, torch.zeros(1, dtype=torch.int32))
    logits, _ = decode_step(cfg, params, cache, first[:, None])
    return first, logits[0, 0]


@pytest.mark.parametrize("arch", ARCHES)
def test_padded_window_leaves_decode_state_unchanged(models, arch):
    """A 5-token prompt in an 8-token window must decode as the same
    prompt in a window of its own length."""
    _, _, cfg, params = models[arch]
    prompt = np.random.default_rng(12).integers(3, 256, size=5).tolist()
    first_pad, padded = _first_decode_logits(cfg, params, prompt, 8)
    first, alone = _first_decode_logits(cfg, params, prompt, 5)
    assert torch.equal(first_pad, first)
    torch.testing.assert_close(padded, alone, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHES)
def test_padded_window_matches_reference_on_the_prompt_alone(models, arch):
    """A 5-token prompt in an 8-token window: the port's first token and
    first-decode logits equal the reference's on the prompt alone (its
    prefill at length 5, then one decode step), within 1e-4."""
    jcfg, jparams, cfg, params = models[arch]
    prompt = np.random.default_rng(12).integers(3, 256, size=5).tolist()
    jl, jc = prompt_alone(jcfg, jparams, prompt, 32)
    jfirst = int(np.argmax(np.asarray(jl)))
    jlogits, _ = jax.jit(jm.decode_step, static_argnums=0)(
        jcfg, jparams, jc, jnp.asarray([[jfirst]], jnp.int32))
    first, logits = _first_decode_logits(cfg, params, prompt, 8)
    assert int(first[0]) == jfirst
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits[0, 0]),
                               rtol=1e-4, atol=1e-4)
