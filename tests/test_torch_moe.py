"""The port's MoE layer (`models/moe.py`) and MoE serving against the JAX
package's.

Inputs from seeded numpy; f32 within 1e-4 abs + 1e-4 rel, expert choices
and greedy tokens identical:

* `expert_capacity` at and past the 2048-token edge, `router`,
  `load_balancing_loss` and `moe_mlp`'s ``y`` and ``aux`` (one group, and
  2048 tokens in two groups of 1024), at the smoke twins' (4 experts, top
  2) and at olmoe's and granite-moe's full routing (64 top 8, 32 top 8) on
  a narrow width; bf16 at the reference's rounding points; a token count
  that no group size divides is refused, as the reference asserts;
* olmoe's and granite-moe's smoke twins through both engines, dense and
  paged: the same streams, and per iteration the same FC variant, which
  follows the per-expert parallelism RLP·TLP·top_k/E (PAPI §6.5);
* the port's own olmoe engine: ``serve()`` equals ``run()``, and spec_len
  2 with the perfect draft equals TLP = 1;
* the per-expert count copy (the port's own, one per `moe_mlp` call) is
  counted: a steady iteration makes exactly the engine's
  ``transfer_budget`` host transfers, which the sanitizer holds.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving import PapiEngine as JaxEngine  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.ai import effective_parallelism  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serving import PapiEngine, ServeRequest  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE = dict(max_slots=4, cache_capacity=64, prefill_len=8, alpha=6.0,
              eos_token=1)
REQS = [(i, np.random.default_rng(i).integers(3, 256, size=n).tolist(),
         2 + 3 * i) for i, n in enumerate([3, 8, 20, 5, 31, 2, 12, 40])]
# (arch, width): the smoke twins' routing, and the full configs' routing
# (experts, top-k, per-expert d_ff) on a narrow model width
ROUTINGS = [("olmoe-1b-7b-smoke", 128), ("olmoe-1b-7b", 64),
            ("granite-moe-1b-a400m", 64)]


def _moe_cfgs(arch):
    """(reference MoEConfig, port MoEConfig), per-expert d_ff cut to 32
    for the full configs."""
    jcfg = jax_config(arch)
    cfg = get_config(arch)
    if not arch.endswith("-smoke"):
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, d_ff=32))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, d_ff=32))
    return jcfg.moe, cfg.moe


def _moe_params(mcfg, d, seed=0):
    rng = np.random.default_rng(seed)
    e, f = mcfg.num_experts, mcfg.d_ff
    return {"w_router": rng.standard_normal((d, e)) * d ** -0.5,
            "w_gate": rng.standard_normal((e, d, f)) * d ** -0.5,
            "w_up": rng.standard_normal((e, d, f)) * d ** -0.5,
            "w_down": rng.standard_normal((e, f, d)) * f ** -0.5}


def _jax(p, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype) for k, v in p.items()}


def _torch(p, dtype=torch.float32):
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(dtype)
            for k, v in p.items()}


@pytest.mark.parametrize("tokens", [1, 8, 1024, 2048, 2049, 3000, 65536])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-1b-a400m",
                                  "olmoe-1b-7b-smoke"])
def test_expert_capacity_matches_reference(arch, tokens):
    jcfg, cfg = _moe_cfgs(arch)
    assert tmoe.expert_capacity(tokens, cfg) == jmoe.expert_capacity(
        tokens, jcfg)


@pytest.mark.parametrize("arch,d", ROUTINGS)
def test_router_and_load_balancing_loss_match_reference(arch, d):
    jcfg, cfg = _moe_cfgs(arch)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((96, d)).astype(np.float32)
    w = _moe_params(cfg, d)["w_router"].astype(np.float32)
    je, jw, jp = jmoe.router(jnp.asarray(x), jnp.asarray(w), jcfg)
    te, tw, tp = tmoe.router(torch.from_numpy(x), torch.from_numpy(w), cfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, **TOL)
    np.testing.assert_allclose(
        tmoe.load_balancing_loss(tp, te, cfg.num_experts).item(),
        float(jmoe.load_balancing_loss(jp, je, jcfg.num_experts)), **TOL)


@pytest.mark.parametrize("b,s", [(2, 8), (4, 1), (2, 1024)])
@pytest.mark.parametrize("arch,d", ROUTINGS)
def test_moe_mlp_matches_reference(arch, d, b, s):
    """y and the aux loss; (2, 1024) is two groups of 1024 tokens (the aux
    loss is their mean), still routed without a drop."""
    jcfg, cfg = _moe_cfgs(arch)
    p = _moe_params(cfg, d, seed=2)
    x = np.random.default_rng(3).standard_normal((b, s, d)).astype(
        np.float32)
    jy, jaux = jax.jit(jmoe.moe_mlp, static_argnums=2)(
        jnp.asarray(x), _jax(p), jcfg)
    ty, taux = tmoe.moe_mlp(torch.from_numpy(x), _torch(p), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)


def test_moe_mlp_bf16_rounding_points_match():
    """silu in f32 cast back before * up; combine weights cast to bf16:
    within 2e-2, equal almost everywhere."""
    jcfg, cfg = _moe_cfgs("olmoe-1b-7b")
    p = _moe_params(cfg, 64, seed=4)
    x = np.random.default_rng(5).standard_normal((2, 16, 64)).astype(
        np.float32)
    jy, _ = jmoe.moe_mlp(jnp.asarray(x, jnp.bfloat16),
                         _jax(p, jnp.bfloat16), jcfg)
    ty, _ = tmoe.moe_mlp(torch.from_numpy(x).to(torch.bfloat16),
                         _torch(p, torch.bfloat16), cfg)
    want = np.asarray(jy, np.float32)
    np.testing.assert_allclose(ty.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)
    assert (ty.float().numpy() == want).mean() > 0.9


def test_moe_mlp_refuses_tokens_no_group_divides():
    _, cfg = _moe_cfgs("olmoe-1b-7b-smoke")
    p = _torch(_moe_params(cfg, 128))
    with pytest.raises(ValueError, match="not divisible"):
        tmoe.moe_mlp(torch.zeros(3, 700, 128), p, cfg)


def test_moe_mlp_counts_one_host_copy_per_call():
    _, cfg = _moe_cfgs("olmoe-1b-7b-smoke")
    p = _torch(_moe_params(cfg, 128))
    n0 = tmoe.host_copies()
    tmoe.moe_mlp(torch.zeros(2, 8, 128), p, cfg)
    assert tmoe.host_copies() == n0 + 1


# ---------------------------------------------------------------- engines
def _streams(results):
    return {r.req_id: (list(r.tokens), r.finished_reason) for r in results}


_MODELS: dict = {}


def _models(name):
    if name not in _MODELS:
        jcfg, cfg = jax_config(name).reduced(), get_config(name + "-smoke")
        jp = jax.jit(jm.init_params, static_argnums=0)(
            jcfg, jax.random.PRNGKey(0))
        tp = tm.params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu")
        _MODELS[name] = (jcfg, jp, cfg, tp)
    return _MODELS[name]


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("name", ["olmoe-1b-7b", "granite-moe-1b-a400m"])
def test_moe_engine_matches_reference_engine(name, layout):
    """alpha 2 with Attn-PIM on 8 slots: both packages' streams and
    per-iteration FC variants equal.  At top 2 of 4 experts a slot counts
    half in RLP·TLP·top_k/E, so "pu" runs while more than 4 slots live and
    "pim" after; every recorded AI estimate is that figure."""
    jcfg, jp, cfg, tp = _models(name)
    kw = dict(max_slots=8, alpha=2.0, attn_pim=True, kv_layout=layout)
    if layout == "paged":
        kw["page_size"] = 8
    ref = JaxEngine(jcfg, jp, **{**ENGINE, **kw})
    eng = PapiEngine(cfg, tp, device="cpu", **{**ENGINE, **kw})
    for i, prompt, budget in REQS:
        ref.submit(JaxRequest(i, prompt, budget))
        eng.submit(ServeRequest(i, prompt, budget))
    want = _streams(ref.run(max_iterations=300))
    assert _streams(eng.run(max_iterations=300)) == want
    assert [s.fc_variant for s in eng.stats] == [
        s.fc_variant for s in ref.stats]
    assert {"pu", "pim"} <= {s.fc_variant for s in eng.stats}
    for s in eng.stats:
        assert s.ai_estimate == effective_parallelism(cfg, s.rlp, s.tlp)
    if layout == "paged":
        eng.kv.alloc.check()
        assert eng.kv.alloc.mapped_count == 0


def test_moe_serve_and_speculation_equal_offline_run():
    """olmoe's smoke twin: serve() (one arrival an iteration) and spec_len
    2 with the perfect draft give the TLP = 1 offline streams (slots of 96
    positions: a 64-position slot clamps the longest request's budget by
    the verify window)."""
    _, _, cfg, tp = _models("olmoe-1b-7b")
    kw = dict(ENGINE, attn_pim=True, cache_capacity=96)

    def offline(**extra):
        eng = PapiEngine(cfg, tp, device="cpu", **{**kw, **extra})
        for i, prompt, budget in REQS:
            eng.submit(ServeRequest(i, prompt, budget))
        return {r.req_id: list(r.tokens)
                for r in eng.run(max_iterations=300)}, eng

    want, _ = offline()
    spec, eng = offline(spec_len=2, draft=(cfg, tp))
    assert spec == want
    assert max(s.accepted for s in eng.stats) == 2.0
    eng = PapiEngine(cfg, tp, device="cpu", **kw)
    served = {ev.req_id: list(ev.result.tokens)
              for ev in eng.serve([[ServeRequest(i, p, b)]
                                   for i, p, b in REQS]) if ev.finished}
    assert served == want


@pytest.mark.parametrize("spec_len", [1, 2])
def test_moe_engine_counts_its_count_copies(spec_len):
    """olmoe's smoke twin under the sanitizer: every steady iteration
    makes exactly 1 + L host transfers (the fetch and one count copy per
    MoE layer), plus spec_len * L for the MoE draft's steps; admission
    iterations count their prefills' copies too."""
    _, _, cfg, tp = _models("olmoe-1b-7b")
    layers = cfg.num_layers
    extra = dict(spec_len=spec_len, draft=(cfg, tp)) if spec_len > 1 else {}
    eng = PapiEngine(cfg, tp, device="cpu", sanitize=True,
                     **{**ENGINE, "cache_capacity": 96, **extra})
    for i, prompt, budget in REQS:
        eng.submit(ServeRequest(i, prompt, budget))
    eng.run(max_iterations=300)
    want = 1 + layers + (spec_len * layers if spec_len > 1 else 0)
    assert eng.transfer_budget == want
    rep = eng.sanitize_report()
    assert rep.steady_iterations > 0
    assert rep.transfer_budget == want
    assert rep.transfers_per_steady_iter == want
    steady = [s for s in eng.stats if s.admitted == 0 and s.decode_slots]
    assert steady and all(s.transfers == want for s in steady)
    assert all(s.transfers > want for s in eng.stats if s.admitted)
