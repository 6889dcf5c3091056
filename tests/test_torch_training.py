"""The port's training stack against the JAX package's.

Reduced configs (the smoke twins, f32), numpy inputs from seeds, the
reference's weights through `params_from_jax` (norm weights and biases
perturbed, so that their multiplies are exercised), the reference's side
under `jax.jit`:

* `make_batch` byte-equal to the reference's for every family's smoke
  twin, over steps and shards;
* `forward_train`'s loss within 1e-5 relative and every gradient leaf
  within 1e-4 of `jax.grad`, on the smoke twins of qwen2 (dense),
  granite-moe (the aux loss), qwen2-vl (patches, [b, 3, s] positions),
  hubert-xlarge (frames and mask, bidirectional, gelu), mamba2 and zamba2,
  with the port's remat on and off; `flash_attention`'s blocked path
  differentiated against `dense_attention`;
* `adamw_update`, `lr_schedule`, `compress` and `compress_with_feedback`
  against the reference's; three `make_train_step` steps at accum 1 and 2,
  compression off and on, against the reference's jitted step;
* checkpoints written by either package restored in the other, f32 and
  bf16;
* the reference's own training tests run on the port (loss decreases,
  accum equals the full batch, remat equals no-remat, the checkpoint
  roundtrip, idempotent re-save, gc, resume, the watchdog, compression,
  the lr schedule, the data stream);
* 12 steps equal 10 steps and a resume of 2, exactly; a port subprocess
  (no jax) sent SIGTERM leaves the checkpoint of the steps it did and
  resumes from it;
* the plain SSD scan at chunk 256 with dt 0.1 and A = -16: its forward
  bit-equal to the unmasked form, its gradients finite (a strict xfail
  records the reference's non-finite gradient there);
* every kernel wrapper raising under autograd; the launcher on the CPU,
  and raising without ``--device`` on a host without a card.
"""
import dataclasses
import functools
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro import training as jt  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch import training as tt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, make_batch, to_device  # noqa: E402
from repro_torch.kernels import decode_attention as attn_mod  # noqa: E402
from repro_torch.kernels import fc_gemv as fc_mod  # noqa: E402
from repro_torch.kernels import paged_decode_attention as paged_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.training import tree  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
# arch -> the sequence length of its model parity case (batch 2)
FAMILIES = {"qwen2-0.5b": 16, "granite-moe-1b-a400m": 16, "qwen2-vl-7b": 16,
            "hubert-xlarge": 16, "mamba2-1.3b": 64, "zamba2-1.2b": 64}
CFG = get_config("qwen2-0.5b-smoke")


def _perturb(jp, seed=0):
    """Norm weights 1 + 0.1 N(0, 1) and biases 0.1 N(0, 1), in place of
    the reference's ones and zeros."""
    rng = np.random.default_rng(seed)

    def walk(node, path=""):
        out = {}
        for key, val in node.items():
            if isinstance(val, dict):
                out[key] = walk(val, key)
            elif key.startswith("norm") or path == "final_norm":
                out[key] = jnp.asarray(
                    1 + 0.1 * rng.standard_normal(val.shape), val.dtype)
            elif key.startswith("b_"):
                out[key] = jnp.asarray(
                    0.1 * rng.standard_normal(val.shape), val.dtype)
            else:
                out[key] = val
        return out
    return walk(jp)


def _models(arch, dtype=None):
    """(port cfg, reference cfg, reference params, port params)."""
    cfg, jc = get_config(arch + "-smoke"), jax_config(arch).reduced()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
        jc = dataclasses.replace(jc, dtype=dtype)
    jp = _perturb(jm.init_params(jc, jax.random.PRNGKey(0)))
    tp = tm.params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jc, jp, tp


def _jax_flat(t) -> dict:
    """The reference checkpoint's keys -> numpy leaves."""
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in
                     path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}


def _port_flat(t) -> dict:
    return {k: v.detach().float().numpy() for k, v in tree.flatten(t)}


def _assert_trees_close(port, ref, **tol):
    got, want = _port_flat(port), _jax_flat(ref)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)


# ---------------------------------------------------------------------------
# the data stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(FAMILIES))
def test_make_batch_byte_equal_to_the_reference(arch):
    cfg, jc = get_config(arch + "-smoke"), jax_config(arch).reduced()
    for shards, shard in ((1, 0), (2, 0), (2, 1)):
        dc = DataConfig(seed=3, batch=4, seq_len=32, num_shards=shards,
                        shard=shard)
        jd = jpipe.DataConfig(**dataclasses.asdict(dc))
        for step in (0, 7):
            got, want = make_batch(cfg, dc, step), jpipe.make_batch(
                jc, jd, step)
            assert sorted(got) == sorted(want)
            for key in want:
                assert got[key].dtype == want[key].dtype, key
                assert got[key].tobytes() == want[key].tobytes(), key
    tb = to_device(make_batch(cfg, DataConfig(batch=2, seq_len=8), 0), "cpu")
    assert all(isinstance(v, torch.Tensor) for v in tb.values())


# ---------------------------------------------------------------------------
# forward_train and its gradients
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_grads(arch):
    cfg, jc, jp, tp = _models(arch)
    batch = jpipe.make_batch(jc, jpipe.DataConfig(seed=1, batch=2,
                                                  seq_len=FAMILIES[arch]), 0)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jm.forward_train(jc, p, b, remat=True)[0]))
    loss, grads = fn(jp, jax.tree.map(jnp.asarray, batch))
    return cfg, batch, float(loss), grads, jp


@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_forward_train_and_grads_match_the_reference(arch, remat):
    cfg, batch, want_loss, want_grads, jp = _reference_grads(arch)
    tp = tm.params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu")
    leaves = tree.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = tm.forward_train(cfg, tp, to_device(batch, "cpu"),
                                     remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - want_loss) <= 1e-5 * abs(want_loss)
    if cfg.family == "moe":
        assert float(metrics["aux"]) > 0
    _assert_trees_close(tree.unflatten(tp, list(grads)), want_grads, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_blocked_grads_equal_dense(causal):
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                            requires_grad=True)
               for s in ((2, 32, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16)))
    w = torch.tensor(rng.standard_normal((2, 32, 4, 16)), dtype=torch.float32)
    out_f = tl.flash_attention(q, k, v, causal=causal, q_block=8, kv_block=8)
    g_f = torch.autograd.grad((out_f * w).sum(), (q, k, v))
    out_d = tl.dense_attention(q, k, v, causal=causal)
    g_d = torch.autograd.grad((out_d * w).sum(), (q, k, v))
    torch.testing.assert_close(out_f, out_d, rtol=1e-5, atol=1e-5)
    for a, b in zip(g_f, g_d):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_hubert_trains_but_has_no_decode_path():
    cfg = get_config("hubert-xlarge-smoke")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    assert params["mask_embed"]["w"].shape == (cfg.d_model,)
    batch = to_device(make_batch(cfg, DataConfig(batch=2, seq_len=8), 0),
                      "cpu")
    loss, _ = tm.forward_train(cfg, params, batch)
    assert torch.isfinite(loss)
    with pytest.raises(ValueError, match="encoder-only"):
        tm.init_cache(cfg, 2, 16, "cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        tm.decode_step(cfg, params, {"pos": torch.zeros(2, dtype=torch.int32)},
                       torch.zeros((2, 1), dtype=torch.int32))


# ---------------------------------------------------------------------------
# the optimizer and compression
# ---------------------------------------------------------------------------

def _tensor_tree(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def test_adamw_update_matches_the_reference():
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 6), "stack": (3, 5), "b": (6,)}
    p0 = _tensor_tree(rng, shapes)
    grads = [_tensor_tree(rng, shapes) for _ in range(3)]
    ocfg = tt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5,
                          grad_clip=2.0)
    jcfg = jt.AdamWConfig(**dataclasses.asdict(ocfg))
    jp = jax.tree.map(jnp.asarray, p0)
    js = jt.init_adamw(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = tt.init_adamw(tp)
    for g in grads:
        jp, js, jmet = jt.adamw_update(jcfg, jp, jax.tree.map(jnp.asarray, g),
                                       js)
        tp, ts, tmet = tt.adamw_update(
            ocfg, tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=1e-6)
    assert int(ts.step) == int(js.step) == 3
    _assert_trees_close(tp, jp, rtol=1e-6, atol=1e-7)
    _assert_trees_close(ts.m, js.m, rtol=1e-6, atol=1e-7)
    _assert_trees_close(ts.v, js.v, rtol=1e-6, atol=1e-7)


def test_lr_schedule_matches_the_reference():
    ocfg = tt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    jcfg = jt.AdamWConfig(**dataclasses.asdict(ocfg))
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            float(tt.lr_schedule(ocfg, torch.tensor(step, dtype=torch.int32))),
            float(jt.lr_schedule(jcfg, jnp.asarray(step))), rtol=1e-6)


def test_compression_matches_the_reference():
    rng = np.random.default_rng(1)
    g = (0.1 * rng.standard_normal((64, 8))).astype(np.float32)
    q, s = tt.compress(torch.from_numpy(g))
    jq, js = jt.compress(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-7)
    np.testing.assert_allclose(tt.decompress(q, s).numpy(),
                               np.asarray(jt.decompress(jq, js)), rtol=1e-7)
    grads = _tensor_tree(rng, {"a": (16,), "b": (4, 4)})
    err = {k: (1e-3 * v).astype(np.float32)
           for k, v in _tensor_tree(rng, {"a": (16,), "b": (4, 4)}).items()}
    sent, new_err = tt.compress_with_feedback(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in err.items()})
    jsent, jerr = jt.compress_with_feedback(jax.tree.map(jnp.asarray, grads),
                                            jax.tree.map(jnp.asarray, err))
    _assert_trees_close(sent, jsent, rtol=1e-6, atol=1e-8)
    _assert_trees_close(new_err, jerr, rtol=1e-6, atol=1e-8)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

STEP_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _split(batch, accum):
    if accum == 1:
        return batch
    return {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
            for k, v in batch.items()}


@pytest.mark.parametrize("compress", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_the_reference(accum, compress):
    cfg, jc, jp, tp = _models("qwen2-0.5b")
    ocfg = tt.AdamWConfig(**STEP_OPT)
    jstep = jax.jit(jt.make_train_step(
        jc, jt.AdamWConfig(**STEP_OPT), accum=accum, remat=True,
        compress_grads=compress))
    tstep = tt.make_train_step(cfg, ocfg, accum=accum, remat=True,
                               compress_grads=compress)
    js, ts = jt.init_adamw(jp), tt.init_adamw(tp)
    jerr = jt.init_error(jp) if compress else {}
    terr = tt.init_error(tp) if compress else {}
    dc = DataConfig(seed=2, batch=4, seq_len=16)
    for step in range(3):
        raw = _split(make_batch(cfg, dc, step), accum)
        jp, js, jerr, jmet = jstep(jp, js, jerr,
                                   jax.tree.map(jnp.asarray, raw))
        tp, ts, terr, tmet = tstep(tp, ts, terr, to_device(raw, "cpu"))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
    if not compress:
        _assert_trees_close(tp, jp, **TOL)
        _assert_trees_close(ts.m, js.m, rtol=1e-4, atol=1e-6)
        return
    # int8: a gradient element that sits on a rounding tie in one package
    # and off it in the other lands one quantization step away, and Adam
    # scales that element's update by its own 1 / sqrt(v) (up to lr a
    # step).  At most one element in 10^4 may differ, by no more than
    # that bound; the rest hold the f32 tolerances.
    for port, ref, tol, bound in (
            (tp, jp, TOL, 3 * STEP_OPT["lr"]),
            (ts.m, js.m, dict(rtol=1e-4, atol=1e-6), 1e-3),
            (terr, jerr, dict(rtol=1e-4, atol=1e-6), 1e-3)):
        got, want = _port_flat(port), _jax_flat(ref)
        assert sorted(got) == sorted(want)
        off = total = 0
        for key in want:
            diff = np.abs(got[key] - want[key])
            bad = diff > tol["atol"] + tol["rtol"] * np.abs(want[key])
            assert diff.max() <= bound, key
            off, total = off + int(bad.sum()), total + bad.size
        assert off <= total * 1e-4, (off, total)


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def _stepped(arch, dtype):
    """Both packages' params and optimizer state after one step from the
    same weights: the reference's update applied to the reference's
    gradients, the port's to the port's."""
    cfg, jc, jp, tp = _models(arch, dtype)
    raw = make_batch(cfg, DataConfig(batch=2, seq_len=16), 0)
    grad = jax.jit(jax.grad(lambda p, b: jm.forward_train(jc, p, b)[0]))
    jp, js, _ = jt.adamw_update(
        jt.AdamWConfig(**STEP_OPT), jp,
        grad(jp, jax.tree.map(jnp.asarray, raw)), jt.init_adamw(jp))
    tp, ts, _, _ = tt.make_train_step(cfg, tt.AdamWConfig(**STEP_OPT))(
        tp, tt.init_adamw(tp), {}, to_device(raw, "cpu"))
    return cfg, jp, js, tp, ts


def _exact(port, ref):
    got, want = _port_flat(port), _jax_flat(ref)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_restore_across_the_packages(tmp_path, dtype):
    cfg, jp, js, tp, ts = _stepped("qwen2-0.5b", dtype)
    # the port writes, the reference restores
    tt.CheckpointManager(str(tmp_path / "port")).save(
        1, {"params": tp, "opt": ts}, blocking=True)
    got = jt.CheckpointManager(str(tmp_path / "port")).restore(
        1, {"params": jp, "opt": js})
    assert got["params"]["embed"]["w"].dtype == jp["embed"]["w"].dtype
    assert int(got["opt"].step) == 1
    _exact(tp, got["params"])
    _exact(ts, got["opt"])
    # the reference writes, the port restores
    jt.CheckpointManager(str(tmp_path / "ref")).save(
        1, {"params": jp, "opt": js}, blocking=True)
    back = tt.CheckpointManager(str(tmp_path / "ref")).restore(
        1, {"params": tp, "opt": ts})
    assert back["params"]["embed"]["w"].dtype == tp["embed"]["w"].dtype
    assert back["opt"].step.dtype == torch.int32 and int(back["opt"].step) == 1
    _exact(back["params"], jp)
    _exact(back["opt"], js)


# ---------------------------------------------------------------------------
# the reference's own training tests, on the port
# ---------------------------------------------------------------------------

def test_loss_decreases_over_training(tmp_path):
    tcfg = tt.TrainConfig(steps=30, checkpoint_every=100, log_every=100,
                          checkpoint_dir=str(tmp_path), remat=False)
    res = tt.run_training(CFG, tcfg, DataConfig(batch=4, seq_len=32),
                          tt.AdamWConfig(lr=1e-3, warmup_steps=5,
                                         total_steps=30), device="cpu")
    first, last = np.mean(res.losses[:5]), np.mean(res.losses[-5:])
    assert last < first - 0.2, (first, last)


def _params():
    return tm.init_params(CFG, torch.Generator().manual_seed(0))


def _clone(t):
    return tree.tree_map(lambda x: x.detach().clone(), t)


def test_grad_accumulation_matches_large_batch():
    ocfg = tt.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10,
                          grad_clip=1e9)
    params = _params()
    raw = make_batch(CFG, DataConfig(batch=8, seq_len=16), 0)
    p1 = _clone(params)
    p1, _, _, m1 = tt.make_train_step(CFG, ocfg, accum=1, remat=False)(
        p1, tt.init_adamw(p1), {}, to_device(raw, "cpu"))
    p2 = _clone(params)
    p2, _, _, m2 = tt.make_train_step(CFG, ocfg, accum=2, remat=False)(
        p2, tt.init_adamw(p2), {}, to_device(_split(raw, 2), "cpu"))
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)
    for a, b in zip(tree.leaves(p1), tree.leaves(p2)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=5e-2, atol=5e-4)


def test_remat_matches_no_remat():
    params = _params()
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = to_device(make_batch(CFG, DataConfig(batch=2, seq_len=16), 0),
                      "cpu")
    g1 = torch.autograd.grad(tm.forward_train(CFG, params, batch,
                                              remat=False)[0], leaves)
    g2 = torch.autograd.grad(tm.forward_train(CFG, params, batch,
                                              remat=True)[0], leaves)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-5)


@pytest.mark.parametrize("seed", range(8))
def test_compression_roundtrip_error_bounded(seed):
    g = torch.from_numpy(0.1 * np.random.default_rng(seed).standard_normal(
        64).astype(np.float32))
    q, s = tt.compress(g)
    assert float(torch.max(torch.abs(tt.decompress(q, s) - g))) <= (
        float(s) * 0.5 + 1e-9)


def test_error_feedback_telescopes():
    rng = np.random.default_rng(0)
    true_sum = torch.zeros(32)
    sent_sum = torch.zeros(32)
    err = {"g": torch.zeros(32)}
    for _ in range(50):
        g = torch.from_numpy((0.01 * rng.standard_normal(32)).astype(
            np.float32))
        true_sum += g
        sent, err = tt.compress_with_feedback({"g": g}, err)
        sent_sum += sent["g"]
    assert float(torch.max(torch.abs(true_sum - sent_sum))) < 5e-4


def test_save_restore_roundtrip(tmp_path):
    ckpt = tt.CheckpointManager(str(tmp_path))
    params = _params()
    opt = tt.init_adamw(params)
    ckpt.save(7, {"params": params, "opt": opt}, blocking=True)
    assert ckpt.latest_step() == 7
    restored = ckpt.restore(7, {"params": params, "opt": opt})
    for a, b in zip(tree.leaves(params), tree.leaves(restored["params"])):
        assert torch.equal(a, b)


def test_resave_same_step_is_idempotent(tmp_path):
    ckpt = tt.CheckpointManager(str(tmp_path))
    params = {"w": torch.arange(4.0)}
    ckpt.save(5, {"params": params}, blocking=True)
    ckpt.save(5, {"params": {"w": torch.arange(4.0) * 2}}, blocking=True)
    restored = ckpt.restore(5, {"params": params})
    assert torch.equal(restored["params"]["w"], torch.arange(4.0) * 2)


def test_async_save_snapshots_before_later_updates(tmp_path):
    ckpt = tt.CheckpointManager(str(tmp_path))
    params = {"w": torch.arange(4.0)}
    ckpt.save(1, {"params": params})
    params["w"].mul_(10)                 # an in-place step after the save
    ckpt.wait()
    restored = ckpt.restore(1, {"params": params})
    assert torch.equal(restored["params"]["w"], torch.arange(4.0))


def test_gc_keeps_last_k(tmp_path):
    ckpt = tt.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ckpt.save(s, {"params": {"w": torch.zeros(4)}}, blocking=True)
    assert ckpt.all_steps() == [3, 4]


def test_resume_continues_training(tmp_path):
    dcfg = DataConfig(batch=2, seq_len=16)
    ocfg = tt.AdamWConfig(lr=1e-3, total_steps=10)
    tt.run_training(CFG, tt.TrainConfig(
        steps=10, checkpoint_every=5, log_every=100,
        checkpoint_dir=str(tmp_path), remat=False), dcfg, ocfg, device="cpu")
    assert tt.CheckpointManager(str(tmp_path)).all_steps() == [5, 10]
    res = tt.run_training(CFG, tt.TrainConfig(
        steps=12, checkpoint_every=50, log_every=100,
        checkpoint_dir=str(tmp_path), remat=False), dcfg, ocfg, resume=True,
        device="cpu")
    assert res.resumed_from == 10
    assert len(res.losses) == 2 and res.final_step == 12


def test_twelve_steps_equal_ten_and_a_resume_of_two(tmp_path):
    dcfg = DataConfig(batch=2, seq_len=16)
    ocfg = tt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12)

    def run(d, steps, resume=False):
        return tt.run_training(CFG, tt.TrainConfig(
            steps=steps, checkpoint_every=100, log_every=100,
            checkpoint_dir=str(tmp_path / d), remat=True, accum=2),
            dcfg, ocfg, resume=resume, device="cpu")

    whole = run("a", 12)
    run("b", 10)
    tail = run("b", 12, resume=True)
    assert tail.resumed_from == 10
    assert tail.losses == whole.losses[10:]
    a = tt.CheckpointManager(str(tmp_path / "a"))
    b = tt.CheckpointManager(str(tmp_path / "b"))
    tmpl = {"params": _params()}
    tmpl["opt"] = tt.init_adamw(tmpl["params"])
    for x, y in zip(tree.leaves(a.restore(12, tmpl)),
                    tree.leaves(b.restore(12, tmpl))):
        assert torch.equal(x, y)


def test_sigterm_checkpoints_the_steps_done_and_resumes(tmp_path):
    """A port subprocess (no jax) sent SIGTERM after its step k: the
    checkpoint is labelled with the steps it did, holds the model after
    those steps (the reference would label it step 0), and a resume starts
    there."""
    ckdir = tmp_path / "ck"
    code = (
        "import sys\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.data import DataConfig\n"
        "from repro_torch.training import AdamWConfig, TrainConfig, "
        "run_training\n"
        "res = run_training(get_config('qwen2-0.5b-smoke'), TrainConfig("
        f"steps=100000, log_every=1, checkpoint_every=10**9, "
        f"checkpoint_dir={str(ckdir)!r}, remat=False), "
        "DataConfig(batch=2, seq_len=16), AdamWConfig(lr=1e-3, "
        "total_steps=100000), device='cpu')\n"
        "print('done', res.final_step, flush=True)\n"
        "print('jax loaded', any(m.split('.')[0] in ('jax', 'repro') "
        "for m in sys.modules), flush=True)\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    try:
        for line in proc.stdout:
            if line.split()[:2] == ["step", "3"]:
                proc.send_signal(signal.SIGTERM)
                break
        out, _ = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 0, out
    lines = out.splitlines()
    done = int(next(x for x in lines if x.startswith("done")).split()[1])
    assert "jax loaded False" in lines
    assert done >= 3
    ckpt = tt.CheckpointManager(str(ckdir))
    assert ckpt.all_steps() == [done]
    # the checkpoint holds the model after `done` steps
    ocfg = tt.AdamWConfig(lr=1e-3, total_steps=100000)
    dcfg = DataConfig(batch=2, seq_len=16)
    tt.run_training(CFG, tt.TrainConfig(
        steps=done, checkpoint_every=10**9, log_every=100, remat=False,
        checkpoint_dir=str(tmp_path / "ref")), dcfg, ocfg, device="cpu")
    tmpl = {"params": _params()}
    saved = ckpt.restore(done, tmpl)["params"]
    want = tt.CheckpointManager(str(tmp_path / "ref")).restore(done,
                                                               tmpl)["params"]
    for x, y in zip(tree.leaves(saved), tree.leaves(want)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5, atol=1e-6)
    res = tt.run_training(CFG, tt.TrainConfig(
        steps=done + 2, checkpoint_every=10**9, log_every=100, remat=False,
        checkpoint_dir=str(ckdir)), dcfg, ocfg, resume=True, device="cpu")
    assert res.resumed_from == done and len(res.losses) == 2


def test_lr_schedule_shape():
    ocfg = tt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    assert float(tt.lr_schedule(ocfg, 0)) == 0.0
    assert float(tt.lr_schedule(ocfg, 10)) == pytest.approx(1.0)
    assert float(tt.lr_schedule(ocfg, 100)) == pytest.approx(0.1)


def test_data_pipeline_deterministic_and_sharded():
    d0 = DataConfig(seed=1, batch=8, seq_len=16, num_shards=2, shard=0)
    d1 = DataConfig(seed=1, batch=8, seq_len=16, num_shards=2, shard=1)
    a, b, c = (make_batch(CFG, d, step=3) for d in (d0, d0, d1))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == (4, 16)


def test_watchdog_flags_stragglers():
    wd = tt.StepWatchdog(window=20, threshold=2.0)
    for i in range(15):
        wd.observe(i, 0.1)
    wd.observe(15, 0.5)
    wd.observe(16, 0.1)
    assert len(wd.events) == 1 and wd.events[0].step == 15


def test_run_training_puts_the_sigterm_handler_back(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    tt.run_training(CFG, tt.TrainConfig(
        steps=1, log_every=100, checkpoint_dir=str(tmp_path), remat=False),
        DataConfig(batch=2, seq_len=8), device="cpu")
    assert signal.getsignal(signal.SIGTERM) is before


# ---------------------------------------------------------------------------
# the chunk-256 SSD gradient
# ---------------------------------------------------------------------------

def _decaying_scan_inputs():
    """One 256-row chunk with dt 0.1 and A in {-4, -16}: a decay sum of up
    to 0.1 * 16 * 255 = 408 above the diagonal, past f32's exp limit."""
    rng = np.random.default_rng(0)
    b, nh, l, hp, n = 1, 2, 256, 8, 8
    dt = np.full((b, l, nh), 0.1, np.float32)
    A = np.array([-4.0, -16.0], np.float32)
    x = (0.5 * rng.standard_normal((b, l, nh, hp))).astype(np.float32)
    B = (0.5 * rng.standard_normal((b, l, n))).astype(np.float32)
    C = (0.5 * rng.standard_normal((b, l, n))).astype(np.float32)
    return x, dt, A, B, C


def test_ssd_scan_ref_chunk_256_forward_exact_and_grads_finite(monkeypatch):
    x, dt, A, B, C = _decaying_scan_inputs()
    dtx = torch.from_numpy(np.moveaxis(dt[..., None] * x, 1, 2).copy())
    lt = torch.from_numpy(np.moveaxis(dt * A, 1, 2).copy())
    Bt, Ct = torch.from_numpy(B), torch.from_numpy(C)

    def run():
        d, g = dtx.clone().requires_grad_(True), lt.clone().requires_grad_(
            True)
        y, state = ssd_mod.ssd_scan_ref(d, g, Bt, Ct, chunk=256)
        grads = torch.autograd.grad((y.sum() + state.sum()), (d, g))
        return y.detach(), state.detach(), grads

    y, state, grads = run()
    assert all(torch.isfinite(g).all() for g in grads)
    monkeypatch.setattr(ssd_mod, "segment_decay",
                        lambda seg, mask: torch.where(mask, torch.exp(seg),
                                                      torch.zeros(())))
    y_old, state_old, grads_old = run()
    assert torch.equal(y, y_old) and torch.equal(state, state_old)
    assert not torch.isfinite(grads_old[1]).all()   # the where-after-exp NaN


@pytest.mark.xfail(strict=True, reason="the reference's _ssd_chunked masks "
                   "after the exp: its gradient is NaN past a decay sum of "
                   "88.7 (ROADMAP queue 3)")
def test_reference_ssd_chunked_grad_is_finite_at_chunk_256():
    x, dt, A, B, C = _decaying_scan_inputs()

    def f(dt):
        y, state = jssm._ssd_chunked(jnp.asarray(x), dt, jnp.asarray(A),
                                     jnp.asarray(B), jnp.asarray(C), 256)
        return jnp.sum(y) + jnp.sum(state)

    g = jax.grad(f)(jnp.asarray(dt))
    assert bool(jnp.all(jnp.isfinite(g)))


def test_mamba2_train_path_takes_the_plain_scan(monkeypatch):
    cfg = get_config("mamba2-1.3b-smoke")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))

    def refuse(*a, **k):
        raise AssertionError("the train path reached the ssd_scan wrapper")

    monkeypatch.setattr(tm.ssm, "ssd_scan", refuse)
    batch = to_device(make_batch(cfg, DataConfig(batch=2, seq_len=64), 0),
                      "cpu")
    loss, _ = tm.forward_train(cfg, params, batch)
    assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# the kernel wrappers refuse autograd
# ---------------------------------------------------------------------------

def _wrapper_calls():
    f32 = torch.float32
    q = torch.randn(2, 1, 2, 16)
    kv = torch.randn(2, 8, 1, 16)
    lens = torch.tensor([3, 8], dtype=torch.int32)
    pages = torch.randn(5, 4, 1, 16)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    return {
        "fc_gemv": lambda g: fc_mod.fc_gemv(
            torch.randn(2, 8, requires_grad=g), torch.randn(8, 4)),
        "decode_attention": lambda g: attn_mod.decode_attention(
            q.clone().requires_grad_(g), kv, kv, lens),
        "paged_decode_attention": lambda g: paged_mod.paged_decode_attention(
            q.clone().requires_grad_(g), pages, pages, lens, tables),
        "ssd_scan": lambda g: ssd_mod.ssd_scan(
            torch.randn(1, 2, 8, 4, requires_grad=g),
            -torch.rand(1, 2, 8, dtype=f32), torch.randn(1, 8, 4),
            torch.randn(1, 8, 4), chunk=4),
    }


@pytest.mark.parametrize("name", ["fc_gemv", "decode_attention",
                                  "paged_decode_attention", "ssd_scan"])
def test_kernel_wrappers_refuse_autograd(name):
    call = _wrapper_calls()[name]
    with pytest.raises(RuntimeError, match=f"{name} has no backward"):
        call(True)
    call(False)                          # no grad asked: the plain version
    with torch.no_grad():
        call(True)                       # grad mode off: allowed


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b-smoke", "hubert-xlarge-smoke"])
def test_launcher_trains_on_the_cpu(tmp_path, capsys, arch):
    train_cli.main(["--arch", arch, "--steps", "4", "--batch", "2",
                    "--seq-len", "16", "--device", "cpu",
                    "--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "done: 4 steps, final loss" in out
    assert tt.CheckpointManager(str(tmp_path)).all_steps() == [4]
    train_cli.main(["--arch", arch, "--steps", "6", "--batch", "2",
                    "--seq-len", "16", "--device", "cpu", "--resume",
                    "--checkpoint-dir", str(tmp_path)])
    assert "done: 6 steps" in capsys.readouterr().out


def test_launcher_without_device_raises_on_a_cpu_only_host(monkeypatch,
                                                            tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "qwen2-0.5b-smoke", "--steps", "1",
                        "--checkpoint-dir", str(tmp_path)])
