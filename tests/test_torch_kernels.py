"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions
(`fc_gemv_ref`, `decode_attention_ref`); these are held against the Pallas
kernels run in interpret mode on the same numpy inputs (f32, rtol/atol
2e-5 as in tests/test_kernels.py; the paged plain version is held against
the Pallas paged kernel in tests/test_torch_paged.py).  The CUDA kernels
themselves need the card: those cases are marked ``gpu`` and skip here,
the paged kernel's among them (against its plain version, bit-equal to the
dense kernel, blind to table entries past each length).  JAX is imported only
by the cases that need it, so the ``gpu`` cases also run where the card
is and JAX is not:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as attn_mod  # noqa: E402
from repro_torch.kernels import fc_gemv as fc_mod  # noqa: E402
from repro_torch.kernels import paged_decode_attention as paged_mod  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def pallas():
    """(jax.numpy, the Pallas fc_gemv, the Pallas decode_attention)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.decode_attention import decode_attention
    from repro.kernels.fc_gemv import fc_gemv
    return jnp, fc_gemv, decode_attention


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# fc_gemv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,K,N", [(1, 128, 256), (4, 128, 64), (8, 256, 128),
                                   (13, 96, 40), (3, 40, 24)])
def test_fc_gemv_ref_matches_pallas(pallas, m, K, N):
    jnp, jax_fc, _ = pallas
    rng = np.random.default_rng(m * 1000 + K + N)
    x = rng.standard_normal((m, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    want = np.asarray(jax_fc(jnp.asarray(x), jnp.asarray(w), interpret=True))
    got = fc_mod.fc_gemv_ref(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fc_gemv_cpu_tensor_takes_plain_version_without_launch():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    before = fc_mod.LAUNCHES
    out = fc_mod.fc_gemv(x, w)
    assert fc_mod.LAUNCHES == before
    assert torch.equal(out, fc_mod.fc_gemv_ref(x, w))


def test_fc_gemv_rejects_bad_inputs():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        fc_mod.fc_gemv(x, torch.zeros(4, 3))
    with pytest.raises(TypeError):
        fc_mod.fc_gemv(x, torch.zeros(8, 3, dtype=torch.float64))


@pytest.mark.parametrize("K", [896, 4864, 96, 128, 129, 1])
def test_fc_gemv_k_split_covers_k_within_shared_memory(K):
    ks = fc_mod.k_split_for(K)
    splits = -(-K // ks)
    assert 1 <= ks <= fc_mod.KS_MAX
    assert (splits - 1) * ks < K <= splits * ks


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

def _attn_inputs(seed, b, nkv, g, hd, skv, t, lens):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nkv, t * g, hd)).astype(np.float32)
    k = rng.standard_normal((b, skv, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, skv, nkv, hd)).astype(np.float32)
    return q, k, v, np.asarray(lens, np.int32)


@pytest.mark.parametrize("block_skip", [True, False])
@pytest.mark.parametrize("q_rows", [1, 3])
@pytest.mark.parametrize("b,nkv,g,hd,skv,block_k", [
    (4, 2, 7, 64, 256, 128),    # qwen2's GQA ratio and head dim
    (3, 1, 4, 32, 128, 64),
])
def test_decode_attention_ref_matches_pallas(pallas, b, nkv, g, hd, skv,
                                             block_k, q_rows, block_skip):
    jnp, _, jax_attn = pallas
    lens = [q_rows, block_k, block_k + 1, skv][:b]
    q, k, v, ln = _attn_inputs(b + skv, b, nkv, g, hd, skv, q_rows, lens)
    want = np.asarray(jax_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(ln), block_k=block_k,
                               interpret=True, block_skip=block_skip,
                               q_rows=q_rows))
    got = attn_mod.decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(ln), q_rows)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_decode_attention_cpu_wrapper_and_zero_length():
    q, k, v, ln = _attn_inputs(1, 3, 2, 7, 32, 64, 1, [0, 5, 64])
    args = [torch.from_numpy(a) for a in (q, k, v, ln)]
    before = attn_mod.LAUNCHES
    out = attn_mod.decode_attention(*args)
    assert attn_mod.LAUNCHES == before
    assert torch.equal(out, attn_mod.decode_attention_ref(*args))
    assert bool((out[0] == 0).all())          # lens == 0 -> zeros
    assert bool(torch.isfinite(out).all())


def test_decode_attention_masks_past_the_window_row():
    """Row r of a t-row window sees nothing past its own position."""
    t, g = 3, 2
    q, k, v, ln = _attn_inputs(2, 1, 1, g, 32, 64, t, [40])
    base = attn_mod.decode_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(ln), t)
    for r in range(t):
        k2, v2 = k.copy(), v.copy()
        k2[:, 40 - t + r + 1:] = 999.0
        v2[:, 40 - t + r + 1:] = -999.0
        out = attn_mod.decode_attention_ref(
            torch.from_numpy(q), torch.from_numpy(k2), torch.from_numpy(v2),
            torch.from_numpy(ln), t)
        assert torch.equal(out[:, :, :(r + 1) * g], base[:, :, :(r + 1) * g])


# ---------------------------------------------------------------------------
# the CUDA kernels (card only)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("m,K,N", [(1, 896, 896), (8, 896, 128),
                                   (13, 4864, 896), (5, 100, 37)])
def test_fc_gemv_kernel_matches_plain(cuda, m, K, N, dtype, tol):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(m + K + N)
    x = torch.randn(m, K, generator=gen, device=cuda).to(dt)
    w = (torch.randn(K, N, generator=gen, device=cuda) / K ** 0.5).to(dt)
    before = fc_mod.LAUNCHES
    got = fc_mod.fc_gemv(x, w)
    torch.cuda.synchronize()
    assert fc_mod.LAUNCHES == before + 1
    torch.testing.assert_close(got.float(), fc_mod.fc_gemv_ref(x, w).float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("t,lens", [(1, [1, 32, 33, 256]),
                                    (3, [3, 40, 100, 256])])
def test_decode_attention_kernel_matches_plain(cuda, t, lens, dtype, tol):
    dt = getattr(torch, dtype)
    q, k, v, ln = _attn_inputs(7, 4, 2, 7, 64, 256, t, lens)
    q, k, v = (torch.from_numpy(a).to(cuda, dt) for a in (q, k, v))
    ln = torch.from_numpy(ln).to(cuda)
    before = attn_mod.LAUNCHES
    got = attn_mod.decode_attention(q, k, v, ln, q_rows=t)
    torch.cuda.synchronize()
    assert attn_mod.LAUNCHES == before + 1
    torch.testing.assert_close(
        got.float(), attn_mod.decode_attention_ref(q, k, v, ln, t).float(),
        rtol=tol, atol=tol)


def _paged_on_card(cuda, dtype, t, page, seed, b=4, nkv=2, g=7, hd=64,
                   max_len=300):
    """q, a shuffled page pool and tables on the card, with ragged lens
    (one of them 0) that cross page and tile boundaries."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    nblk = -(-max_len // page)
    num_pages = b * nblk + 1
    kp = torch.randn(num_pages, page, nkv, hd, generator=gen,
                     device=cuda).to(dtype)
    vp = torch.randn(num_pages, page, nkv, hd, generator=gen,
                     device=cuda).to(dtype)
    perm = torch.randperm(num_pages - 1, generator=gen, device=cuda) + 1
    tables = perm[:b * nblk].reshape(b, nblk).to(torch.int32).contiguous()
    lens = torch.tensor([t, page + t, max_len, 0][:b], dtype=torch.int32,
                        device=cuda)
    q = torch.randn(b, nkv, t * g, hd, generator=gen, device=cuda).to(dtype)
    return q, kp, vp, lens, tables


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("page", [16, 32])
@pytest.mark.parametrize("t", [1, 64])
def test_paged_decode_attention_kernel_matches_plain(cuda, t, page, dtype,
                                                     tol):
    args = _paged_on_card(cuda, getattr(torch, dtype), t, page, t + page)
    before = paged_mod.LAUNCHES
    got = paged_mod.paged_decode_attention(*args, q_rows=t)
    torch.cuda.synchronize()
    assert paged_mod.LAUNCHES == before + 1
    torch.testing.assert_close(
        got.float(), paged_mod.paged_decode_attention_ref(*args, t).float(),
        rtol=tol, atol=tol)
    assert bool((got[3] == 0).all())             # lens == 0 -> zeros


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page", [16, 32, 7])
@pytest.mark.parametrize("t", [1, 64])
def test_paged_kernel_bit_equal_to_dense_kernel(cuda, t, page, dtype):
    """The same contents laid out as a dense slab: the dense kernel gives
    the same bits (one shared body, the same 32-position tiles)."""
    q, kp, vp, lens, tables = _paged_on_card(cuda, getattr(torch, dtype), t,
                                             page, 3 * t + page)
    k = paged_mod.gather_kv_pages(kp, tables).contiguous()
    v = paged_mod.gather_kv_pages(vp, tables).contiguous()
    got = paged_mod.paged_decode_attention(q, kp, vp, lens, tables, q_rows=t)
    want = attn_mod.decode_attention(q, k, v, lens, q_rows=t)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 64])
def test_paged_kernel_never_reads_table_entries_past_the_length(cuda, t):
    q, kp, vp, lens, tables = _paged_on_card(cuda, torch.bfloat16, t, 16,
                                             5 + t)
    base = paged_mod.paged_decode_attention(q, kp, vp, lens, tables,
                                            q_rows=t)
    scrubbed = tables.clone()
    for i, n in enumerate(lens.tolist()):
        scrubbed[i, -(-n // 16):] = 0             # the garbage page
    kp[0] = float("nan")                          # poison it
    vp[0] = float("nan")
    got = paged_mod.paged_decode_attention(q, kp, vp, lens, scrubbed,
                                           q_rows=t)
    torch.cuda.synchronize()
    assert torch.equal(got, base)
