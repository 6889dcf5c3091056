"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions
(`fc_gemv_ref`, `decode_attention_ref`); these are held against the Pallas
kernels run in interpret mode on the same numpy inputs (f32, rtol/atol
2e-5 as in tests/test_kernels.py; the paged plain version is held against
the Pallas paged kernel in tests/test_torch_paged.py, and `ssd_scan_ref`
against the Pallas `ssd_scan` in tests/test_torch_ssm.py).  The CUDA
kernels themselves need the card: those cases are marked ``gpu`` and skip
here: `fc_gemv`'s (against its plain version at the served models'
widths and ragged ones for m in 1, 8, 13, 64, a weight at an odd offset,
a grouped launch bit-equal to single launches and to itself, one launch
per call), the paged kernel's (against its plain version, bit-equal
to the dense kernel, blind to table entries past each length), the
split-S cases of both attention kernels (lens at tile and split edges, a
2048-token request, one split, windows whose last split is masked for the
early rows, g = 1 at every head dim, two calls bit-equal) and
`ssd_scan`'s (against its plain version at the smoke shapes and at
mamba2-1.3b's and zamba2-1.2b's (hp, n) over two and three 256-row chunks,
1e-4 in f32 and 5e-2 in bf16 as in tests/test_kernels.py, the state at
1e-4; two calls bit-equal, two CUDA launches a call), and the speculative
verify window's shapes (both attention kernels at q_rows = 4, the paged
one bit-equal to the dense one, and `fc_gemv_group` at m = 32 over
qwen2-0.5b's projection groups).  The planners (the
attention kernels' split count, `fc_gemv`'s K split and column tile) are
pure Python and are held here on the CPU.  JAX is imported only
by the cases that need it, so the ``gpu`` cases also run where the card
is and JAX is not:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as attn_mod  # noqa: E402
from repro_torch.kernels import fc_gemv as fc_mod  # noqa: E402
from repro_torch.kernels import paged_decode_attention as paged_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402

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


@pytest.mark.parametrize("m,K,ns", [(8, 96, [40, 24, 8]), (13, 100, [37]),
                                    (3, 129, [24, 40]), (1, 40, [16, 8, 24])])
def test_fc_gemv_group_matches_pallas_per_weight(pallas, m, K, ns):
    jnp, jax_fc, _ = pallas
    rng = np.random.default_rng(m * 1000 + K + sum(ns))
    x = rng.standard_normal((m, K)).astype(np.float32)
    ws = [(rng.standard_normal((K, n)) / np.sqrt(K)).astype(np.float32)
          for n in ns]
    got = fc_mod.fc_gemv_group(torch.from_numpy(x),
                               [torch.from_numpy(w) for w in ws])
    for y, w in zip(got, ws):
        want = np.asarray(jax_fc(jnp.asarray(x), jnp.asarray(w),
                                 interpret=True))
        np.testing.assert_allclose(y.numpy(), want, **TOL)


def test_fc_gemv_group_cpu_takes_plain_version_without_launch():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    ws = [torch.from_numpy(rng.standard_normal((64, n)).astype(np.float32))
          for n in (32, 8, 8)]
    before = fc_mod.LAUNCHES
    out = fc_mod.fc_gemv_group(x, ws)
    assert fc_mod.LAUNCHES == before
    assert len(out) == 3
    for y, w in zip(out, ws):
        assert torch.equal(y, fc_mod.fc_gemv_ref(x, w))


def test_fc_gemv_group_rejects_bad_groups():
    x = torch.zeros(2, 8)
    w = torch.zeros(8, 4)
    with pytest.raises(ValueError):                       # unequal K
        fc_mod.fc_gemv_group(x, [w, torch.zeros(9, 4)])
    with pytest.raises(TypeError):                        # unequal dtypes
        fc_mod.fc_gemv_group(x, [w, w.to(torch.bfloat16)])
    with pytest.raises(ValueError):                       # unequal devices
        fc_mod.fc_gemv_group(x, [w, torch.zeros(8, 4, device="meta")])
    with pytest.raises(ValueError):                       # too many weights
        fc_mod.fc_gemv_group(x, [w] * (fc_mod.WEIGHTS_MAX + 1))
    with pytest.raises(ValueError):                       # none
        fc_mod.fc_gemv_group(x, [])


@pytest.mark.parametrize("variant", ["pu", "pim"])
def test_papi_linear_group_equals_separate_calls(variant):
    from repro_torch.models.linear import (fc_variant, papi_linear,
                                           papi_linear_group)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 3, 48)).astype(np.float32))
    ws = [torch.from_numpy(rng.standard_normal((48, n)).astype(np.float32))
          for n in (48, 16, 16)]
    with fc_variant(variant):
        got = papi_linear_group(x, ws)
        want = [papi_linear(x, w) for w in ws]
    for y, z, w in zip(got, want, ws):
        assert y.shape == (2, 3, w.shape[1])
        assert torch.equal(y, z)


@pytest.mark.parametrize("K", [1, 96, 128, 129, 896, 2048, 4864, 8192])
def test_fc_gemv_plan_splits_k_by_k_alone(K):
    cluster, k_slice = fc_mod.k_split(K)
    assert 1 <= cluster <= fc_mod.CLUSTER_MAX
    assert k_slice % 16 == 0
    # the slices cover K exactly and none is empty
    assert (cluster - 1) * k_slice < K <= cluster * k_slice
    # the same split at any N, group, SM count; m is not an input at all
    groups = [[1], [37], [896], [896, 128, 128], [4864, 4864], [2048] * 3]
    for ns in groups:
        for sms in (1, 114, 132):
            p = fc_mod.plan(K, ns, sms)
            assert (p.cluster, p.k_slice) == (cluster, k_slice)
            assert p.col_tile in fc_mod.COL_TILES
    assert "m" not in inspect.signature(fc_mod.plan).parameters
    # every block of every tile, at every m, fits the shared memory
    for dtype in (torch.float32, torch.bfloat16):
        for tile in fc_mod.COL_TILES:
            for m in (1, 8, 13, 64, 65, 512):
                rows = fc_mod.m_rows(m)
                assert rows % 8 == 0 and 8 <= rows <= fc_mod.M_ROWS_MAX
                assert fc_mod.smem_bytes(tile, rows, dtype) <= fc_mod.SMEM_MAX


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
# the attention kernels' split planner (shapes only, so it runs here)
# ---------------------------------------------------------------------------

def test_split_planner_takes_shapes_only():
    """NS may not depend on lens (a device->host copy) nor on the KV
    capacity (dense and paged would split apart): the planner's inputs are
    the shapes and the SM count, and both wrappers take the same plan."""
    assert list(inspect.signature(attn_mod.num_splits).parameters) == [
        "b", "nkv", "rows", "sms"]
    for name in ("num_splits", "row_tile", "sm_count", "split_scratch"):
        assert getattr(paged_mod, name) is getattr(attn_mod, name)


@pytest.mark.parametrize("rows,tile", [(1, 4), (4, 4), (5, 8), (7, 8),
                                       (8, 8), (9, 16), (16, 16), (448, 16)])
def test_row_tile_fits_the_rows(rows, tile):
    """f32 (CUDA cores) fits the tile to the rows; bf16 (tensor cores)
    always takes the mma's 16 rows."""
    assert attn_mod.row_tile(rows, torch.float32) == tile
    assert attn_mod.row_tile(rows, torch.bfloat16) == 16


@pytest.mark.parametrize("b,nkv,rows,sms,want", [
    (8, 2, 7, 132, 17),        # qwen2-0.5b decode, t=1, g=7
    (8, 2, 448, 132, 4),       # qwen2-0.5b chunk wave, t=64: the floor
    (8, 32, 1, 132, 4),        # zamba2-1.2b shared block, g=1
    (1, 1, 1, 132, 32),        # one row of one request: the ceiling
    (64, 32, 448, 132, 1),     # the scratch cap leaves one split
])
def test_num_splits_at_known_shapes(b, nkv, rows, sms, want):
    assert attn_mod.num_splits(b, nkv, rows, sms) == want


@pytest.mark.parametrize("rows", [1, 7, 16, 448, 4096])
def test_num_splits_bounds(rows):
    """Over batches, KV heads and SM counts: 1 <= NS <= SPLITS_MAX, the
    partials within SCRATCH_CAP, and, where the cap allows, at least
    SPLITS_MIN splits and enough blocks for WAVES waves unless capped."""
    for b in (1, 3, 8, 64):
        for nkv in (1, 2, 32):
            for sms in (1, 114, 132):
                ns = attn_mod.num_splits(b, nkv, rows, sms)
                per_split = b * nkv * rows * (max(attn_mod.HEAD_DIMS) + 2) * 4
                capped = attn_mod.SCRATCH_CAP // per_split
                assert 1 <= ns <= attn_mod.SPLITS_MAX
                assert ns == 1 or ns * per_split <= attn_mod.SCRATCH_CAP
                if capped >= attn_mod.SPLITS_MIN:
                    assert ns >= attn_mod.SPLITS_MIN
                    blocks = b * nkv * -(-rows // 16)
                    assert (ns == min(attn_mod.SPLITS_MAX, capped)
                            or blocks * ns >= attn_mod.WAVES * sms)
                assert attn_mod.cuda_launches(ns) == (1 if ns == 1 else 2)


def test_split_scratch_holds_acc_m_and_l():
    q = torch.zeros(8, 2, 7, 64)
    assert attn_mod.split_scratch(q, 1) is None
    part = attn_mod.split_scratch(q, 17)
    assert part.dtype == torch.float32 and part.numel() == 8 * 2 * 17 * 7 * 66


def test_attention_cpu_path_takes_plain_versions_without_planning(
        monkeypatch):
    """A 2048-token request, where the card would split: on the CPU both
    wrappers take their plain versions, ask nothing of the card (the SM
    count would need one) and count no launch."""
    def no_card(index):
        raise AssertionError("the CPU path asked for the SM count")
    monkeypatch.setattr(attn_mod, "_sm_count", no_card)
    q, k, v, ln = _attn_inputs(4, 3, 2, 7, 64, 2048, 1, [2048, 1, 33])
    args = [torch.from_numpy(a) for a in (q, k, v, ln)]
    tables = torch.arange(3 * 128, dtype=torch.int32).reshape(3, 128)
    pages = [a.reshape(3 * 128, 16, 2, 64) for a in args[1:3]]
    dense, paged = attn_mod.LAUNCHES, paged_mod.LAUNCHES
    got = attn_mod.decode_attention(*args)
    got_p = paged_mod.paged_decode_attention(args[0], *pages, args[3], tables)
    assert (attn_mod.LAUNCHES, paged_mod.LAUNCHES) == (dense, paged)
    assert torch.equal(got, attn_mod.decode_attention_ref(*args))
    assert torch.equal(got_p, paged_mod.paged_decode_attention_ref(
        args[0], *pages, args[3], tables))


# ---------------------------------------------------------------------------
# the CUDA kernels (card only)
# ---------------------------------------------------------------------------

# (K, N) of qwen2-0.5b's and zamba2-1.2b's projections, and ragged ones
FC_KERNEL_SHAPES = [(896, 896), (896, 128), (896, 4864), (4864, 896),
                    (2048, 2048), (2048, 8192), (8192, 2048),
                    (100, 37), (129, 64), (1, 40), (129, 37),
                    (1000, 200), (5000, 37)]       # clusters of 4 and 8,
                                                   # the last slice short


def _fc_on_card(cuda, dt, m, K, ns, seed, offset=0):
    """x [m, K] and weights [K, n] on the card; `offset` > 0 makes each
    weight a view that starts `offset` elements into its storage."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(m, K, generator=gen, device=cuda).to(dt)
    ws = []
    for n in ns:
        flat = (torch.randn(K * n + offset, generator=gen, device=cuda)
                / K ** 0.5).to(dt)
        ws.append(flat[offset:].view(K, n))
    return x, ws


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("m", [1, 8, 13, 64, 130])     # 130: three passes
@pytest.mark.parametrize("K,N", FC_KERNEL_SHAPES)
def test_fc_gemv_kernel_matches_plain(cuda, m, K, N, dtype, tol):
    dt = getattr(torch, dtype)
    x, (w,) = _fc_on_card(cuda, dt, m, K, [N], m + K + N)
    before = fc_mod.LAUNCHES
    got = fc_mod.fc_gemv(x, w)
    torch.cuda.synchronize()
    assert fc_mod.LAUNCHES == before + 1
    torch.testing.assert_close(got.float(), fc_mod.fc_gemv_ref(x, w).float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("m,K,N", [(8, 896, 896), (13, 100, 37), (1, 129, 64)])
def test_fc_gemv_kernel_weight_at_odd_offset(cuda, m, K, N, dtype, tol):
    """A weight whose rows are not 16-byte aligned takes the element path
    and gives the bits of an aligned copy."""
    dt = getattr(torch, dtype)
    x, (w,) = _fc_on_card(cuda, dt, m, K, [N], 3 * m + K, offset=1)
    got = fc_mod.fc_gemv(x, w)
    aligned = fc_mod.fc_gemv(x, w.clone())
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), fc_mod.fc_gemv_ref(x, w).float(),
                               rtol=tol, atol=tol)
    assert torch.equal(got, aligned)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 8, 13, 64])
@pytest.mark.parametrize("K,ns", [(896, [896, 128, 128]), (896, [4864, 4864]),
                                  (2048, [2048, 2048, 2048]),
                                  (100, [37, 64])])
def test_fc_gemv_group_bit_equal_to_single_launches(cuda, K, ns, m, dtype):
    dt = getattr(torch, dtype)
    x, ws = _fc_on_card(cuda, dt, m, K, ns, K + m)
    before = fc_mod.LAUNCHES
    group = fc_mod.fc_gemv_group(x, ws)
    torch.cuda.synchronize()
    assert fc_mod.LAUNCHES == before + 1
    singles = [fc_mod.fc_gemv(x, w) for w in ws]
    again = fc_mod.fc_gemv_group(x, ws)
    torch.cuda.synchronize()
    assert fc_mod.LAUNCHES == before + 2 + len(ws)
    for y, z, u in zip(group, singles, again):
        assert torch.equal(y, z) and torch.equal(y, u)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fc_gemv_rows_do_not_change_a_row(cuda, dtype):
    """A column's sum does not depend on m: row i of a 64-row call equals
    the same row sent alone."""
    dt = getattr(torch, dtype)
    x, (w,) = _fc_on_card(cuda, dt, 64, 896, [4864], 11)
    full = fc_mod.fc_gemv(x, w)
    for i in (0, 7, 8, 63):
        assert torch.equal(full[i:i + 1], fc_mod.fc_gemv(x[i:i + 1], w))


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


def _edge_lens(ns, S, b):
    """Lens at tile and split edges for a call with `ns` splits: 0, 1,
    a tile -1/0/+1, ns tiles -1/0/+1 (one tile per split, and one split
    longer by a tile), a 2048-token request (S >= 2048) and the capacity.
    Below t, a window's early rows see no position at all (zeros)."""
    tile = 32
    lens = [0, 1, tile - 1, tile, tile + 1, ns * tile - 1, ns * tile,
            ns * tile + 1, min(2048, S), S]
    return [min(n, S) for n in lens][:b]


def _masked_last_split_len(ns, t, S):
    """A length whose last split starts at or past the window's row 0 limit
    (len - (t - 1)), so the early rows see nothing in that split; longer
    than ns tiles, so every split holds one."""
    for n in range(ns * 32 + 1, S + 1):
        nkb = -(-n // 32)
        first = (ns - 1) * nkb // ns * 32
        if (ns - 1) * nkb // ns < nkb and first >= n - (t - 1):
            return n
    raise AssertionError("no such length")


def _dense_on_card(cuda, dtype, t, lens, seed, nkv=2, g=7, hd=64, S=2048):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    b = len(lens)
    q = torch.randn(b, nkv, t * g, hd, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, S, nkv, hd, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, S, nkv, hd, generator=gen, device=cuda).to(dtype)
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=cuda)


def _to_pages(k, v, page, gen_seed, cuda):
    """The dense slab [b, S, nkv, hd] laid out on shuffled pages (S a
    multiple of `page`), page 0 left as the garbage page."""
    b, S, nkv, hd = k.shape
    nblk = S // page
    gen = torch.Generator(device=cuda).manual_seed(gen_seed)
    perm = torch.randperm(b * nblk, generator=gen, device=cuda) + 1
    tables = perm.reshape(b, nblk).to(torch.int32).contiguous()
    kp = torch.zeros(b * nblk + 1, page, nkv, hd, dtype=k.dtype, device=cuda)
    vp = torch.zeros_like(kp)
    kp[tables.long()] = k.reshape(b, nblk, page, nkv, hd)
    vp[tables.long()] = v.reshape(b, nblk, page, nkv, hd)
    return kp, vp, tables


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("t", [1, 64])
def test_attention_kernels_at_tile_and_split_edges(cuda, t, dtype, tol):
    """Lens at tile and split edges, a 2048-token request and the capacity
    (S = 2048), qwen2's geometry: both kernels against the plain version,
    paged (page 16) bit-equal to dense, lens == 0 zeros, one count each."""
    b, S = 10, 2048
    ns = attn_mod.num_splits(b, 2, t * 7, attn_mod.sm_count(cuda))
    assert ns > 1
    lens = _edge_lens(ns, S, b)
    q, k, v, ln = _dense_on_card(cuda, getattr(torch, dtype), t, lens, t)
    kp, vp, tables = _to_pages(k, v, 16, t, cuda)
    before = (attn_mod.LAUNCHES, paged_mod.LAUNCHES)
    got = attn_mod.decode_attention(q, k, v, ln, q_rows=t)
    got_p = paged_mod.paged_decode_attention(q, kp, vp, ln, tables, q_rows=t)
    torch.cuda.synchronize()
    assert (attn_mod.LAUNCHES, paged_mod.LAUNCHES) == (before[0] + 1,
                                                       before[1] + 1)
    torch.testing.assert_close(
        got.float(), attn_mod.decode_attention_ref(q, k, v, ln, t).float(),
        rtol=tol, atol=tol)
    assert torch.equal(got_p, got)
    assert bool((got[0] == 0).all()) and bool(torch.isfinite(got).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_attention_kernels_last_split_masked_for_early_rows(cuda, dtype,
                                                            tol):
    """A t=64 window whose last split lies past the early rows' limit: that
    split must carry zero weight for them (no stray p = 1 from an all-masked
    tile), and the late rows still see it."""
    t, S = 64, 2048
    ns = attn_mod.num_splits(4, 2, t * 7, attn_mod.sm_count(cuda))
    n = _masked_last_split_len(ns, t, S)
    lens = [n, 2048, n + 32, 0]
    q, k, v, ln = _dense_on_card(cuda, getattr(torch, dtype), t, lens, 11)
    got = attn_mod.decode_attention(q, k, v, ln, q_rows=t)
    kp, vp, tables = _to_pages(k, v, 32, 11, cuda)
    got_p = paged_mod.paged_decode_attention(q, kp, vp, ln, tables, q_rows=t)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got.float(), attn_mod.decode_attention_ref(q, k, v, ln, t).float(),
        rtol=tol, atol=tol)
    assert torch.equal(got_p, got) and bool((got[3] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("t", [1, 64])
def test_attention_kernels_one_split(cuda, monkeypatch, t, dtype, tol):
    """NS = 1 (the scratch cap forced to 0): the split pass writes the
    output itself, one CUDA launch; it holds the plain version and is close
    to the split result."""
    lens = [1, 33, 700, 2048, 0, 64, 65, 500]
    q, k, v, ln = _dense_on_card(cuda, getattr(torch, dtype), t,
                                 [max(n, t) if n else 0 for n in lens], 5)
    split = attn_mod.decode_attention(q, k, v, ln, q_rows=t)
    monkeypatch.setattr(attn_mod, "SCRATCH_CAP", 0)
    assert attn_mod.num_splits(8, 2, t * 7, attn_mod.sm_count(cuda)) == 1
    assert attn_mod.split_scratch(q, 1) is None
    one = attn_mod.decode_attention(q, k, v, ln, q_rows=t)
    kp, vp, tables = _to_pages(k, v, 16, 5, cuda)
    one_p = paged_mod.paged_decode_attention(q, kp, vp, ln, tables, q_rows=t)
    torch.cuda.synchronize()
    want = attn_mod.decode_attention_ref(q, k, v, ln, t).float()
    torch.testing.assert_close(one.float(), want, rtol=tol, atol=tol)
    torch.testing.assert_close(one.float(), split.float(), rtol=tol, atol=tol)
    assert torch.equal(one_p, one) and bool((one[4] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_attention_kernels_mha_g1(cuda, hd, dtype, tol):
    """zamba2-1.2b's shared block: g = 1, nkv = 32 (in f32 the 4-row
    tile), at every head dim the kernels are built for."""
    lens = [1, 12, 33, 512, 100, 300, 576, 0]
    q, k, v, ln = _dense_on_card(cuda, getattr(torch, dtype), 1, lens, hd,
                                 nkv=32, g=1, hd=hd, S=1024)
    got = attn_mod.decode_attention(q, k, v, ln)
    kp, vp, tables = _to_pages(k, v, 16, hd, cuda)
    got_p = paged_mod.paged_decode_attention(q, kp, vp, ln, tables)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got.float(), attn_mod.decode_attention_ref(q, k, v, ln).float(),
        rtol=tol, atol=tol)
    assert torch.equal(got_p, got) and bool((got[7] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("t", [1, 3, 64])
def test_attention_kernels_other_head_dims(cuda, t, hd, dtype, tol):
    """GQA (g = 7) at head dims 32 and 128, a 2048-token request."""
    lens = [t, 2048, 300, 33]
    q, k, v, ln = _dense_on_card(cuda, getattr(torch, dtype), t, lens, t + hd,
                                 hd=hd)
    got = attn_mod.decode_attention(q, k, v, ln, q_rows=t)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got.float(), attn_mod.decode_attention_ref(q, k, v, ln, t).float(),
        rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 64])
def test_attention_kernels_are_deterministic(cuda, t):
    """The merge adds the splits in split order, without atomics: two calls
    on the same inputs give the same bits, dense and paged."""
    lens = [t, 2048, 1000, 513, 64, 65, 200, 7]
    q, k, v, ln = _dense_on_card(cuda, torch.bfloat16, t,
                                 [max(n, t) for n in lens], 21)
    kp, vp, tables = _to_pages(k, v, 16, 21, cuda)
    a = attn_mod.decode_attention(q, k, v, ln, q_rows=t)
    b = attn_mod.decode_attention(q, k, v, ln, q_rows=t)
    pa = paged_mod.paged_decode_attention(q, kp, vp, ln, tables, q_rows=t)
    pb = paged_mod.paged_decode_attention(q, kp, vp, ln, tables, q_rows=t)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(pa, pb) and torch.equal(pa, a)


@pytest.mark.gpu
@pytest.mark.parametrize("page", [7, 16, 32])
@pytest.mark.parametrize("t", [1, 64])
def test_paged_kernel_split_edges_bit_equal_and_blind(cuda, t, page):
    """Split-edge lens and a 2048-token request over pages of 7, 16 and 32
    positions: bit-equal to the dense kernel over the gathered slab, and
    unchanged when every table entry past a length names the NaN-poisoned
    garbage page."""
    b = 10
    ns = attn_mod.num_splits(b, 2, t * 7, attn_mod.sm_count(cuda))
    lens = _edge_lens(ns, 2048, b)
    gen = torch.Generator(device=cuda).manual_seed(page + t)
    nblk = -(-2048 // page)
    kp = torch.randn(b * nblk + 1, page, 2, 64, generator=gen,
                     device=cuda).to(torch.bfloat16)
    vp = torch.randn_like(kp)
    perm = torch.randperm(b * nblk, generator=gen, device=cuda) + 1
    tables = perm.reshape(b, nblk).to(torch.int32).contiguous()
    q = torch.randn(b, 2, t * 7, 64, generator=gen,
                    device=cuda).to(torch.bfloat16)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = paged_mod.paged_decode_attention(q, kp, vp, ln, tables, q_rows=t)
    dense = attn_mod.decode_attention(
        q, paged_mod.gather_kv_pages(kp, tables).contiguous(),
        paged_mod.gather_kv_pages(vp, tables).contiguous(), ln, q_rows=t)
    scrubbed = tables.clone()
    for i, n in enumerate(lens):
        scrubbed[i, -(-n // page):] = 0
    kp[0] = float("nan")
    vp[0] = float("nan")
    blind = paged_mod.paged_decode_attention(q, kp, vp, ln, scrubbed,
                                             q_rows=t)
    torch.cuda.synchronize()
    assert torch.equal(got, dense)
    assert torch.equal(blind, got)
    assert bool((got[0] == 0).all()) and bool(torch.isfinite(got).all())


def _ssd_on_card(cuda, b, nh, l, hp, n, x_dtype, bc_dtype, seed,
                 slow=False):
    """dtx, lt, B, C and an initial state on the card.  Decays as
    tests/test_kernels.py makes them (A in [-7.4, -1]), or with `slow` the
    model's init laws (dt ~ logU[1e-3, 0.1], A in [-16, -1]), under which
    the state carries across chunks."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    dtx = (0.5 * torch.randn(b, nh, l, hp, generator=gen,
                             device=cuda)).to(x_dtype)
    if slow:
        u = torch.rand(b, nh, l, generator=gen, device=cuda)
        dt = torch.exp(np.log(1e-3) + (np.log(0.1) - np.log(1e-3)) * u)
        A = -(1.0 + 15.0 * torch.rand(nh, generator=gen, device=cuda))
    else:
        dt = torch.nn.functional.softplus(
            torch.randn(b, nh, l, generator=gen, device=cuda) - 1.0)
        A = -torch.exp(2.0 * torch.rand(nh, generator=gen, device=cuda))
    lt = (dt * A[None, :, None]).contiguous()
    B = (0.5 * torch.randn(b, l, n, generator=gen, device=cuda)).to(bc_dtype)
    C = (0.5 * torch.randn(b, l, n, generator=gen, device=cuda)).to(bc_dtype)
    s0 = 0.5 * torch.randn(b, nh, hp, n, generator=gen, device=cuda)
    return dtx, lt, B, C, s0


# (hp, n, l, chunk): the smoke shapes (two and three chunks, one shorter
# than the chunk size), and mamba2-1.3b's / zamba2-1.2b's (hp, n) at the
# served chunk size, two and three chunks
SSD_KERNEL_CASES = [(32, 16, 64, 32), (32, 16, 96, 32), (32, 16, 20, 32),
                    (64, 64, 512, 256), (64, 64, 768, 256),
                    (64, 128, 512, 256), (64, 128, 768, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes,tol", [
    (("float32", "float32", "float32"), 1e-4),
    (("float32", "bfloat16", "bfloat16"), 5e-2),    # the bf16 model's mix
    (("bfloat16", "bfloat16", "bfloat16"), 5e-2)])
@pytest.mark.parametrize("hp,n,l,chunk", SSD_KERNEL_CASES)
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("slow", [False, True])
def test_ssd_scan_kernel_matches_plain(cuda, hp, n, l, chunk, init, slow,
                                       dtypes, tol):
    """y and the final state against the plain version (the state at 1e-4
    in every mix: it is f32 in both)."""
    x_dt, bc_dt, y_dt = (getattr(torch, d) for d in dtypes)
    dtx, lt, B, C, s0 = _ssd_on_card(cuda, 2, 4, l, hp, n, x_dt, bc_dt,
                                     l + chunk, slow)
    kw = dict(chunk=chunk, init_state=s0 if init else None, out_dtype=y_dt)
    before = ssd_mod.LAUNCHES
    y, state = ssd_mod.ssd_scan(dtx, lt, B, C, **kw)
    torch.cuda.synchronize()
    assert ssd_mod.LAUNCHES == before + 1
    want_y, want_state = ssd_mod.ssd_scan_ref(dtx, lt, B, C, **kw)
    assert y.dtype == y_dt and bool(torch.isfinite(y).all())
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(state, want_state, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", [("float32", "float32", "float32"),
                                    ("float32", "bfloat16", "bfloat16")])
@pytest.mark.parametrize("hp,n", [(64, 64), (64, 128)])
def test_ssd_scan_kernel_is_deterministic(cuda, hp, n, dtypes):
    """Two calls give the same bits of y and of the state, and a call is
    `cuda_launches()` CUDA launches (the C·Bᵀ pass and the scan)."""
    x_dt, bc_dt, y_dt = (getattr(torch, d) for d in dtypes)
    dtx, lt, B, C, s0 = _ssd_on_card(cuda, 2, 8, 768, hp, n, x_dt, bc_dt, 5,
                                     True)
    kw = dict(chunk=256, init_state=s0, out_dtype=y_dt)
    y1, st1 = ssd_mod.ssd_scan(dtx, lt, B, C, **kw)
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        y2, st2 = ssd_mod.ssd_scan(dtx, lt, B, C, **kw)
        torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(st1, st2)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and ("ssd_cb_kernel" in e.name or "ssd_scan_kernel" in e.name)]
    assert len(names) == ssd_mod.cuda_launches() == 2, names


@pytest.mark.parametrize("b,l,cs,want", [(8, 512, 256, (8, 2, 256, 256)),
                                         (2, 768, 256, (2, 3, 256, 256)),
                                         (1, 100, 100, (1, 1, 128, 128)),
                                         (2, 20, 20, (2, 1, 64, 64))])
def test_ssd_cb_scratch_holds_whole_row_tiles(b, l, cs, want):
    """The C·Bᵀ scratch is one f32 [csp, csp] per (batch row, chunk), csp
    the chunk rounded up to the kernels' row tile, whose size the CUDA
    source defines; a call on the card is two CUDA launches."""
    cb = ssd_mod.cb_scratch(b, l, cs, "cpu")
    assert tuple(cb.shape) == want and cb.dtype == torch.float32
    src = (ssd_mod._build.CSRC / "ssd_scan.cu").read_text()
    assert f"#define SSD_RT {ssd_mod.ROW_TILE} " in src
    assert ssd_mod.cuda_launches() == 2


@pytest.mark.gpu
def test_ssd_scan_kernel_rejects_unbuilt_shapes(cuda):
    dtx, lt, B, C, _ = _ssd_on_card(cuda, 1, 2, 32, 48, 16, torch.float32,
                                    torch.float32, 0)
    with pytest.raises(ValueError, match="built for"):
        ssd_mod.ssd_scan(dtx, lt, B, C, chunk=32)


@pytest.mark.gpu
def test_ssd_scan_kernel_raises_on_a_chunk_past_shared_memory(cuda):
    """The launcher sizes the block's shared memory from (hp, n, cs); a
    chunk whose cumsum no longer fits is refused as a launch error, and
    nothing is counted."""
    dtx, lt, B, C, _ = _ssd_on_card(cuda, 1, 1, 65536, 64, 128,
                                    torch.float32, torch.float32, 0)
    before = ssd_mod.LAUNCHES
    with pytest.raises(RuntimeError, match="ssd_scan launch failed"):
        ssd_mod.ssd_scan(dtx, lt, B, C, chunk=65536)
    assert ssd_mod.LAUNCHES == before
    # the refused size leaves no error behind for the next launch
    y, _ = ssd_mod.ssd_scan(dtx[..., :512, :], lt[..., :512].contiguous(),
                            B[:, :512], C[:, :512], chunk=256)
    torch.cuda.synchronize()
    assert ssd_mod.LAUNCHES == before + 1 and bool(torch.isfinite(y).all())


# ---------------------------------------------------------------------------
# the speculative verify window's shapes (spec_len 4 on 8 slots): both
# attention kernels at q_rows = 4 with qwen2-0.5b's geometry, and FC-PIM at
# m = 32 rows over qwen2's projections
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_decode_attention_kernel_at_the_verify_window(cuda, dtype, tol):
    dt = getattr(torch, dtype)
    lens = [4, 5, 36, 100, 513, 1000, 2047, 2048]
    q, k, v, ln = _attn_inputs(17, 8, 2, 7, 64, 2048, 4, lens)
    q, k, v = (torch.from_numpy(a).to(cuda, dt) for a in (q, k, v))
    ln = torch.from_numpy(ln).to(cuda)
    before = attn_mod.LAUNCHES
    got = attn_mod.decode_attention(q, k, v, ln, q_rows=4)
    torch.cuda.synchronize()
    assert attn_mod.LAUNCHES == before + 1
    torch.testing.assert_close(
        got.float(), attn_mod.decode_attention_ref(q, k, v, ln, 4).float(),
        rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("page", [16, 32])
def test_paged_decode_attention_kernel_at_the_verify_window(cuda, page, dtype,
                                                            tol):
    dt = getattr(torch, dtype)
    args = _paged_on_card(cuda, dt, 4, page, 40 + page, max_len=1000)
    before = paged_mod.LAUNCHES
    got = paged_mod.paged_decode_attention(*args, q_rows=4)
    torch.cuda.synchronize()
    assert paged_mod.LAUNCHES == before + 1
    torch.testing.assert_close(
        got.float(), paged_mod.paged_decode_attention_ref(*args, 4).float(),
        rtol=tol, atol=tol)
    k = paged_mod.gather_kv_pages(args[1], args[4]).contiguous()
    v = paged_mod.gather_kv_pages(args[2], args[4]).contiguous()
    assert torch.equal(got, attn_mod.decode_attention(args[0], k, v, args[3],
                                                      q_rows=4))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("K,ns", [(896, [896, 128, 128]), (896, [896]),
                                  (896, [4864, 4864]), (4864, [896])])
def test_fc_gemv_kernel_at_the_verify_window(cuda, K, ns, dtype, tol):
    dt = getattr(torch, dtype)
    x, ws = _fc_on_card(cuda, dt, 32, K, ns, 32 + K)
    before = fc_mod.LAUNCHES
    got = fc_mod.fc_gemv_group(x, ws)
    torch.cuda.synchronize()
    assert fc_mod.LAUNCHES == before + 1
    for y, w in zip(got, ws):
        torch.testing.assert_close(y.float(), fc_mod.fc_gemv_ref(x, w).float(),
                                   rtol=tol, atol=tol)
