"""keystone_tpu_torch's int8 quantization and fused int8-dequant matmul
(kernel K4's plain version, which the wrapper takes for a CPU tensor)
against the JAX package's, the Pallas kernel in interpret mode."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.ops import int8_matmul as jmm  # noqa: E402
from keystone_tpu.ops import quantization as jq  # noqa: E402
from keystone_tpu_torch.ops import int8_matmul, quantization  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 8e-3


def _weights(seed, k, n, axis=-1):
    w = np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)
    return w, quantization.quantize_int8(torch.from_numpy(w), channel_axis=axis), jq.quantize_int8(
        jnp.asarray(w), channel_axis=axis
    )


@pytest.mark.parametrize("shape,axis", [((64, 48), -1), ((64, 48), 0), ((3, 5, 7), 1)])
def test_quantize_int8_codes_equal_jax(shape, axis):
    w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    got = quantization.quantize_int8(torch.from_numpy(w), channel_axis=axis)
    want = jq.quantize_int8(jnp.asarray(w), channel_axis=axis)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-7)
    assert got.shape == tuple(shape)
    np.testing.assert_allclose(
        got.dequantize().numpy(), np.asarray(want.dequantize()), rtol=1e-6, atol=1e-7
    )


def test_quantization_error_matches_jax():
    w = np.random.default_rng(2).normal(size=(32, 16)).astype(np.float32)
    assert quantization.quantization_error(w) == pytest.approx(jq.quantization_error(w), rel=1e-6)


@pytest.mark.parametrize("dt,jdt", [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)])
def test_mm_matches_jax(dt, jdt):
    """quantization.mm rounds twice in bf16, as the JAX package's does."""
    _, wt, wj = _weights(3, 96, 40)
    y = np.random.default_rng(4).normal(size=(6, 96)).astype(np.float32)
    got = quantization.mm(torch.from_numpy(y).to(dt), wt, dt)
    want = np.asarray(jq.mm(jnp.asarray(y, jdt), wj, jdt), np.float32)
    assert got.dtype == dt
    tol = F32_TOL if dt == torch.float32 else BF16_TOL
    err = np.abs(got.to(torch.float32).numpy() - want).max()
    assert err <= tol * np.abs(want).max(), err
    # float weights
    w = np.random.default_rng(5).normal(size=(96, 40)).astype(np.float32)
    np.testing.assert_allclose(
        quantization.mm(torch.from_numpy(y), torch.from_numpy(w), torch.float32).numpy(),
        np.asarray(jq.mm(jnp.asarray(y), jnp.asarray(w), jnp.float32)),
        rtol=F32_TOL, atol=F32_TOL,
    )


@pytest.mark.parametrize("m,k,n", [(8, 256, 384), (1, 512, 512), (16, 700, 130), (3, 1000, 300)])
@pytest.mark.parametrize("dt,jdt", [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)])
def test_mm_fused_matches_jax(m, k, n, dt, jdt):
    _, wt, wj = _weights(m + k + n, k, n)
    y = np.random.default_rng(m * k).normal(size=(m, k)).astype(np.float32)
    before = int8_matmul.INT8_MATMUL.launches
    got = int8_matmul.mm_fused(torch.from_numpy(y).to(dt), wt)
    assert int8_matmul.INT8_MATMUL.launches == before
    want = np.asarray(
        jmm.mm_fused(jnp.asarray(y, jdt), wj, block_n=256, block_k=256, interpret=True),
        np.float32,
    )
    assert got.dtype == dt and got.shape == (m, n)
    tol = F32_TOL if dt == torch.float32 else BF16_TOL
    err = np.abs(got.to(torch.float32).numpy() - want).max()
    assert err <= tol * np.abs(want).max(), err


def test_mm_fused_leading_dims():
    _, wt, wj = _weights(6, 128, 96)
    y = np.random.default_rng(7).normal(size=(2, 3, 128)).astype(np.float32)
    got = int8_matmul.mm_fused(torch.from_numpy(y), wt)
    assert got.shape == (2, 3, 96)
    want = np.asarray(jmm.mm_fused(jnp.asarray(y), wj, block_n=128, block_k=128, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_mm_fused_above_256_rows_routes_to_mm():
    """The JAX package's shape rule: past 256 rows mm_fused is
    quantization.mm."""
    _, wt, wj = _weights(8, 128, 96)
    y = np.random.default_rng(9).normal(size=(300, 128)).astype(np.float32)
    got = int8_matmul.mm_fused(torch.from_numpy(y), wt)
    torch.testing.assert_close(got, quantization.mm(torch.from_numpy(y), wt, torch.float32), rtol=0, atol=0)
    want = np.asarray(jmm.mm_fused(jnp.asarray(y), wj, block_n=128, block_k=128, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_mm_fused_rejects_bad_scales_and_shapes():
    _, rows, _ = _weights(10, 64, 32, axis=0)  # (64, 1) row scales
    y = torch.ones(4, 64)
    with pytest.raises(ValueError, match="per-output-channel"):
        int8_matmul.mm_fused(y, rows)
    with pytest.raises(ValueError, match="per-output-channel"):
        int8_matmul.mm_fused_plain(y, rows)
    _, wt, _ = _weights(11, 64, 32)
    with pytest.raises(ValueError, match="contraction"):
        int8_matmul.mm_fused(torch.ones(4, 63), wt)


@pytest.mark.parametrize("m,k,n", [(8, 1024, 1024), (8, 1024, 4096), (8, 4096, 1024), (64, 1024, 1024), (3, 1000, 300), (1, 10, 5)])
@pytest.mark.parametrize("bf16", [True, False])
def test_k4_plan_covers_the_contraction(m, k, n, bf16):
    """K4's one-launch split: the rows of y in groups, the columns in
    tiles of 128, each tile's 16-row code slabs in ``splits`` runs that
    cover them once, no run empty, and the clusters within the card's SMs
    wherever the tiles allow (the three decode shapes take 64 or 96 of
    132: clusters are placed whole inside a GPC)."""
    sms = 132
    p = int8_matmul.k4_plan(m, k, n, bf16, sms)
    assert p.rows * p.groups >= m > p.rows * (p.groups - 1)
    assert p.col_tiles * 128 >= n > (p.col_tiles - 1) * 128
    assert p.slabs * 16 >= k > (p.slabs - 1) * 16
    starts = [s * p.slabs // p.splits for s in range(p.splits + 1)]
    assert starts[0] == 0 and starts[-1] == p.slabs
    assert all(e > s for s, e in zip(starts, starts[1:]))
    assert 1 <= p.splits <= int8_matmul.MAX_SPLITS
    assert p.col_tiles * p.splits <= 3 * sms // 4 or p.splits == 1
    # a card that runs fewer clusters at once gets fewer splits, never a
    # second wave of clusters
    few = int8_matmul.k4_plan(m, k, n, bf16, sms, clusters=lambda rows, s: 100 // s)
    assert few.splits <= p.splits and (few.splits == 1 or p.col_tiles <= 100 // few.splits)
    if (m, k) == (8, 1024) or (m, k, n) == (8, 4096, 1024):
        assert p.col_tiles * p.splits >= 64
    warps = 8
    y_bytes = warps * 2 * p.rows * (24 * 2 if bf16 else 20 * 4)  # 2 slots a warp
    inbox = (16 * 128 // 4 + 16) * 16  # one tile's slices, 16 rows
    assert p.smem == warps * p.rows * (128 + 4) * 4 + inbox + y_bytes <= 227 * 1024
