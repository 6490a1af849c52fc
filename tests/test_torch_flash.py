"""keystone_tpu_torch's attention against the JAX package's: the flash
forward (kernel K2's plain version, which the wrapper takes for a CPU
tensor) against the Pallas kernel in interpret mode, and dense attention
against dense attention. Inputs come from numpy seeds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.ops import attention as jattn  # noqa: E402
from keystone_tpu.ops import flash_attention as jflash  # noqa: E402
from keystone_tpu_torch.ops import attention, flash_attention as flash  # noqa: E402

F32_TOL = 1e-5
# one bf16 step after an f32 sum taken in another order
BF16_TOL = 8e-3


def _qkv(seed, b, h, s_q, s_k, d):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.normal(size=(b, h, s, d)).astype(np.float32) for s in (s_q, s_k, s_k)
    )


def _port(q, k, v, dtype=torch.float32, **kw):
    return flash.flash_attention(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)), **kw)


def _jax(q, k, v, dtype=jnp.float32, **kw):
    return jflash.flash_attention(*(jnp.asarray(x, dtype) for x in (q, k, v)), **kw)


@pytest.mark.parametrize(
    "shape,causal,offsets",
    [
        ((2, 3, 64, 64, 32), True, (0, 0)),  # self-attention, causal
        ((2, 3, 64, 64, 32), False, (0, 0)),
        ((1, 2, 40, 40, 16), True, (0, 0)),  # unaligned S and D
        ((2, 2, 24, 100, 16), False, (0, 0)),  # cross-attention, 2 K tiles
        ((1, 2, 33, 90, 8), True, (70, 10)),  # offsets, causal, ragged
    ],
)
def test_flash_matches_jax_f32(shape, causal, offsets):
    b, h, s_q, s_k, d = shape
    q, k, v = _qkv(sum(shape), b, h, s_q, s_k, d)
    kw = dict(causal=causal, q_offset=offsets[0], k_offset=offsets[1])
    before = flash.FLASH_ATTENTION.launches
    got = _port(q, k, v, **kw)
    assert flash.FLASH_ATTENTION.launches == before  # the CPU takes the plain version
    want = np.asarray(_jax(q, k, v, **kw))
    assert got.dtype == torch.float32 and got.shape == (b, h, s_q, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_fully_masked_rows_are_zero_with_lse():
    """q rows whose position precedes every key (causal, k_offset ahead):
    the output is 0 and the lse −1e30, in both packages."""
    q, k, v = _qkv(5, 2, 3, 77, 50, 40)
    kw = dict(causal=True, q_offset=3, k_offset=40, return_lse=True)
    out, lse = _port(q, k, v, **kw)
    j_out, j_lse = _jax(q, k, v, **kw)
    dead = 3 + np.arange(77) < 40
    assert dead.any() and not dead.all()
    assert torch.all(out[:, :, dead] == 0)
    assert torch.all(lse[:, :, dead] <= -1e29)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=F32_TOL, atol=F32_TOL)
    live = ~dead
    np.testing.assert_allclose(
        lse[:, :, live].numpy(), np.asarray(j_lse)[:, :, live], rtol=F32_TOL, atol=F32_TOL
    )
    np.testing.assert_array_equal(lse[:, :, dead].numpy(), np.asarray(j_lse)[:, :, dead])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_lse_matches_jax(causal):
    q, k, v = _qkv(7, 1, 2, 48, 48, 16)
    _, lse = _port(q, k, v, causal=causal, return_lse=True)
    _, j_lse = _jax(q, k, v, causal=causal, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (1, 2, 48)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_matches_jax(causal):
    """bf16 in and out: q·scale and p rounded to bf16 at the same points.
    S_k ≤ 64 keeps both packages at one K tile, so p is rounded against
    the same running max."""
    q, k, v = _qkv(11, 2, 2, 64, 64, 32)
    got = _port(q, k, v, torch.bfloat16, causal=causal)
    assert got.dtype == torch.bfloat16
    want = np.asarray(_jax(q, k, v, jnp.bfloat16, causal=causal), np.float32)
    err = np.abs(got.to(torch.float32).numpy() - want).max()
    assert err <= BF16_TOL * np.abs(want).max(), err


def test_mxu_dtype_keeps_q_dtype():
    q, k, v = _qkv(13, 1, 2, 32, 32, 16)
    got = _port(q, k, v, causal=True, mxu_dtype=torch.bfloat16)
    want = np.asarray(_jax(q, k, v, causal=True, mxu_dtype=jnp.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_tpu_block_knobs_are_accepted_and_ignored():
    q, k, v = _qkv(17, 1, 1, 40, 40, 8)
    base = _port(q, k, v, causal=True)
    knobs = _port(q, k, v, causal=True, block_q=16, block_k=8, kv_resident=False)
    assert torch.equal(base, knobs)


@pytest.mark.parametrize(
    "s_q,s_k,causal", [(32, 32, True), (32, 32, False), (16, 40, True), (40, 16, False)]
)
def test_dense_attention_matches_jax(s_q, s_k, causal):
    q, k, v = _qkv(s_q + s_k, 2, 2, s_q, s_k, 16)
    got = attention.dense_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    want = np.asarray(jattn.dense_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=causal))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_dense_causal_is_end_aligned_and_flash_begin_aligned():
    """At S_q > S_k the dense mask leaves the first rows fully masked
    (NaN); the flash forward's begin-aligned mask gives them keys."""
    q, k, v = _qkv(19, 1, 1, 8, 4, 8)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    dense = attention.dense_attention(*t, causal=True)
    assert torch.isnan(dense[0, 0, :4]).all() and torch.isfinite(dense[0, 0, 4:]).all()
    assert torch.isfinite(flash.flash_attention(*t, causal=True)).all()


def test_trainable_rejects_causal_cross_and_has_no_backward():
    q, k, v = (torch.from_numpy(x) for x in _qkv(23, 1, 1, 8, 12, 8))
    with pytest.raises(ValueError, match="ambiguous"):
        flash.flash_attention_trainable(q, k, v, True)
    qs = q.clone().requires_grad_(True)
    out = flash.flash_attention_trainable(qs, k, v, False)
    torch.testing.assert_close(out, flash.flash_attention(q, k, v), rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()
