"""keystone_tpu_torch's attention backward against the JAX package's: the
gradients of ``flash_attention_trainable`` (K2's plain version forward on
the CPU, the dense-recompute or blockwise backward) against ``jax.vjp`` of
the JAX wrapper, whose forward runs in Pallas interpret mode as
tests/test_flash_attention.py runs it; ``_grads_rect`` on fully masked
rows; the environment knobs that pick the backward's route; and the
trainable ring and Ulysses on a 4-position CPU mesh against the JAX
package's on 4 of its 8 virtual devices. Inputs and cotangents come from
numpy seeds; everything is f32."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keystone_tpu.ops import attention as jattn  # noqa: E402
from keystone_tpu.ops import flash_attention as jflash  # noqa: E402
from keystone_tpu.parallel import mesh as jmesh  # noqa: E402
from keystone_tpu_torch.ops import attention, flash_attention as flash  # noqa: E402
from keystone_tpu_torch.parallel import mesh as pmesh  # noqa: E402

# of max|grad|: the same f32 arithmetic in another order (the forwards
# differ by f32 rounding, the backward recomputes from them)
GRAD_TOL = 1e-5


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32) for s in shapes)


def _close(got, want, tol=GRAD_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def _port_vjp(fn, q, k, v, g):
    qkv = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fn(*qkv)
    grads = torch.autograd.grad(out, qkv, torch.from_numpy(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


def _jax_vjp(fn, q, k, v, g):
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


# S = 136: the 32-key backward blocks leave a ragged last block (8 keys)
B, H, S, D = 1, 2, 136, 16


@pytest.mark.parametrize(
    "causal,route,chunks",
    [(False, "dense", None), (True, "dense", None), (False, "blockwise", None),
     (True, "blockwise", None), (True, "blockwise", "2")],
    ids=["dense", "dense_causal", "blockwise", "blockwise_causal", "blockwise_causal_2chunks"],
)
def test_trainable_grads_match_jax(monkeypatch, causal, route, chunks):
    """Both routes, causal and not; the blockwise one with 32-key blocks
    (five, the last ragged) and 5 or 2 causal q chunks. The environment
    picks the route and the blocks in both packages alike."""
    if route == "blockwise":
        monkeypatch.setenv("KST_FLASH_DENSE_BWD_MAX", "0")
        monkeypatch.setenv("KST_FLASH_BWD_BLOCK", "32")
    if chunks:
        monkeypatch.setenv("KST_FLASH_BWD_CHUNKS", chunks)
    q, k, v, g = _arrays(11, *[(B, H, S, D)] * 4)
    out, grads = _port_vjp(lambda *a: flash.flash_attention_trainable(*a, causal), q, k, v, g)
    j_out, j_grads = _jax_vjp(lambda *a: jflash.flash_attention_trainable(*a, causal), q, k, v, g)
    _close(out, j_out)
    for got, want in zip(grads, j_grads):
        _close(got, want)


def test_trainable_grads_match_dense_attention():
    """The blockwise backward and the dense recompute give dense
    attention's gradients (the port against itself, a larger ragged S)."""
    q, k, v, g = _arrays(12, *[(2, 3, 200, 24)] * 4)
    _, dense = _port_vjp(lambda *a: attention.dense_attention(*a, causal=True), q, k, v, g)
    for env in ({}, {"KST_FLASH_DENSE_BWD_MAX": "0", "KST_FLASH_BWD_BLOCK": "64"}):
        with pytest.MonkeyPatch.context() as mp:
            for name, val in env.items():
                mp.setenv(name, val)
            _, got = _port_vjp(lambda *a: flash.flash_attention_trainable(*a, True), q, k, v, g)
        for a, b in zip(got, dense):
            _close(a, b)


def test_grads_rect_fully_masked_rows_are_zero_like_jax():
    """A K/V block at keys 16..79 against queries 0..31, causal: rows
    0..15 see no key, carry lse −1e30, and get zero gradients, not NaN —
    as the JAX package's ``_grads_rect`` gives them."""
    qf, kp, vp, gf = _arrays(13, (1, 2, 32, 16), (1, 2, 64, 16), (1, 2, 64, 16), (1, 2, 32, 16))
    k_off, s_q = 16, 32
    scores = np.einsum("bhqd,bhkd->bhqk", qf, kp) / np.sqrt(16)
    live = np.arange(s_q)[:, None] >= k_off + np.arange(64)[None, :]
    lse = np.where(live, scores, -np.inf)
    with np.errstate(divide="ignore"):
        lse = np.log(np.exp(lse).sum(-1)).astype(np.float32)
    lse[:, :, :k_off] = -1e30
    delta = _arrays(14, (1, 2, 32))[0]
    args = (qf, kp, vp, gf, delta, lse)
    got = flash._grads_rect(*(torch.from_numpy(x) for x in args), 0, k_off + 64, True, 32,
                            k_off=k_off)
    want = jflash._grads_rect(*(jnp.asarray(x) for x in args), 0, k_off + 64, True, 32,
                              k_off=k_off)
    for a, b in zip(got, want):
        _close(a.numpy(), b)
    dq = got[0].numpy()
    assert np.isfinite(dq).all() and not dq[:, :, :k_off].any()


def test_dense_bwd_env_knob_selects_path(monkeypatch):
    """``KST_FLASH_DENSE_BWD_MAX=0`` forces the blockwise route in both
    packages; unset or malformed keeps the 4 GiB default (dense here). The
    route shows in what the forward keeps: (q, k, v) or (q, k, v, out,
    lse)."""
    x = torch.from_numpy(_arrays(15, (1, 2, 128, 32))[0])
    jx = jnp.asarray(x.numpy())

    def port_saves():
        out = flash.flash_attention_trainable(x.clone().requires_grad_(True), x, x)
        return len(out.grad_fn.saved_tensors)

    def jax_blockwise():
        return jflash._flash_trainable_fwd(jx, jx, jx, False)[1][3] is not None

    monkeypatch.delenv("KST_FLASH_DENSE_BWD_MAX", raising=False)
    assert port_saves() == 3 and not jax_blockwise()
    monkeypatch.setenv("KST_FLASH_DENSE_BWD_MAX", "0")
    assert port_saves() == 5 and jax_blockwise()
    monkeypatch.setenv("KST_FLASH_DENSE_BWD_MAX", "not-an-int")
    assert port_saves() == 3 and not jax_blockwise()
    assert flash._DENSE_BWD_MAX_BYTES == jflash._DENSE_BWD_MAX_BYTES == 4 << 30
    for knob, default in (("_bwd_block", 512), ("_bwd_causal_chunks", 8)):
        assert getattr(flash, knob)() == getattr(jflash, knob)() == default


# --- the trainable ring and Ulysses on a 4-position mesh ---------------------

RB, RH, RS, RD = 1, 4, 64, 16
N = 4  # ring positions


@pytest.fixture(scope="module")
def ring_inputs():
    return _arrays(16, *[(RB, RH, RS, RD)] * 4)


@pytest.fixture(scope="module")
def jax_ring_grads(ring_inputs, devices):
    """The JAX package's trainable ring (its plain hop, the ring backward)
    and trainable Ulysses (dense local attention differentiated through
    the all-to-alls), on 4 of its devices, causal and not."""
    mesh = jmesh.create_mesh(data=N)
    q, k, v, g = ring_inputs
    out = {}
    for causal in (False, True):
        out["ring", causal] = _jax_vjp(
            lambda *a: jattn.ring_attention(*a, mesh, causal=causal, use_flash=False,
                                            trainable=True), q, k, v, g)
        out["ulysses", causal] = _jax_vjp(
            lambda *a: jattn.ulysses_attention(*a, mesh, causal=causal, use_flash=False,
                                               trainable=True), q, k, v, g)
    return out


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "mode,use_flash", [("ring", False), ("ring", True), ("ulysses", False), ("ulysses", True)],
    ids=["ring_plain", "ring_k3_plain", "ulysses_dense", "ulysses_k2_plain"],
)
def test_sequence_parallel_grads_match_jax(ring_inputs, jax_ring_grads, mode, use_flash, causal):
    """The ring backward (its plain hop or K3's plain version forward)
    and Ulysses (dense or the flash trainable wrapper per position) give
    the JAX package's output and gradients."""
    mesh = pmesh.create_mesh(data=N, devices=["cpu"] * N)
    fn = attention.ring_attention if mode == "ring" else attention.ulysses_attention
    out, grads = _port_vjp(
        lambda *a: fn(*a, mesh, causal=causal, use_flash=use_flash, trainable=True),
        *ring_inputs)
    j_out, j_grads = jax_ring_grads[mode, causal]
    _close(out, j_out)
    for got, want in zip(grads, j_grads):
        _close(got, want)


def test_ring_backward_skips_future_hops_and_small_shards(monkeypatch, ring_inputs):
    """A causal ring backward runs ``_grads_rect`` for the 10 live hops of
    4 positions (16 without causality), each with one block of the shard
    rounded up to 8 rows when the shard is under ``KST_FLASH_BWD_BLOCK``,
    and with that many-row blocks when it is over."""
    mesh = pmesh.create_mesh(data=N, devices=["cpu"] * N)
    calls = []
    real = attention._grads_rect

    def counting(*a, **kw):
        calls.append((a[9], a[1].shape[2]))
        return real(*a, **kw)

    monkeypatch.setattr(attention, "_grads_rect", counting)
    q, k, v, g = (torch.from_numpy(x).requires_grad_(True) for x in ring_inputs)
    for causal, want in ((True, N * (N + 1) // 2), (False, N * N)):
        calls.clear()
        out = attention.ring_attention(q, k, v, mesh, causal=causal, trainable=True)
        torch.autograd.grad(out, (q, k, v), g.detach())
        assert len(calls) == want and set(calls) == {(16, 16)}
    monkeypatch.setenv("KST_FLASH_BWD_BLOCK", "8")
    calls.clear()
    out = attention.ring_attention(q, k, v, mesh, causal=True, trainable=True)
    torch.autograd.grad(out, (q, k, v), g.detach())
    assert set(calls) == {(8, 16)}
