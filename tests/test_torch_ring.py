"""keystone_tpu_torch's sequence-parallel attention against the JAX
package's: the ring hop (kernel K3's plain version, which the wrapper takes
for a CPU tensor) against ``flash_attention_step`` in Pallas interpret
mode, and ring and Ulysses attention on a 4-position CPU mesh against the
same on 4 of the JAX package's 8 virtual devices (4 positions compile in
half the time of 8 and keep every hop kind: past, diagonal and future).
Inputs come from numpy seeds; the JAX results are computed once per
module."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.ops import attention as jattn  # noqa: E402
from keystone_tpu.ops import flash_attention as jflash  # noqa: E402
from keystone_tpu.parallel import mesh as jmesh  # noqa: E402
from keystone_tpu_torch.ops import attention, flash_attention as flash  # noqa: E402
from keystone_tpu_torch.parallel import mesh as pmesh  # noqa: E402

TOL = 1e-5  # f32: the same arithmetic summed in another order


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32) for s in shapes)


def _state(seed, b, h, s, d, fresh=True):
    if fresh:
        return (np.full((b, h, s), -1e30, np.float32), np.zeros((b, h, s), np.float32),
                np.zeros((b, h, s, d), np.float32))
    m, l, acc = _arrays(seed, (b, h, s), (b, h, s), (b, h, s, d))
    return m, np.abs(l) + 0.5, acc


def _port_step(q, k, v, state, dtype=torch.float32, **kw):
    qkv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    return flash.flash_attention_step(*qkv, *(torch.from_numpy(x) for x in state), **kw)


def _jax_step(q, k, v, state, dtype=jnp.float32, **kw):
    qkv = (jnp.asarray(x, dtype) for x in (q, k, v))
    return jflash.flash_attention_step(*qkv, *(jnp.asarray(x) for x in state), **kw)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def test_step_blocks_accumulate_like_jax():
    """tests/test_flash_attention.py's four causal blocks: the state after
    every block, and the finalized output, which equals dense attention."""
    b, h, s, d = 1, 2, 128, 64
    q, k, v = _arrays(0, *[(b, h, s, d)] * 3)
    sk = s // 4
    pst = tuple(torch.from_numpy(x) for x in _state(0, b, h, s, d))
    jst = tuple(jnp.asarray(x) for x in _state(0, b, h, s, d))
    for j in range(4):
        blk = (q, k[:, :, j * sk : (j + 1) * sk], v[:, :, j * sk : (j + 1) * sk])
        kw = dict(q_offset=0, k_offset=j * sk, causal=True)
        pst = flash.flash_attention_step(*(torch.from_numpy(x) for x in blk), *pst, **kw)
        jst = jflash.flash_attention_step(
            *(jnp.asarray(x) for x in blk), *jst, block_q=64, block_k=32, **kw
        )
        for p_, j_ in zip(pst, jst):
            _close(p_.numpy(), j_)
    out = pst[2] / torch.clamp_min(pst[1], 1e-30)[..., None]
    ref = attention.dense_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    _close(out.numpy(), ref.numpy())


def test_step_uneven_shard_matches_jax():
    """S 192, D 24: neither a multiple of the TPU blocks nor of 64 keys."""
    b, h, s, d = 1, 2, 192, 24
    q, k, v = _arrays(1, *[(b, h, s, d)] * 3)
    state = _state(1, b, h, s, d)
    kw = dict(q_offset=0, k_offset=0, causal=True)
    for p_, j_ in zip(_port_step(q, k, v, state, **kw), _jax_step(q, k, v, state, **kw)):
        _close(p_.numpy(), j_)


def test_step_future_hop_leaves_state_bit_for_bit():
    """A causal K/V block wholly after the q window: the state comes back
    unchanged, in new tensors, as in the JAX package."""
    b, h, s, d = 2, 3, 96, 32
    q, k, v = _arrays(2, *[(b, h, s, d)] * 3)
    state = _state(2, b, h, s, d, fresh=False)
    kw = dict(q_offset=0, k_offset=s, causal=True)
    got = _port_step(q, k, v, state, **kw)
    want = _jax_step(q, k, v, state, **kw)
    for g, j_, x in zip(got, want, state):
        assert np.array_equal(g.numpy(), x) and np.array_equal(np.asarray(j_), x)
    assert not any(np.shares_memory(g.numpy(), x) for g, x in zip(got, state))


@pytest.mark.parametrize("causal", [False, True])
def test_step_bf16_inputs_match_jax(causal):
    """bf16 q, k, v are widened to f32 in both: the products are exact,
    so only the order of the f32 sums differs."""
    b, h, s_q, s_k, d = 1, 2, 80, 72, 64
    q, k, v = _arrays(3, (b, h, s_q, d), (b, h, s_k, d), (b, h, s_k, d))
    state = _state(3, b, h, s_q, d, fresh=False)
    kw = dict(q_offset=40, k_offset=20, causal=causal)
    got = _port_step(q, k, v, state, dtype=torch.bfloat16, **kw)
    want = _jax_step(q, k, v, state, dtype=jnp.bfloat16, **kw)
    for p_, j_ in zip(got, want):
        _close(p_.numpy(), j_)


def test_step_ignores_tpu_block_knobs():
    q, k, v = _arrays(4, *[(1, 1, 70, 16)] * 3)
    state = _state(4, 1, 1, 70, 16)
    kw = dict(q_offset=0, k_offset=0, causal=True)
    a = _port_step(q, k, v, state, **kw)
    b = _port_step(q, k, v, state, block_q=8, block_k=16, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --- ring and Ulysses on a 4-position mesh -----------------------------------

B, H, S, D = 2, 8, 64, 16
N = 4  # ring positions


@pytest.fixture(scope="module")
def qkv():
    return _arrays(5, *[(B, H, S, D)] * 3)


@pytest.fixture(scope="module")
def jax_results(qkv, devices):
    """The JAX package's ring with the Pallas step in interpret mode (causal
    and not) and plain (causal), and Ulysses, on 4 of its devices."""
    mesh = jmesh.create_mesh(data=N)
    q, k, v = (jnp.asarray(x) for x in qkv)
    out = {}
    for causal, use_flash in ((False, True), (True, True), (True, False)):
        out["ring", causal, use_flash] = np.asarray(jattn.ring_attention(
            q, k, v, mesh, seq_axis="data", causal=causal, use_flash=use_flash))
    for causal in (False, True):
        out["ulysses", causal, False] = np.asarray(jattn.ulysses_attention(
            q, k, v, mesh, seq_axis="data", causal=causal, use_flash=False))
    return out


@pytest.fixture(scope="module")
def cpu_mesh():
    return pmesh.create_mesh(data=N, devices=["cpu"] * N)


@pytest.mark.parametrize(
    "causal,use_flash", [(False, True), (True, True), (True, False)],
    ids=["k3_plain", "k3_plain_causal", "plain_ring_causal"],
)
def test_ring_matches_jax(qkv, jax_results, cpu_mesh, causal, use_flash):
    q, k, v = (torch.from_numpy(x) for x in qkv)
    got = attention.ring_attention(q, k, v, cpu_mesh, causal=causal, use_flash=use_flash)
    assert got.shape == (B, H, S, D) and got.dtype == torch.float32
    _close(got.numpy(), jax_results["ring", causal, use_flash])


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(qkv, jax_results, cpu_mesh, causal):
    q, k, v = (torch.from_numpy(x) for x in qkv)
    got = attention.ulysses_attention(q, k, v, cpu_mesh, causal=causal)
    _close(got.numpy(), jax_results["ulysses", causal, False])
    # K2's plain version per position: the same attention
    flashed = attention.ulysses_attention(q, k, v, cpu_mesh, causal=causal, use_flash=True)
    _close(flashed.numpy(), jax_results["ulysses", causal, False])


def test_ring_defaults_to_plain_on_cpu(monkeypatch, qkv, cpu_mesh):
    """On the CPU ``use_flash`` defaults off, as off the TPU in the JAX
    package; with it on, every hop goes through flash_attention_step."""
    q, k, v = (torch.from_numpy(x) for x in qkv)
    calls = []
    real = attention.flash_attention_step

    def counting(*a, **kw):
        calls.append(kw["k_offset"])
        return real(*a, **kw)

    monkeypatch.setattr(attention, "flash_attention_step", counting)
    attention.ring_attention(q, k, v, cpu_mesh, causal=True)
    assert calls == []
    attention.ring_attention(q, k, v, cpu_mesh, causal=True, use_flash=True)
    # every position at every hop, but a causal block from a later position
    assert len(calls) == N * (N + 1) // 2
    # hop 1: position j holds position j-1's block; position 0's block (from
    # position N-1) lies after its window and is skipped
    assert calls[N : 2 * N - 1] == [((j - 1) % N) * (S // N) for j in range(1, N)]


def _ring_without_skip(q, k, v, causal):
    """The fused ring's arithmetic with every one of the n² hops stepped."""
    sl = S // N
    qs, ks, vs = (list(x.split(sl, dim=2)) for x in (q, k, v))
    outs = []
    for j in range(N):
        state = (torch.full((B, H, sl), -1e30), torch.zeros((B, H, sl)),
                 torch.zeros((B, H, sl, D)))
        for step in range(N):
            owner = (j - step) % N
            state = flash.flash_attention_step(
                qs[j].contiguous(), ks[owner].contiguous(), vs[owner].contiguous(), *state,
                q_offset=j * sl, k_offset=owner * sl, causal=causal,
            )
        m, l, acc = state
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    return torch.cat(outs, dim=2)


@pytest.mark.parametrize("causal,steps", [(True, N * (N + 1) // 2), (False, N * N)])
def test_fused_ring_skips_masked_hops_exactly(monkeypatch, qkv, cpu_mesh, causal, steps):
    """A causal hop whose block comes from a later position has no live
    key: the ring does not step it (10 steps over 4 positions, 16 without
    causality), and its output equals a ring that steps every hop, bit for
    bit."""
    q, k, v = (torch.from_numpy(x) for x in qkv)
    want = _ring_without_skip(q, k, v, causal)
    calls = []
    real = attention.flash_attention_step

    def counting(*a, **kw):
        calls.append((kw["q_offset"], kw["k_offset"]))
        return real(*a, **kw)

    monkeypatch.setattr(attention, "flash_attention_step", counting)
    got = attention.ring_attention(q, k, v, cpu_mesh, causal=causal, use_flash=True)
    assert len(calls) == steps
    assert all(qo >= ko for qo, ko in calls) or not causal
    assert torch.equal(got, want)


def test_flash_default_reads_the_mesh_positions():
    """The fused default follows where the shards run: a card anywhere on
    the axis, whatever q's device."""
    assert not attention._flash_default([torch.device("cpu")] * 4)
    assert attention._flash_default(["cpu", "cuda:0"])
    assert attention._flash_default([torch.device("cuda", 0)] * 4)


def test_ring_and_ulysses_take_the_ambient_mesh(qkv, cpu_mesh):
    q, k, v = (torch.from_numpy(x) for x in qkv)
    for fn in (attention.ring_attention, attention.ulysses_attention):
        want = fn(q, k, v, cpu_mesh, causal=True)
        with pmesh.use_mesh(cpu_mesh):
            got = fn(q, k, v, causal=True)
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match="no mesh"):
            fn(q, k, v, causal=True)


def test_sequence_or_heads_not_divisible_fails_loudly(cpu_mesh):
    q, k, v = (torch.from_numpy(x) for x in _arrays(6, *[(1, 8, 66, 8)] * 3))
    with pytest.raises(ValueError, match="not divisible"):
        attention.ring_attention(q, k, v, cpu_mesh, seq_axis="data")
    with pytest.raises(ValueError, match="not divisible"):
        attention.ulysses_attention(q, k, v, cpu_mesh, seq_axis="data")
    q, k, v = (torch.from_numpy(x) for x in _arrays(6, *[(1, 6, 64, 8)] * 3))
    with pytest.raises(ValueError, match="heads"):
        attention.ulysses_attention(q, k, v, cpu_mesh, seq_axis="data")


def test_trainable_ring_backward_raises(qkv, cpu_mesh):
    """The trainable ring's backward (which this test's name predates)
    now runs: its gradients are dense attention's (tests/
    test_torch_flash_bwd.py holds them against the JAX package), and the
    forward is the ring's."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in qkv)
    out = attention.ring_attention(q, k, v, cpu_mesh, causal=True, trainable=True)
    assert torch.equal(out, attention.ring_attention(q, k, v, cpu_mesh, causal=True))
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    want = torch.autograd.grad(attention.dense_attention(q, k, v, causal=True).sum(), (q, k, v))
    for g, w in zip(grads, want):
        _close(g.numpy(), w.numpy())


def test_create_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the mesh would be made on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.create_mesh(data=4)


def test_mesh_shape_axes_and_ambient_mesh():
    mesh = pmesh.create_mesh(data=2, model=3, devices=["cpu"] * 6)
    assert mesh.shape == {"data": 2, "model": 3}
    assert mesh.axis_names == (pmesh.DATA_AXIS, pmesh.MODEL_AXIS)
    assert mesh.axis_devices("data") == [torch.device("cpu")] * 2
    assert len(mesh.axis_devices("model")) == 3
    with pytest.raises(ValueError, match="no axis"):
        mesh.axis_devices("seq")
    with pytest.raises(ValueError, match="needs 8 devices"):
        pmesh.create_mesh(data=8, devices=["cpu"] * 4)
    assert pmesh.create_mesh(devices=["cpu"] * 4).shape == {"data": 4, "model": 1}
    assert pmesh.current_mesh() is None
    with pmesh.use_mesh(mesh):
        assert pmesh.current_mesh() is mesh
    assert pmesh.current_mesh() is None
