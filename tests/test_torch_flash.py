"""keystone_tpu_torch's attention against the JAX package's: the flash
forward (kernel K2's plain version, which the wrapper takes for a CPU
tensor) against the Pallas kernel in interpret mode, and dense attention
against dense attention. Inputs come from numpy seeds.

Each test starts from a state no earlier test file of the same worker can
have changed (:func:`fresh_state`)."""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax._src import compilation_cache  # noqa: E402

from keystone_tpu.ops import attention as jattn  # noqa: E402
from keystone_tpu.ops import flash_attention as jflash  # noqa: E402
from keystone_tpu_torch.ops import attention, flash_attention as flash  # noqa: E402
from keystone_tpu_torch.ops.linear import _matmul_precision  # noqa: E402

F32_TOL = 1e-5
# one bf16 step after an f32 sum taken in another order
BF16_TOL = 8e-3


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """What a test file that ran earlier in the same process may leave
    behind, set afresh for each test:

    - K2's launch count, counted from 0 inside the test;
    - the ``KST_FLASH_*`` and ``KST_LOCAL_ATTN`` knobs, which both
      packages read per call: unset, so both take their defaults;
    - JAX's persistent compilation cache, which the JAX package's export
      and refit paths turn on for the whole process, in a directory that
      every worker of the run shares: off, so the reference is compiled
      here, not read from another process's entry;
    - torch's default dtype: float32;
    - every float32 precision flag: full f32, through the port's own
      scope, which puts each flag back afterwards. Torch's legacy
      getter and setter are not used: the legacy string they read and
      write is kept apart from the flags, and writing back a string that
      another test left (``medium``) would set oneDNN's matmul to bf16
      for the rest of the process."""
    for name in list(os.environ):
        if name.startswith("KST_FLASH_") or name == "KST_LOCAL_ATTN":
            monkeypatch.delenv(name)
    monkeypatch.setattr(flash.FLASH_ATTENTION, "launches", 0)
    cache = (jax.config.jax_enable_compilation_cache, jax.config.jax_compilation_cache_dir)
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    with _matmul_precision("highest"):
        yield
    torch.set_default_dtype(dtype)
    jax.config.update("jax_enable_compilation_cache", cache[0])
    jax.config.update("jax_compilation_cache_dir", cache[1])
    compilation_cache.reset_cache()


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
    got = _port(q, k, v, **kw)
    assert flash.FLASH_ATTENTION.launches == 0  # the CPU takes the plain version
    want = np.asarray(_jax(q, k, v, **kw))
    assert got.dtype == torch.float32 and got.shape == (b, h, s_q, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


# every key in one 64-key tile: the calls K2's short-key f32 kernel takes
SHORT_KEY_CASES = [
    ((16, 4, 16, 16, 32), False, (0, 0)),  # ViT's heads at a small batch
    ((1, 1, 1, 1, 8), False, (0, 0)),
    ((2, 3, 17, 64, 40), True, (3, 40)),  # every row fully masked
    ((1, 2, 70, 20, 32), False, (0, 0)),  # S_q > 64
    ((1, 2, 64, 64, 128), False, (0, 0)),
]


def _assert_lse_close(got, want):
    """lse within F32_TOL on live rows; −1e30 rows the same bits."""
    dead = want <= -1e29
    np.testing.assert_array_equal(got[dead], want[dead])
    np.testing.assert_allclose(got[~dead], want[~dead], rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("shape,causal,offsets", SHORT_KEY_CASES)
def test_flash_short_keys_matches_jax_f32(shape, causal, offsets):
    b, h, s_q, s_k, d = shape
    q, k, v = _qkv(sum(shape) + 1, b, h, s_q, s_k, d)
    kw = dict(causal=causal, q_offset=offsets[0], k_offset=offsets[1], return_lse=True)
    out, lse = _port(q, k, v, **kw)
    assert flash.FLASH_ATTENTION.launches == 0
    j_out, j_lse = _jax(q, k, v, **kw)
    assert out.shape == (b, h, s_q, d) and lse.shape == (b, h, s_q)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=F32_TOL, atol=F32_TOL)
    _assert_lse_close(lse.numpy(), np.asarray(j_lse))
    if offsets == (3, 40):
        assert torch.all(out == 0) and torch.all(lse <= -1e29)


def _k2_short_emulated(q, k, v, *, causal=False, q_offset=0, k_offset=0):
    """K2's short-key f32 kernel (S_k ≤ 64) in its own order of sums: each
    score an FMA chain over D of q·scale (rounded to f32) and k; the lanes
    of a row (T = S_k's tile / 8: 2, 4 or 8) each sum p over keys t, t +
    T, … and a butterfly adds their sums (xor 1, 2, 4); P·V an FMA chain
    over the keys in order; out = acc / max(l, 1e-30), lse = m + log(max(l,
    1e-30)). An FMA is the f64 product (exact for f32 factors) plus the f32
    sum, rounded once to f32."""
    f32, f64 = torch.float32, torch.float64
    s_q, d = q.shape[2], q.shape[3]
    s_k = k.shape[2]
    aligned = d % 4 == 0
    lanes = 8 if not aligned or s_k > 32 else 4 if s_k > 16 else 2
    qs = q * flash._scale(d, f32)

    def fma(a, b, c):
        return (a.to(f64) * b.to(f64) + c.to(f64)).to(f32)

    s = torch.zeros(q.shape[:3] + (s_k,), dtype=f32)
    for c in range(d):
        s = fma(qs[..., c : c + 1], k[..., c][..., None, :], s)
    valid = torch.ones((s_q, s_k), dtype=torch.bool)
    if causal:
        valid = (q_offset + torch.arange(s_q))[:, None] >= (k_offset + torch.arange(s_k))[None, :]
    s = torch.where(valid, s, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    part = [p[..., t::lanes].sum(-1, keepdim=True) for t in range(lanes)]
    while len(part) > 1:  # butterfly: neighbours first
        part = [part[i] + part[i + 1] for i in range(0, len(part), 2)]
    l = part[0]
    acc = torch.zeros(q.shape, dtype=f32)
    for jj in range(s_k):
        acc = fma(p[..., jj : jj + 1], v[:, :, jj : jj + 1, :], acc)
    den = torch.clamp_min(l, 1e-30)
    return acc / den, (m + torch.log(den))[..., 0]


@pytest.mark.parametrize("shape,causal,offsets", SHORT_KEY_CASES + [
    ((2, 2, 16, 16, 32), True, (0, 0)),
    ((1, 3, 24, 30, 36), True, (10, 0)),  # T = 4, D padded to 64
    ((2, 1, 5, 7, 33), True, (2, 0)),  # rows not 16-byte aligned: T = 8
])
def test_k2_short_key_arithmetic_matches_plain_and_jax(shape, causal, offsets):
    """The emulation of the short-key kernel's order of sums against K2's
    plain version and the JAX package's flash_attention (Pallas, interpret
    mode), within F32_TOL."""
    b, h, s_q, s_k, d = shape
    q, k, v = _qkv(sum(shape) + 2, b, h, s_q, s_k, d)
    kw = dict(causal=causal, q_offset=offsets[0], k_offset=offsets[1])
    got, got_lse = _k2_short_emulated(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    plain, plain_lse = _port(q, k, v, return_lse=True, **kw)
    j_out, j_lse = _jax(q, k, v, return_lse=True, **kw)
    for want, want_lse in ((plain.numpy(), plain_lse.numpy()),
                           (np.asarray(j_out), np.asarray(j_lse))):
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
        _assert_lse_close(got_lse.numpy(), want_lse)


_LOG2E_F32 = float(np.float32(1.44269502))
_LN2_F32 = float(np.float32(0.693147182))


def _exp_sfu(x):
    """The tiled f32 kernel's exp_sfu on an f32 tensor, its special-function
    unit's 2^t taken as correctly rounded: t = x·log2 e rounded to f32, c =
    x − t·ln 2 rounded once (an FMA), 2^t·(1 + c) rounded once (an FMA).
    Products of two f32 values are exact in f64."""
    f32, f64 = torch.float32, torch.float64
    t = (x.to(f64) * _LOG2E_F32).to(f32)
    c = (x.to(f64) - t.to(f64) * _LN2_F32).to(f32)
    y = torch.exp2(t.to(f64)).to(f32).to(f64)
    return (y * c.to(f64) + y).to(f32)


def test_k2_tiled_exp_is_within_ulps_of_exp():
    """exp_sfu's roundings leave at most 2.3 ulp against exp for |x| ≤ 30
    (beside the special-function unit's own 2 ulp), where 2^t alone is off
    by up to 29; at x = 0 it is exact, and exp(−1e30) is 0."""
    x = torch.from_numpy(-np.concatenate([np.logspace(-8, np.log10(30), 300_000),
                                          np.linspace(0, 30, 300_001)]).astype(np.float32))
    want = torch.exp(x.to(torch.float64))
    ulp = torch.from_numpy(np.spacing(want.to(torch.float32).numpy())).to(torch.float64)

    def ulps(got):
        return float(((got.to(torch.float64) - want).abs() / ulp).max())

    assert ulps(_exp_sfu(x)) <= 2.3
    assert ulps(torch.exp2((x.to(torch.float64) * _LOG2E_F32).to(torch.float32).to(
        torch.float64)).to(torch.float32)) > 20
    assert float(_exp_sfu(torch.tensor([0.0]))) == 1.0
    assert float(_exp_sfu(torch.tensor([-1e30]))) == 0.0


def _k2_tiled_emulated(q, k, v, *, causal=False, q_offset=0, k_offset=0):
    """K2's tiled f32 kernel (S_k > 64) in its own order of sums: each score
    an FMA chain over D of q·scale (rounded to f32) and k; per 64-key tile
    the masked scores set to −1e30, m_new = max(m, the tile's row max),
    alpha and p as _exp_sfu of x = m − m_new and s − m_new; each of a
    row's G lanes keeps a partial l, lane t over the tile's keys K·t … K·t
    + K − 1 (G = 8, K = 8 at 32 < D ≤ 64; else G = 16, K = 4, as for rows
    off 16 bytes), l·alpha rounded, then its p added in order; acc·alpha
    rounded, then an FMA chain of p·v over the tile's keys in order; at
    the end a butterfly adds the G partial sums (xor 1, 2, 4, …), out =
    acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)). An FMA is the f64
    product (exact for f32 factors) plus the f32 sum, rounded once to
    f32."""
    f32, f64 = torch.float32, torch.float64
    s_q, d = q.shape[2], q.shape[3]
    s_k = k.shape[2]
    lanes, keys = (8, 8) if d % 4 == 0 and 32 < d <= 64 else (16, 4)
    qs = q * flash._scale(d, f32)

    def fma(a, b, c):
        return (a.to(f64) * b.to(f64) + c.to(f64)).to(f32)

    lead = q.shape[:3]
    m = torch.full(lead + (1,), -1e30, dtype=f32)
    lp = torch.zeros(lead + (lanes,), dtype=f32)
    acc = torch.zeros(q.shape, dtype=f32)
    q_pos = q_offset + torch.arange(s_q)[:, None]
    for key0 in range(0, s_k, 64):
        kt, vt = k[:, :, key0 : key0 + 64], v[:, :, key0 : key0 + 64]
        n = kt.shape[2]
        s = torch.zeros(lead + (n,), dtype=f32)
        for c in range(d):
            s = fma(qs[..., c : c + 1], kt[..., c][..., None, :], s)
        valid = torch.ones((s_q, n), dtype=torch.bool)
        if causal:
            valid = q_pos >= k_offset + key0 + torch.arange(n)[None, :]
        s = torch.where(valid, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = _exp_sfu(m - m_new)
        p = torch.where(valid, _exp_sfu(s - m_new), 0.0)
        lp = lp * alpha
        for j in range(n):  # lane j // keys adds its keys in order
            lane = j // keys
            lp[..., lane] = lp[..., lane] + p[..., j]
        acc = acc * alpha
        for j in range(n):
            acc = fma(p[..., j : j + 1], vt[:, :, j : j + 1, :], acc)
        m = m_new
    part = [lp[..., t : t + 1] for t in range(lanes)]
    while len(part) > 1:  # butterfly: neighbours first
        part = [part[i] + part[i + 1] for i in range(0, len(part), 2)]
    den = torch.clamp_min(part[0], 1e-30)
    return acc / den, (m + torch.log(den))[..., 0]


@pytest.mark.parametrize("shape,causal,offsets", [
    ((1, 2, 16, 65, 32), False, (0, 0)),  # the first S_k past one key tile
    ((2, 2, 130, 200, 64), True, (5, 90)),  # offsets: rows 0-84 fully masked
    ((1, 2, 40, 129, 128), False, (0, 0)),
    ((2, 2, 97, 97, 33), True, (0, 0)),  # rows off 16 bytes
    ((1, 2, 70, 90, 40), True, (20, 0)),
    ((1, 1, 33, 70, 100), False, (0, 0)),
    ((2, 2, 64, 256, 32), True, (0, 0)),  # the trainer's default D, four tiles
    ((1, 2, 100, 130, 64), False, (3, 1)),
    ((1, 1, 65, 66, 128), True, (0, 0)),
])
def test_k2_tiled_arithmetic_matches_plain_and_jax(shape, causal, offsets):
    """The emulation of the tiled f32 kernel's order of sums against K2's
    plain version and the JAX package's flash_attention (Pallas, interpret
    mode), within F32_TOL, the lse included."""
    b, h, s_q, s_k, d = shape
    q, k, v = _qkv(sum(shape) + 3, b, h, s_q, s_k, d)
    kw = dict(causal=causal, q_offset=offsets[0], k_offset=offsets[1])
    got, got_lse = _k2_tiled_emulated(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    plain, plain_lse = _port(q, k, v, return_lse=True, **kw)
    j_out, j_lse = _jax(q, k, v, return_lse=True, **kw)
    for want, want_lse in ((plain.numpy(), plain_lse.numpy()),
                           (np.asarray(j_out), np.asarray(j_lse))):
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
        _assert_lse_close(got_lse.numpy(), want_lse)
    if offsets == (5, 90):
        assert torch.all(got[:, :, :85] == 0) and torch.all(got_lse[:, :, :85] <= -1e29)


def _k2_tiled_probe():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "tools", "k2_tiled_probe.py")
    spec = importlib.util.spec_from_file_location("k2_tiled_probe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("variant", ["kernel", "expf", "approx", "no_softmax", "s_only",
                                     "pv_only"])
def test_k2_tiled_probe_patches_the_kernel_source(variant):
    """Each probe build of tools/k2_tiled_probe.py patches today's
    flash_attention.cu (every anchor found once) and leaves its bf16
    launches out, so a change to the kernel that moves an anchor fails
    here rather than on the card."""
    probe = _k2_tiled_probe()
    patches, _ = probe.VARIANTS[variant]
    src = probe.variant_source(patches)
    with open(os.path.join(probe.CSRC_DIR, "flash_attention.cu")) as f:
        whole = f.read()
    assert "return launch_bf16<" in whole and "return launch_bf16<" not in src
    for old, new in patches:
        assert old not in src and new in src
    assert "flash_fwd_f32<DT, VEC><<<" in src


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
    """Causal cross-attention is rejected; the forward is K2's (its plain
    version here) bit for bit, and the backward — which this test's name
    predates — gives dense attention's gradient (tests/
    test_torch_flash_bwd.py holds it against the JAX package)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(23, 1, 1, 8, 12, 8))
    with pytest.raises(ValueError, match="ambiguous"):
        flash.flash_attention_trainable(q, k, v, True)
    qs = q.clone().requires_grad_(True)
    out = flash.flash_attention_trainable(qs, k, v, False)
    torch.testing.assert_close(out, flash.flash_attention(q, k, v), rtol=0, atol=0)
    out.sum().backward()
    qd = q.clone().requires_grad_(True)
    attention.dense_attention(qd, k, v).sum().backward()
    torch.testing.assert_close(qs.grad, qd.grad, rtol=0, atol=1e-6)


# --- K3's tensor-core arithmetic, emulated in f32 ------------------------------


def _bf16_cut(x):
    """x (f32) cut to its top 16 bits, a bf16 value, as the kernel cuts it."""
    return (x.view(torch.int32) & -65536).view(torch.float32).to(torch.bfloat16)


def _split3(p, to_bf16=_bf16_cut):
    """p (f32) split for K3's three bf16 P·V passes: hi = bf16(p), mid =
    bf16(p − hi), lo = bf16(p − hi − mid), each bf16 taken from the f32
    rest by ``to_bf16`` (the kernel cuts; rounding to nearest splits
    exactly too)."""
    parts = []
    for _ in range(3):
        part = to_bf16(p)
        parts.append(part)
        p = p - part.to(torch.float32)
    return parts, p


@pytest.mark.parametrize("to_bf16", [_bf16_cut, lambda x: x.to(torch.bfloat16)],
                         ids=["cut", "nearest"])
def test_three_bf16_parts_sum_back_exactly(to_bf16):
    """3 × 8 bits of significand hold an f32's 24: the parts add back to p
    exactly, with nothing left, from 1 down past 1e-20."""
    rng = np.random.default_rng(29)
    p = np.concatenate([
        rng.random(100_000),
        10.0 ** rng.uniform(-30, -20, 10_000),  # far below 1e-20
        [0.0, 1.0, 1e-20, 2.0 ** -126],
    ]).astype(np.float32)
    pt = torch.from_numpy(p)
    (hi, mid, lo), rest = _split3(pt, to_bf16)
    assert torch.all(rest == 0)
    assert torch.equal(hi.float() + mid.float() + lo.float(), pt)
    assert (pt < 1e-20).sum() >= 10_000


def _k3_emulated(q, k, v, m, l, acc, *, q_offset, k_offset, causal):
    """K3's bf16 path in f32, step by step: Q·Kᵀ of the unscaled bf16 q and
    k (exact products, f32 sums), s·(1/√D) in f32 after it, p in f32 with l
    summed from it, and P·V as three bf16 passes (hi, mid, lo) into one f32
    accumulator, each part cut from the f32 rest as the kernel cuts it;
    64-key tiles, causal tiles past the window skipped."""
    f32 = torch.float32
    s_q, d = q.shape[2], q.shape[3]
    scale = torch.tensor(1.0 / np.sqrt(d), dtype=f32)
    qf, kf, vf = (x.to(f32) for x in (q, k, v))
    m, l, acc = m[..., None].clone(), l[..., None].clone(), acc.clone()
    q_pos = q_offset + torch.arange(s_q)[:, None]
    for t in range(flash._live_key_tiles(s_q, k.shape[2], q_offset, k_offset, causal)):
        kt, vt = kf[:, :, 64 * t : 64 * t + 64], vf[:, :, 64 * t : 64 * t + 64]
        s = (qf @ kt.transpose(-1, -2)) * scale
        valid = (q_pos >= k_offset + 64 * t + torch.arange(kt.shape[2])[None, :]) if causal \
            else torch.ones(s.shape[-2:], dtype=torch.bool)
        s = torch.where(valid, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.where(m_new == m, 1.0, torch.exp(m - m_new))
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        for part in _split3(p)[0]:
            acc = acc + part.to(f32) @ vt
        m = m_new
    return m[..., 0], l[..., 0], acc


@pytest.mark.parametrize("causal", [True, False])
def test_k3_tensor_core_arithmetic_matches_plain_and_jax(causal):
    """The emulation of K3's split arithmetic against K3's plain version and
    the JAX package's flash_attention_step (Pallas, interpret mode) on the
    same bf16 inputs and carried state, at a ragged shape (S_q 80, S_k 72,
    D 40, so 1/√D is no power of two), within 1e-5 of max|state|."""
    rng = np.random.default_rng(31)
    b, h, s_q, s_k, d = 1, 2, 80, 72, 40
    q, k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32) for s in (s_q, s_k, s_k))
    m = rng.normal(size=(b, h, s_q)).astype(np.float32)
    l = (np.abs(rng.normal(size=(b, h, s_q))) + 0.5).astype(np.float32)
    acc = rng.normal(size=(b, h, s_q, d)).astype(np.float32)
    kw = dict(q_offset=40, k_offset=20, causal=causal)
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    state = tuple(torch.from_numpy(x) for x in (m, l, acc))
    got = _k3_emulated(qb, kb, vb, *state, **kw)
    plain = flash.flash_attention_step_plain(qb, kb, vb, *state, **kw)
    jax_out = jflash.flash_attention_step(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), *(jnp.asarray(x) for x in (m, l, acc)), **kw
    )
    for g, p_, j_ in zip(got, plain, jax_out):
        j_ = np.asarray(j_, np.float32)
        tol = F32_TOL * max(1.0, float(np.abs(j_).max()))
        np.testing.assert_allclose(g.numpy(), p_.numpy(), rtol=0, atol=tol)
        np.testing.assert_allclose(g.numpy(), j_, rtol=0, atol=tol)
