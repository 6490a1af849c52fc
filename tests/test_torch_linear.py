"""keystone_tpu_torch solver core (ops/linear.py — the module the int8
Gram feeds) against the JAX package on the same numpy inputs.

Tolerance: 1e-4 relative to max|x|. Both sides solve in f32 with
different LAPACK blockings for the Cholesky and the triangular solves;
two refinement steps bound the solution error to a few f32 ulps times
the equilibrated system's condition number, which these small
well-posed problems keep below 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.ops import gram as jg  # noqa: E402
from keystone_tpu.ops import linear as jl  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch.ops import gram as tg  # noqa: E402
from keystone_tpu_torch.ops import linear as tl  # noqa: E402

TOL = 1e-4


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _problem(seed, n=300, d=24, k=3):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(n, d)) + 2.0).astype(np.float32)
    x = rng.normal(size=(d, k)).astype(np.float32)
    b = (a @ x + 0.1 * rng.normal(size=(n, k))).astype(np.float32)
    return a, b


def test_escalating_cholesky_on_indefinite_gram():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(20, 4)).astype(np.float32)
    m = (v @ v.T).astype(np.float32)
    m -= 1e-3 * np.eye(20, dtype=np.float32)  # indefinite: base jitter fails
    (jc, _), jj = jl._cho_factor_escalating(jnp.asarray(m), 1e-6)
    tc, tj = tl._cho_factor_escalating(_t(m), 1e-6)
    assert float(jj) == pytest.approx(tj, rel=1e-6)
    assert tj > 1e-6
    assert not bool(torch.isnan(tc).any())
    # same factor up to layout: JAX keeps the upper factor, the port the lower
    _close(tc @ tc.T, np.asarray(jc).T @ np.asarray(jc))


@pytest.mark.parametrize("lam", [0.0, 0.5])
def test_ridge_solve_matches(lam):
    a, b = _problem(1)
    ata, atb = a.T @ a, a.T @ b
    want = jl.ridge_solve(jnp.asarray(ata), jnp.asarray(atb), lam)
    got = tl.ridge_solve(_t(ata), _t(atb), lam)
    _close(got, want)


def _chunks(a, b, chunk):
    for s in range(0, a.shape[0], chunk):
        ca, cb = a[s : s + chunk], b[s : s + chunk]
        valid = ca.shape[0]
        if valid < chunk:
            ca = np.pad(ca, [(0, chunk - valid), (0, 0)])
            cb = np.pad(cb, [(0, chunk - valid), (0, 0)])
        yield ca, cb, valid


@pytest.mark.parametrize("op", ["fp32", "int8"])
def test_normal_eq_update_matches(op):
    """Three chunks (the last ragged, masked by n_valid) through the
    streaming update, with the fp32 Gram and the int8 Gram."""
    a, b = _problem(2, n=700, d=32, k=4)
    jfn = None if op == "fp32" else jg.ata_int8_xla
    tfn = None if op == "fp32" else tg.ata_int8
    js = jl.normal_eq_init(32, 4)
    ts = tl.normal_eq_init(32, 4, device="cpu")
    for ca, cb, valid in _chunks(a, b, 256):
        js = jl.normal_eq_update(js, jnp.asarray(ca), jnp.asarray(cb), valid, jfn)
        ts = tl.normal_eq_update(ts, _t(ca), _t(cb), valid, tfn)
    for name in ("ata", "atb", "mean_a", "mean_b", "n"):
        _close(getattr(ts, name), getattr(js, name))
    assert float(ts.n) == 700.0


@pytest.mark.parametrize("num_iter,lam", [(1, 0.1), (3, 1.0)])
def test_bcd_fit_matches(num_iter, lam):
    a, b = _problem(3, n=250, d=40, k=3)
    a = np.pad(a, [(0, 6), (0, 0)])  # pad rows masked by n_valid
    b = np.pad(b, [(0, 6), (0, 0)])
    jm = jl.BlockLeastSquaresEstimator(block_size=16, num_iter=num_iter, lam=lam).fit(
        jnp.asarray(a), jnp.asarray(b), n_valid=250
    )
    tm = tl.BlockLeastSquaresEstimator(block_size=16, num_iter=num_iter, lam=lam).fit(
        _t(a), _t(b), n_valid=250
    )
    assert [x.shape[0] for x in tm.xs] == [16, 16, 8]
    for got, want in zip(tm.xs, jm.xs):
        _close(got, want)
    for got, want in zip(tm.means, jm.means):
        _close(got, want)
    _close(tm.b, jm.b)


@pytest.mark.parametrize("widths,num_iter", [((16, 16, 8), 1), ((20, 20), 2)])
def test_bcd_fit_gram_matches(widths, num_iter):
    a, b = _problem(4, n=300, d=40, k=3)
    a_c, b_c = a - a.mean(0), b - b.mean(0)
    ata, atb = a_c.T @ a_c, a_c.T @ b_c
    want = jl._bcd_fit_gram(
        jnp.asarray(ata), jnp.asarray(atb), jnp.asarray([0.3]), widths, num_iter
    )[0]
    got = tl._bcd_fit_gram(_t(ata), _t(atb), [0.3], widths, num_iter)[0]
    _close(got, want)


def test_fit_stats_finalize_from_converted_state():
    """The JAX state carried across by convert.py finalizes to the same
    block model."""
    a, b = _problem(5, n=400, d=36, k=2)
    jest = jl.BlockLeastSquaresEstimator(block_size=12, lam=0.2)
    state = jl.normal_eq_update(jl.normal_eq_init(36, 2), jnp.asarray(a), jnp.asarray(b))
    want = jest.fit_stats_finalize(state)
    tstate = convert.normal_eq_state(
        *(np.asarray(getattr(state, f)) for f in ("ata", "atb", "mean_a", "mean_b", "n")),
        device="cpu",
    )
    got = tl.BlockLeastSquaresEstimator(block_size=12, lam=0.2).fit_stats_finalize(tstate)
    for g, w in zip(got.xs, want.xs):
        _close(g, w)
    _close(got.b, want.b)


def test_block_linear_mapper_apply_matches():
    rng = np.random.default_rng(6)
    xs = [rng.normal(size=(w, 5)).astype(np.float32) for w in (8, 8, 3)]
    means = [rng.normal(size=(w,)).astype(np.float32) for w in (8, 8, 3)]
    bias = rng.normal(size=(5,)).astype(np.float32)
    data = rng.normal(size=(30, 19)).astype(np.float32)
    jmap = jl.BlockLinearMapper(
        xs=tuple(map(jnp.asarray, xs)), b=jnp.asarray(bias), means=tuple(map(jnp.asarray, means))
    )
    tmap = convert.block_linear_mapper(xs, bias, means, device="cpu")
    _close(tmap(_t(data)), jmap(jnp.asarray(data)), tol=1e-5)
    seen = []
    tmap.apply_and_evaluate(_t(data), seen.append)
    assert len(seen) == 3
    _close(seen[-1], jmap(jnp.asarray(data)), tol=1e-5)


def test_block_widths_and_split():
    assert tl.block_widths(40, 16) == jl.block_widths(40, 16) == (16, 16, 8)
    parts = tl.split_by_widths(torch.arange(10.0)[None], (4, 6))
    assert [p.shape[-1] for p in parts] == [4, 6]


def test_matmul_precision_knob(monkeypatch):
    """The env knob's names map as ``torch.set_float32_matmul_precision``
    maps them (read through the ``fp32_precision`` API the scope sets
    them by); the flags end as they began."""
    b = torch.backends
    before = torch.get_float32_matmul_precision()
    monkeypatch.setenv("KEYSTONE_MATMUL_PRECISION", "default")
    with tl._matmul_precision(None):
        assert (b.cuda.matmul.fp32_precision, b.mkldnn.matmul.fp32_precision) == ("tf32", "bf16")
    with tl._matmul_precision("highest"):
        assert (b.cuda.matmul.fp32_precision, b.mkldnn.matmul.fp32_precision) == ("ieee", "ieee")
    monkeypatch.delenv("KEYSTONE_MATMUL_PRECISION")
    with tl._matmul_precision(None):
        assert (b.cuda.matmul.fp32_precision, b.mkldnn.matmul.fp32_precision) == ("ieee", "ieee")
    assert torch.get_float32_matmul_precision() == before
    with pytest.raises(ValueError):
        with tl._matmul_precision("bogus"):
            pass
