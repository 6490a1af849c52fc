"""keystone_tpu_torch's class-weighted block solver against the JAX
package's (``ops/weighted_linear.py``): the class-sorted grid and the
masked fallback, the Woodbury and dense solve paths (dense with and
without the pass-invariant hoist), 1 and 3 passes, mixture weights 0.25
and 0.5, a warm start, row-order invariance, and the ``fit_stats_*``
protocol. Inputs come from numpy seeds; the JAX side runs on the CPU in
float32 as the port does.

Tolerances: weights and intercepts within 1e-4 of max|W| (float32 sums
taken in another order through a few passes of solves); predicted
classes equal wherever the top two scores differ by more than 1e-4."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keystone_tpu.ops import weighted_linear as jw  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch.ops import weighted_linear as tw  # noqa: E402

TOL = 1e-4  # of max|W|
MARGIN = 1e-4


def _data(seed, n, d, c, dominant=None):
    """Class-clustered rows and ±1 indicators; ``dominant`` puts that
    share of the rows in class 0 (heavy imbalance: no class grid)."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, c, size=n)
    if dominant is not None:
        cls[: int(dominant * n)] = 0
        rng.shuffle(cls)
    centers = rng.normal(size=(c, d)) * 2
    a = (centers[cls] + rng.normal(size=(n, d))).astype(np.float32)
    y = -np.ones((n, c), np.float32)
    y[np.arange(n), cls] = 1.0
    return a, y


def _flat(xs):
    return np.concatenate([np.asarray(x, np.float64) for x in xs], axis=0)


def _check(port_model, jax_xs, jax_b, a):
    """Weights and intercept within TOL of max|W|; argmax equal where the
    JAX scores' top-two margin exceeds MARGIN."""
    x_p, x_j = _flat(port_model.xs), _flat(jax_xs)
    b_p, b_j = port_model.b.numpy().astype(np.float64), np.asarray(jax_b, np.float64)
    scale = max(np.abs(x_j).max(), 1e-30)
    assert np.abs(x_p - x_j).max() <= TOL * scale, np.abs(x_p - x_j).max() / scale
    assert np.abs(b_p - b_j).max() <= TOL * max(scale, np.abs(b_j).max())
    s_j = a.astype(np.float64) @ x_j + b_j
    s_p = port_model(torch.from_numpy(a)).numpy()
    top2 = np.sort(s_j, axis=1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > MARGIN
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(s_p.argmax(1)[sure], s_j.argmax(1)[sure])


# (n, d, c, block_size, num_iter, mixture_weight, lam, class_chunk,
#  dominant share, the layout and per-block solve paths the port takes)
CASES = {
    "grid-dense-1": (90, 11, 3, 11, 1, 0.5, 0.1, 2, None, "grid", ["dense"]),
    "grid-dense-hoisted-3": (90, 11, 3, 4, 3, 0.25, 0.1, 2, None, "grid",
                             ["dense_hoisted"] * 3),
    "grid-woodbury-1": (400, 160, 8, 160, 1, 0.25, 0.2, 4, None, "grid", ["woodbury"]),
    "grid-woodbury-3": (400, 160, 8, 160, 3, 0.5, 0.2, 3, None, "grid", ["woodbury"]),
    "grid-woodbury-dense-3": (250, 260, 5, 160, 3, 0.25, 0.1, 2, None, "grid",
                              ["woodbury", "dense_hoisted"]),
    "masked-1": (200, 12, 4, 12, 1, 0.5, 0.1, 2, 0.85, "masked", ["dense"]),
    "masked-hoisted-3": (200, 12, 4, 5, 3, 0.25, 0.1, 3, 0.85, "masked",
                         ["dense_hoisted"] * 3),
}


def _estimators(case):
    n, d, c, bs, it, w, lam, chunk = CASES[case][:8]
    kw = dict(block_size=bs, num_iter=it, lam=lam, mixture_weight=w, class_chunk=chunk)
    return jw.BlockWeightedLeastSquaresEstimator(**kw), tw.BlockWeightedLeastSquaresEstimator(**kw)


@pytest.mark.parametrize("case", list(CASES))
def test_weighted_fit_matches_jax(case):
    n, d, c, bs, *_, dominant, layout, solves = CASES[case]
    a, y = _data(7, n, d, c, dominant)
    j_est, t_est = _estimators(case)
    path = tw.fit_path(t_est, torch.from_numpy(y), d)
    assert path["layout"] == layout
    assert [b["solve"] for b in path["blocks"]] == solves
    want = j_est.fit(jnp.asarray(a), jnp.asarray(y))
    got = t_est.fit(torch.from_numpy(a), torch.from_numpy(y))
    _check(got, want.xs, want.b, a)


def test_weighted_masked_path_matches_jax_masked_path():
    """The masked fallback forced on balanced labels (the JAX package
    takes it for traced labels) agrees with the JAX package's, and with
    the port's grid fit of the same data."""
    a, y = _data(3, 77, 9, 5)
    args = (None, None, None, 5, 4, 0.1, 0.4, 2)
    xs_j, b_j = jax.jit(lambda a_, y_: jw._weighted_bcd_fit(a_, y_, *args))(
        jnp.asarray(a), jnp.asarray(y)
    )
    with tw._matmul_precision(None):
        xs_t, b_t = tw._weighted_bcd_fit(torch.from_numpy(a), torch.from_numpy(y), *args)
    _check(convert.block_weighted_mapper(
        [x.numpy() for x in xs_t], b_t.numpy(), block_size=5, device="cpu"), xs_j, b_j, a)
    grid = tw.BlockWeightedLeastSquaresEstimator(
        block_size=5, num_iter=4, lam=0.1, mixture_weight=0.4, class_chunk=2
    ).fit(torch.from_numpy(a), torch.from_numpy(y))
    scale = np.abs(_flat(xs_t)).max()
    assert np.abs(_flat(grid.xs) - _flat(xs_t)).max() <= TOL * scale


@pytest.mark.parametrize("case", ["grid-woodbury-1", "grid-dense-hoisted-3", "masked-1"])
def test_weighted_warm_start_matches_jax(case):
    """``init`` given: the JAX fit's one-pass model carried across and fit
    from on both sides."""
    n, d, c, bs, *_, dominant, _, _ = CASES[case]
    a, y = _data(11, n, d, c, dominant)
    j_est, t_est = _estimators(case)
    init = jw.BlockWeightedLeastSquaresEstimator(
        block_size=bs, num_iter=1, lam=0.5, mixture_weight=0.3, class_chunk=2
    ).fit(jnp.asarray(a), jnp.asarray(y))
    t_init = convert.block_weighted_mapper(
        [np.asarray(x) for x in init.xs], np.asarray(init.b), block_size=bs, device="cpu"
    )
    want = j_est.fit(jnp.asarray(a), jnp.asarray(y), init=init)
    got = t_est.fit(torch.from_numpy(a), torch.from_numpy(y), init=t_init)
    _check(got, want.xs, want.b, a)


@pytest.mark.parametrize("case", ["grid-woodbury-3", "masked-1"])
def test_weighted_invariant_to_row_permutation(case):
    n, d, c, *_, dominant, _, _ = CASES[case]
    a, y = _data(5, n, d, c, dominant)
    _, t_est = _estimators(case)
    m1 = t_est.fit(torch.from_numpy(a), torch.from_numpy(y))
    perm = np.random.default_rng(0).permutation(n)
    m2 = t_est.fit(torch.from_numpy(a[perm]), torch.from_numpy(y[perm]))
    scale = np.abs(_flat(m1.xs)).max()
    assert np.abs(_flat(m2.xs) - _flat(m1.xs)).max() <= TOL * scale
    assert np.abs(m2.b.numpy() - m1.b.numpy()).max() <= TOL * max(scale, 1.0)


def test_weighted_padded_rows_are_ignored():
    """``n_valid`` keeps trailing pad rows out of the fit: the padded fit
    equals the JAX package's padded fit and the port's unpadded one."""
    a, y = _data(9, 61, 6, 3)
    pad_a = np.concatenate([a, np.zeros((3, 6), np.float32)])
    pad_y = np.concatenate([y, -np.ones((3, 3), np.float32)])
    kw = dict(block_size=6, num_iter=3, lam=0.1, mixture_weight=0.4, class_chunk=3)
    want = jw.BlockWeightedLeastSquaresEstimator(**kw).fit(
        jnp.asarray(pad_a), jnp.asarray(pad_y), n_valid=61)
    t_est = tw.BlockWeightedLeastSquaresEstimator(**kw)
    got = t_est.fit(torch.from_numpy(pad_a), torch.from_numpy(pad_y), n_valid=61)
    _check(got, want.xs, want.b, a)
    plain = t_est.fit(torch.from_numpy(a), torch.from_numpy(y))
    assert np.abs(_flat(got.xs) - _flat(plain.xs)).max() <= TOL * np.abs(_flat(plain.xs)).max()


def _weighted_gradient(a, y, x, b, lam, w):
    """The reference's computeGradient: weight (1−w)/n everywhere plus
    w/n_c on the own-class column; Aᵀ((AX + b − Y)∘W) + λX."""
    n = a.shape[0]
    cls = y.argmax(1)
    counts = np.bincount(cls, minlength=y.shape[1]).astype(np.float64)
    wts = np.full_like(y, (1.0 - w) / n, dtype=np.float64)
    wts[np.arange(n), cls] += w / counts[cls]
    return a.T @ ((a @ x + b - y) * wts) + lam * x


def test_weighted_solution_has_zero_gradient():
    a, y = _data(1, 90, 11, 3)
    model = tw.BlockWeightedLeastSquaresEstimator(
        block_size=4, num_iter=20, lam=0.1, mixture_weight=0.3, class_chunk=2
    ).fit(torch.from_numpy(a), torch.from_numpy(y))
    grad = _weighted_gradient(a.astype(np.float64), y.astype(np.float64), _flat(model.xs),
                              model.b.numpy().astype(np.float64), 0.1, 0.3)
    assert np.linalg.norm(grad) < 1e-2, np.linalg.norm(grad)


def test_woodbury_matches_exact_optimum():
    """The Woodbury path at 30 passes lands on the closed-form
    weighted-ridge optimum (the JAX package's own test and tolerance)."""
    n, d, c, lam, w = 400, 160, 8, 0.2, 0.35
    a, y = _data(2, n, d, c)
    a1 = np.concatenate([a.astype(np.float64), np.ones((n, 1))], axis=1)
    cls = y.argmax(1)
    counts = np.bincount(cls, minlength=c)
    x_opt, b_opt = np.zeros((d, c)), np.zeros(c)
    for k in range(c):
        wts = np.full(n, (1 - w) / n)
        wts[cls == k] += w / counts[k]
        reg = np.eye(d + 1) * lam
        reg[d, d] = 0.0
        sol = np.linalg.solve((a1.T * wts) @ a1 + reg, a1.T @ (wts * y[:, k]))
        x_opt[:, k], b_opt[k] = sol[:d], sol[d]
    est = tw.BlockWeightedLeastSquaresEstimator(
        block_size=d, num_iter=30, lam=lam, mixture_weight=w, class_chunk=4)
    assert tw.fit_path(est, torch.from_numpy(y), d)["blocks"][0]["solve"] == "woodbury"
    model = est.fit(torch.from_numpy(a), torch.from_numpy(y))
    scale = max(np.abs(x_opt).max(), 1.0)
    np.testing.assert_allclose(model.xs[0].numpy(), x_opt, atol=5e-3 * scale)
    np.testing.assert_allclose(model.b.numpy(), b_opt, atol=5e-3)


def test_woodbury_multichunk_matches_single_chunk(monkeypatch):
    """The Woodbury class grouping is a scheduling choice: a budget that
    forces 3 groups gives the one-group fit."""
    a, y = _data(4, 419, 160, 8)
    kw = dict(block_size=160, num_iter=3, lam=0.15, mixture_weight=0.4)
    one = tw.BlockWeightedLeastSquaresEstimator(class_chunk=8, **kw)
    m_one = one.fit(torch.from_numpy(a), torch.from_numpy(y))
    monkeypatch.setattr(tw, "_WOODBURY_CHUNK_BUDGET", 1)
    multi = tw.BlockWeightedLeastSquaresEstimator(class_chunk=3, **kw)
    assert tw.fit_path(multi, torch.from_numpy(y), 160)["blocks"][0]["class_chunks"] == 3
    m_multi = multi.fit(torch.from_numpy(a), torch.from_numpy(y))
    scale = np.abs(_flat(m_one.xs)).max()
    assert np.abs(_flat(m_multi.xs) - _flat(m_one.xs)).max() <= TOL * scale


def _accumulate(est, a, y, chunk, n_valid=None, torch_side=False):
    n = a.shape[0]
    n_ok = n if n_valid is None else n_valid
    state = est.fit_stats_init(a.shape[1], y.shape[1], **({"device": "cpu"} if torch_side else {}))
    for s in range(0, n, chunk):
        a_c, y_c = a[s : s + chunk], y[s : s + chunk]
        valid = max(0, min(n_ok - s, len(a_c)))
        if torch_side:
            a_c, y_c = torch.from_numpy(a_c), torch.from_numpy(y_c)
        else:
            a_c, y_c = jnp.asarray(a_c), jnp.asarray(y_c)
        state = est.fit_stats_update(state, a_c, y_c, n_valid=valid)
    return state


STATE_LEAVES = ("ata", "at_labels", "class_ata", "class_sum", "sum_a", "n_c", "n")


@pytest.mark.parametrize("block_size,num_iter,w", [(14, 1, 0.3), (6, 2, 0.5)])
def test_weighted_fit_stats_match_jax(block_size, num_iter, w):
    """The accumulated state equals the JAX package's (1e-5 of each
    leaf's max); the port's finalize of the JAX state equals the JAX
    finalize at TOL; the streamed fit agrees with the one-shot fit at the
    JAX package's own streaming tolerance (2e-3 of max|W|: the Gram form
    takes the covariances by subtraction)."""
    n, d, c = 380, 14, 5
    a, y = _data(6, n, d, c)
    kw = dict(block_size=block_size, num_iter=num_iter, lam=0.5, mixture_weight=w)
    j_est = jw.BlockWeightedLeastSquaresEstimator(**kw)
    t_est = tw.BlockWeightedLeastSquaresEstimator(**kw)
    j_state = _accumulate(j_est, a, y, 128, n_valid=370)
    t_state = _accumulate(t_est, a, y, 128, n_valid=370, torch_side=True)
    for leaf in STATE_LEAVES:
        want = np.asarray(getattr(j_state, leaf), np.float64)
        got = getattr(t_state, leaf).numpy().astype(np.float64)
        assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0), leaf
    assert t_est.fit_stats_state_bytes(d, c) == j_est.fit_stats_state_bytes(d, c)
    assert t_est.fit_stats_flops_per_row(d, c) == j_est.fit_stats_flops_per_row(d, c)

    want = j_est.fit_stats_finalize(j_state)
    carried = convert.weighted_eq_state(
        *(np.asarray(getattr(j_state, leaf)) for leaf in STATE_LEAVES), device="cpu")
    _check(t_est.fit_stats_finalize(carried), want.xs, want.b, a[:370])
    one = t_est.fit(torch.from_numpy(a[:370]), torch.from_numpy(y[:370]))
    streamed = t_est.fit_stats_finalize(t_state)
    scale = np.abs(_flat(one.xs)).max()
    assert np.abs(_flat(streamed.xs) - _flat(one.xs)).max() <= 2e-3 * scale
