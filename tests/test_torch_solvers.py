"""keystone_tpu_torch's exact ridge solver, the λ sweeps, the solver
dispatch and λ selection (ops/linear.py, evaluation/model_selection.py,
core/checkpoint.py) against the JAX package on the same seeded numpy
inputs.

Tolerance: 1e-4 of max|x|, as ``test_torch_linear.py`` holds the solver
core — both sides solve in f32 with other LAPACK blockings, and two
refinement steps bound the difference to a few ulps times the
equilibrated system's condition number. Validation errors and the chosen
λ are held exactly: the models are that close, and the validation rows
sit far from any decision boundary.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.core.checkpoint import checkpointed_fit as j_checkpointed_fit  # noqa: E402
from keystone_tpu.evaluation import model_selection as jms  # noqa: E402
from keystone_tpu.ops import linear as jl  # noqa: E402
from keystone_tpu.ops.util import ClassLabelIndicators as JCLI  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch.core.checkpoint import checkpointed_fit  # noqa: E402
from keystone_tpu_torch.evaluation import model_selection as tms  # noqa: E402
from keystone_tpu_torch.ops import linear as tl  # noqa: E402
from keystone_tpu_torch.ops.util import ClassLabelIndicators  # noqa: E402

TOL = 1e-4
LAMS = [0.01, 0.5, 20.0]


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * max(float(np.abs(want).max()), 1e-30)


def _problem(seed, n=300, d=24, k=3, pad=0):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(n, d)) + 2.0).astype(np.float32)
    x = rng.normal(size=(d, k)).astype(np.float32)
    b = (a @ x + 0.3 * rng.normal(size=(n, k))).astype(np.float32)
    a[n - pad :] = 0.0
    b[n - pad :] = 0.0
    return a, b


def _classes(seed, n=400, d=30, k=4):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, size=n).astype(np.int32)
    centers = rng.normal(size=(k, d))
    a = (centers[y] * 0.8 + rng.normal(size=(n, d))).astype(np.float32)
    return a, y


def _mapper_close(tm, jm):
    _close(tm.x, jm.x)
    _close(tm.b, jm.b)
    _close(tm.feature_scaler.mean, jm.feature_scaler.mean)
    assert tm.feature_scaler.std is None and jm.feature_scaler.std is None


@pytest.mark.parametrize("n_valid", [None, 260])
def test_linear_map_fit_and_sweep_match_jax(n_valid):
    a, b = _problem(0, pad=0 if n_valid is None else 40)
    jm = jl.LinearMapEstimator(lam=0.3).fit(jnp.asarray(a), jnp.asarray(b), n_valid=n_valid)
    tm = tl.LinearMapEstimator(lam=0.3).fit(torch.from_numpy(a), torch.from_numpy(b), n_valid=n_valid)
    _mapper_close(tm, jm)
    _close(tm(torch.from_numpy(a)), jm(jnp.asarray(a)))
    jms_ = jl.LinearMapEstimator().fit_sweep(jnp.asarray(a), jnp.asarray(b), LAMS, n_valid=n_valid)
    tms_ = tl.LinearMapEstimator().fit_sweep(torch.from_numpy(a), torch.from_numpy(b), LAMS, n_valid=n_valid)
    assert len(tms_) == len(jms_) == len(LAMS)
    for t, j in zip(tms_, jms_):
        _mapper_close(t, j)


def test_linear_map_streaming_protocol_matches_jax():
    a, b = _problem(1, n=500)
    jest, test_ = jl.LinearMapEstimator(lam=0.2), tl.LinearMapEstimator(lam=0.2)
    jstate = jest.fit_stats_init(24, 3)
    tstate = test_.fit_stats_init(24, 3, device="cpu")
    for s in range(0, 500, 128):
        jstate = jest.fit_stats_update(jstate, jnp.asarray(a[s : s + 128]), jnp.asarray(b[s : s + 128]))
        tstate = test_.fit_stats_update(tstate, torch.from_numpy(a[s : s + 128]), torch.from_numpy(b[s : s + 128]))
    _mapper_close(test_.fit_stats_finalize(tstate), jest.fit_stats_finalize(jstate))
    for t, j in zip(test_.fit_sweep_finalize(tstate, LAMS), jest.fit_sweep_finalize(jstate, LAMS)):
        _mapper_close(t, j)
    assert test_.fit_stats_state_bytes(24, 3) == jest.fit_stats_state_bytes(24, 3)
    assert test_.fit_stats_flops_per_row(24, 3) == jest.fit_stats_flops_per_row(24, 3)
    # the finalized model is the one-shot fit
    _mapper_close(test_.fit_stats_finalize(tstate), jest.fit(jnp.asarray(a), jnp.asarray(b)))


def test_stabilized_cho_solve_matches_jax():
    a, b = _problem(2)
    m = a.T @ a
    got = tl.stabilized_cho_solve(torch.from_numpy(m))(torch.from_numpy(a.T @ b))
    _close(got, jl.stabilized_cho_solve(jnp.asarray(m))(jnp.asarray(a.T @ b)))


@pytest.mark.parametrize("sweep_chunk,num_iter", [(None, 1), (2, 3)])
def test_block_lambda_sweep_matches_jax(sweep_chunk, num_iter):
    a, b = _problem(3, n=320, d=40, k=5, pad=20)
    blocks_j = [jnp.asarray(a[:, s : s + 16]) for s in range(0, 40, 16)]
    blocks_t = [torch.from_numpy(a[:, s : s + 16]) for s in range(0, 40, 16)]
    jmodels = jl.BlockLeastSquaresEstimator(block_size=16, num_iter=num_iter).fit_sweep(
        blocks_j, jnp.asarray(b), LAMS, n_valid=300, sweep_chunk=sweep_chunk
    )
    tmodels = tl.BlockLeastSquaresEstimator(block_size=16, num_iter=num_iter).fit_sweep(
        blocks_t, torch.from_numpy(b), LAMS, n_valid=300, sweep_chunk=sweep_chunk
    )
    assert len(tmodels) == len(jmodels) == len(LAMS)
    for lam, tm, jm in zip(LAMS, tmodels, jmodels):
        for x_t, x_j in zip(tm.xs, jm.xs):
            _close(x_t, x_j)
        _close(tm.b, jm.b)
        _close(tm(blocks_t), jm(blocks_j))
        # each swept model is the single fit at its λ
        single = tl.BlockLeastSquaresEstimator(block_size=16, num_iter=num_iter, lam=lam).fit(
            blocks_t, torch.from_numpy(b), n_valid=300
        )
        for x_t, x_s in zip(tm.xs, single.xs):
            _close(x_t, x_s)


def test_block_sweep_finalize_matches_jax_and_the_single_fit():
    a, b = _problem(4, n=400, d=40, k=3)
    state = jl.normal_eq_update(jl.normal_eq_init(40, 3), jnp.asarray(a), jnp.asarray(b))
    tstate = convert.normal_eq_state(*(np.asarray(v) for v in (state.ata, state.atb, state.mean_a, state.mean_b, state.n)), device="cpu")
    jest = jl.BlockLeastSquaresEstimator(block_size=16, num_iter=2)
    test_ = tl.BlockLeastSquaresEstimator(block_size=16, num_iter=2)
    jmodels = jest.fit_sweep_finalize(state, LAMS)
    tmodels = test_.fit_sweep_finalize(tstate, LAMS)
    for tm, jm in zip(tmodels, jmodels):
        for x_t, x_j in zip(tm.xs, jm.xs):
            _close(x_t, x_j)
    # fit_stats_finalize is the sweep's one-λ case, bit for bit
    for lam, tm in zip(LAMS, tmodels):
        one = tl.BlockLeastSquaresEstimator(block_size=16, num_iter=2, lam=lam).fit_stats_finalize(tstate)
        for x_t, x_1 in zip(tm.xs, one.xs):
            assert torch.equal(x_t, x_1)


@pytest.mark.parametrize("d,blocked", [(24, False), (40, False), (24, True)])
def test_least_squares_dispatch_matches_jax(d, blocked):
    a, b = _problem(5, d=d)
    data_j = [jnp.asarray(a)] if blocked else jnp.asarray(a)
    data_t = [torch.from_numpy(a)] if blocked else torch.from_numpy(a)
    jm = jl.LeastSquaresEstimator(lam=0.1, block_size=32).fit(data_j, jnp.asarray(b))
    tm = tl.LeastSquaresEstimator(lam=0.1, block_size=32).fit(data_t, torch.from_numpy(b))
    assert type(tm).__name__ == type(jm).__name__
    _close(tm(data_t), jm(data_j))


@pytest.mark.parametrize("blocked", [False, True])
def test_holdout_lambda_sweep_matches_jax(blocked):
    a, y = _classes(6)
    lams = "0.001, 1,100,1e4"
    jy, ty = JCLI(num_classes=4)(y), ClassLabelIndicators(num_classes=4)(y)
    if blocked:
        est_j, est_t = jl.BlockLeastSquaresEstimator(block_size=16), tl.BlockLeastSquaresEstimator(block_size=16)
        xj = [jnp.asarray(a[:, s : s + 16]) for s in range(0, 30, 16)]
        xt = [torch.from_numpy(a[:, s : s + 16]) for s in range(0, 30, 16)]
    else:
        est_j, est_t = jl.LinearMapEstimator(), tl.LinearMapEstimator()
        xj, xt = jnp.asarray(a), torch.from_numpy(a)
    want = jms.holdout_lambda_sweep(est_j, xj, jy, y, lams, n_train=380, num_classes=4)
    got = tms.holdout_lambda_sweep(est_t, xt, ty, y, lams, n_train=380, num_classes=4)
    assert got == want
    assert got["lams"] == [0.001, 1.0, 100.0, 1e4]
    assert got["val_errors"][-1] > got["best_error"]


def test_holdout_lambda_sweep_with_a_scorer_and_bad_input():
    a, y = _classes(7)
    ty = ClassLabelIndicators(num_classes=4)(y)
    seen = []

    def scorer(model, val_inputs, rows):
        seen.append(rows)
        return float(((model(val_inputs) - ty[rows[0] : rows[1]]) ** 2).mean())

    report = tms.holdout_lambda_sweep(
        tl.LinearMapEstimator(), torch.from_numpy(a), ty, y, [0.1, 1e5], n_train=400, scorer=scorer
    )
    assert seen == [(360, 400)] * 2 and report["best_lam"] == 0.1
    with pytest.raises(ValueError, match="no values"):
        tms.holdout_lambda_sweep(tl.LinearMapEstimator(), a, ty, y, " , ", n_train=400, num_classes=4)
    with pytest.raises(ValueError, match="holdout is empty"):
        tms.holdout_lambda_sweep(tl.LinearMapEstimator(), a, ty, y, [1.0], n_train=5, num_classes=4)
    with pytest.raises(ValueError, match="num_classes"):
        tms.holdout_lambda_sweep(tl.LinearMapEstimator(), a, ty, y, [1.0], n_train=400)


def test_select_lambda_returns_the_best_model():
    a, y = _classes(8)
    ty = ClassLabelIndicators(num_classes=4)(y)
    x = torch.from_numpy(a)
    model, report = tms.select_lambda(
        tl.LinearMapEstimator(), x[:300], ty[:300], [1e-3, 1e6], x[300:], y[300:], num_classes=4
    )
    assert report["best_lam"] == 1e-3 and report["val_errors"][1] > report["val_errors"][0]
    _close(model.x, tl.LinearMapEstimator(lam=1e-3).fit(x[:300], ty[:300]).x)


def test_checkpointed_fit_without_a_directory_is_the_fit(tmp_path):
    a, b = _problem(9, d=32)
    est = tl.BlockLeastSquaresEstimator(block_size=16, num_iter=2, lam=0.1)
    got = checkpointed_fit(est, torch.from_numpy(a), torch.from_numpy(b), n_valid=250)
    want = est.fit(torch.from_numpy(a), torch.from_numpy(b), n_valid=250)
    for g, w in zip(got.xs, want.xs):
        assert torch.equal(g, w)
    jwant = j_checkpointed_fit(
        jl.BlockLeastSquaresEstimator(block_size=16, num_iter=2, lam=0.1),
        jnp.asarray(a), jnp.asarray(b), n_valid=250,
    )
    for g, w in zip(got.xs, jwant.xs):
        _close(g, w)
    # with a directory it is the resumable fit, which continues the same
    # fixed point pass by pass (held in tests/test_torch_checkpoint.py)
    ck = checkpointed_fit(est, torch.from_numpy(a), torch.from_numpy(b), n_valid=250,
                          checkpoint_dir=str(tmp_path / "ck"))
    for g, w in zip(ck.xs, want.xs):
        _close(g, w)
