"""keystone_tpu_torch's GMM and Fisher vectors against the JAX package's:
the log posteriors, EM from the JAX package's own start, the Fisher
vectors and the CSV artifacts read by both packages — the same
numpy-seeded inputs through both, on the CPU.

Tolerances: 1e-5 of max|out| for one pass (float32 products and sums
taken in another order); EM's means 1e-4 of max|mean| after 5 and 100
iterations (the per-iteration differences compound); the CSV round trip
exactly (``np.savetxt`` writes 18 significant digits); the planted
mixture the JAX package's own test's tolerances
(``tests/test_gmm_fisher.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.ops import gmm as j_gmm  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch.ops import gmm  # noqa: E402

TOL = 1e-5  # of max|out|
EM_TOL = 1e-4  # of max|mean|


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _planted_mixture(rng, n=2000):
    """Two well-separated 2-D gaussians (the JAX package's planted test)."""
    c1 = rng.normal(loc=(-5.0, -4.0), scale=0.5, size=(n // 2, 2))
    c2 = rng.normal(loc=(4.0, 6.0), scale=0.8, size=(n // 2, 2))
    return np.concatenate([c1, c2]).astype(np.float32)


def _random_gmm(rng, d, k):
    means = rng.normal(size=(d, k)).astype(np.float32)
    variances = (0.5 + rng.random((d, k))).astype(np.float32)
    weights = rng.dirichlet(np.ones(k)).astype(np.float32)
    return means, variances, weights


def _both(means, variances, weights):
    theirs = j_gmm.GaussianMixtureModel(means=jnp.asarray(means), variances=jnp.asarray(variances),
                                        weights=jnp.asarray(weights))
    return theirs, convert.gmm(means, variances, weights, device="cpu")


@pytest.mark.parametrize("n,d,k", [(300, 4, 3), (500, 16, 8)])
def test_log_responsibilities_match_jax(n, d, k):
    rng = np.random.default_rng(n + d + k)
    theirs, ours = _both(*_random_gmm(rng, d, k))
    x = rng.normal(size=(n, d)).astype(np.float32)
    want = np.asarray(theirs.log_responsibilities(jnp.asarray(x)))
    assert _rel(ours.log_responsibilities(torch.from_numpy(x)).numpy(), want) <= TOL
    np.testing.assert_allclose(ours(torch.from_numpy(x)).numpy().sum(1), 1.0, atol=1e-5)


@pytest.mark.parametrize("iters", [5, 100])
def test_em_from_the_jax_start_matches_jax(iters):
    """The port's EM loop from the JAX package's ``gmm_init`` output: the
    init's draw (``jax.random.choice``) is carried across, not redrawn."""
    x = _planted_mixture(np.random.default_rng(42))
    k, seed, floor = 2, 42, j_gmm.VAR_FLOOR
    want = [np.asarray(a) for a in j_gmm._gmm_em(jnp.asarray(x), k, iters, seed, floor)]
    init = [torch.from_numpy(np.array(a)) for a in j_gmm.gmm_init(jnp.asarray(x), k, seed, floor)]
    got = [a.numpy() for a in gmm.gmm_em(torch.from_numpy(x), *init, iters, floor)]
    assert _rel(got[0], want[0]) <= EM_TOL
    assert _rel(got[1], want[1]) <= EM_TOL
    assert _rel(got[2], want[2]) <= EM_TOL


def test_em_on_descriptor_like_data_matches_jax():
    """More components than clusters, in more dimensions: EM from the JAX
    package's start for 5 iterations."""
    rng = np.random.default_rng(7)
    centers = rng.normal(scale=3.0, size=(6, 8))
    x = (centers[rng.integers(0, 6, 1500)] + rng.normal(size=(1500, 8))).astype(np.float32)
    want = [np.asarray(a) for a in j_gmm._gmm_em(jnp.asarray(x), 8, 5, 3, j_gmm.VAR_FLOOR)]
    init = [torch.from_numpy(np.array(a)) for a in j_gmm.gmm_init(jnp.asarray(x), 8, 3, j_gmm.VAR_FLOOR)]
    got = gmm.gmm_em(torch.from_numpy(x), *init, 5, j_gmm.VAR_FLOOR)
    assert _rel(got[0].numpy(), want[0]) <= EM_TOL


@pytest.mark.parametrize("n_imgs,d,m,k", [(2, 4, 30, 3), (3, 16, 50, 8)])
def test_fisher_vectors_match_jax(n_imgs, d, m, k):
    rng = np.random.default_rng(d * m + k)
    theirs, ours = _both(*_random_gmm(rng, d, k))
    desc = rng.normal(size=(n_imgs, d, m)).astype(np.float32)
    want = np.asarray(j_gmm._fisher_vectors(jnp.asarray(desc), theirs))
    got = gmm.FisherVector(gmm=ours)(torch.from_numpy(desc))
    assert tuple(got.shape) == (n_imgs, d, 2 * k)
    assert _rel(got.numpy(), want) <= TOL
    assert _rel(gmm.fisher_vectors(torch.from_numpy(desc), ours).numpy(), want) <= TOL


def test_csv_artifacts_read_by_both_packages(tmp_path):
    rng = np.random.default_rng(0)
    means, variances, weights = _random_gmm(rng, 5, 3)
    theirs, ours = _both(means, variances, weights)
    ours_paths = [str(tmp_path / f"ours_{f}.csv") for f in "mvw"]
    theirs_paths = [str(tmp_path / f"theirs_{f}.csv") for f in "mvw"]
    ours.save_csv(*ours_paths)
    theirs.save_csv(*theirs_paths)
    for a, b in zip(ours_paths, theirs_paths):
        assert open(a).read() == open(b).read()
    j_loaded = j_gmm.GaussianMixtureModel.load_csv(*ours_paths)
    t_loaded = gmm.GaussianMixtureModel.load_csv(*theirs_paths, device="cpu")
    for leaf, want in (("means", means), ("variances", variances), ("weights", weights)):
        np.testing.assert_array_equal(np.asarray(getattr(j_loaded, leaf)), want)
        np.testing.assert_array_equal(getattr(t_loaded, leaf).numpy(), want)
        assert getattr(t_loaded, leaf).dtype == torch.float32


def test_gmm_recovers_planted_mixture():
    """The port's own fit (its own init draw) at the JAX package's
    planted-mixture tolerances."""
    x = _planted_mixture(np.random.default_rng(42))
    fit = gmm.GaussianMixtureModelEstimator(k=2, max_iter=60).fit(torch.from_numpy(x))
    means = fit.means.numpy().T
    order = np.argsort(means[:, 0])
    np.testing.assert_allclose(means[order[0]], [-5, -4], atol=0.2)
    np.testing.assert_allclose(means[order[1]], [4, 6], atol=0.2)
    np.testing.assert_allclose(fit.weights.numpy().sum(), 1.0, atol=1e-5)
    np.testing.assert_allclose(fit.weights.numpy(), 0.5, atol=0.05)
    var = fit.variances.numpy().T[order]
    np.testing.assert_allclose(var[0], 0.25, atol=0.1)
    np.testing.assert_allclose(var[1], 0.64, atol=0.2)


def test_gmm_init_draws_distinct_seeded_samples():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(200, 3)).astype(np.float32))
    mu0, var0, w0 = gmm.gmm_init(x, 5, seed=9, var_floor=1e-5)
    again = gmm.gmm_init(x, 5, seed=9, var_floor=1e-5)
    assert all(torch.equal(a, b) for a, b in zip((mu0, var0, w0), again))
    rows = {tuple(r.tolist()) for r in mu0.T}
    assert len(rows) == 5 and rows <= {tuple(r.tolist()) for r in x}
    torch.testing.assert_close(var0, x.var(0, unbiased=False)[:, None].expand(3, 5))
    torch.testing.assert_close(w0, torch.full((5,), 0.2))
    assert not torch.equal(gmm.gmm_init(x, 5, seed=10, var_floor=1e-5)[0], mu0)


def test_soft_assignment():
    ours = convert.gmm(np.array([[-5.0, 5.0]]), np.ones((1, 2)), np.array([0.5, 0.5]), device="cpu")
    gamma = ours(torch.tensor([[-5.0], [5.0], [0.0]])).numpy()
    np.testing.assert_allclose(gamma.sum(1), 1.0, atol=1e-6)
    assert gamma[0, 0] > 0.99 and gamma[1, 1] > 0.99
    np.testing.assert_allclose(gamma[2], [0.5, 0.5], atol=1e-5)


def test_native_backends_raise(monkeypatch):
    """The native backends raise when the host library cannot be built
    (they never fall back to the device path), and an unknown backend
    raises; the working native path is held in ``test_torch_native.py``."""
    from keystone_tpu_torch.native import HostLibrary, enceval

    x = torch.zeros((10, 2))
    ours = convert.gmm(np.zeros((2, 2)), np.ones((2, 2)), np.array([0.5, 0.5]), device="cpu")
    broken = HostLibrary("missing", ["/nonexistent/enceval_host.cpp"], lambda lib: None)
    monkeypatch.setattr(enceval, "ENCEVAL_LIB", broken)
    with pytest.raises(RuntimeError, match="unavailable"):
        gmm.GaussianMixtureModelEstimator(k=2, backend="native").fit(x)
    with pytest.raises(RuntimeError, match="unavailable"):
        gmm.FisherVector(gmm=ours, backend="native")(torch.zeros((1, 2, 4)))
    with pytest.raises(ValueError, match="expected device\\|native"):
        gmm.GaussianMixtureModelEstimator(k=2, backend="ffi").fit(x)
