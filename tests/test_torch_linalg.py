"""keystone_tpu_torch's PCA, ZCA and LDA against the JAX package's on the
same numpy-seeded samples.

Tolerances: 1e-5 of max|out| for products of the SVD's factors. The ZCA
matrix does not depend on the singular vectors' signs; PCA fixes them by
the MATLAB rule, so its matrix is held as it is; LDA fixes none
(``torch.linalg.eigh`` and ``jnp.linalg.eigh`` may return opposite
columns), so its projection is held up to each column's sign."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.ops import linalg as j_linalg  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch.ops import linalg  # noqa: E402

TOL = 1e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _sample(seed, n, d):
    """Rows with distinct variances along d random directions: the leading
    16 singular values at least 5 % of the largest apart, so those
    singular vectors are defined to about 1e-6 in f32."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.normal(size=(d, d)))[0]
    lead = min(d, 16)
    scales = np.concatenate([np.linspace(8.0, 2.0, lead), np.linspace(1.0, 0.2, d - lead)])
    return ((rng.normal(size=(n, d)) * scales) @ basis.T + rng.normal(size=d)).astype(np.float32)


@pytest.mark.parametrize("n,d", [(500, 27), (2000, 108), (40, 12)])
def test_zca_matches_jax(n, d):
    x = _sample(n + d, n, d)
    got = linalg.ZCAWhitenerEstimator().fit(torch.from_numpy(x))
    want = j_linalg.ZCAWhitenerEstimator().fit(jnp.asarray(x))
    assert _rel(got.whitener.numpy(), np.asarray(want.whitener)) <= TOL
    assert _rel(got.means.numpy(), np.asarray(want.means)) <= TOL
    y = _sample(1, 7, d)
    want_y = np.asarray(want(jnp.asarray(y)))
    assert _rel(got(torch.from_numpy(y)).numpy(), want_y) <= TOL
    conv = convert.zca_whitener(np.asarray(want.whitener), np.asarray(want.means), device="cpu")
    assert _rel(conv(torch.from_numpy(y)).numpy(), want_y) <= TOL


def test_zca_whitens_the_sample():
    x = _sample(3, 4000, 16)
    w = linalg.ZCAWhitenerEstimator(eps=1e-6).fit(torch.from_numpy(x).double())
    cov = np.cov(w(torch.from_numpy(x).double()).numpy(), rowvar=False)
    np.testing.assert_allclose(cov, np.eye(16), atol=1e-4)


@pytest.mark.parametrize("n,d,dims", [(300, 20, 4), (1000, 64, 16), (30, 50, 10)])
def test_pca_matches_jax_with_the_matlab_sign(n, d, dims):
    x = _sample(n * d, n, d) if n >= d else np.random.default_rng(5).normal(
        size=(n, d)).astype(np.float32)
    got = linalg.PCAEstimator(dims=dims).fit(torch.from_numpy(x)).pca_mat.numpy()
    want = np.asarray(j_linalg.PCAEstimator(dims=dims).fit(jnp.asarray(x)).pca_mat)
    assert got.shape == want.shape == (d, min(dims, n, d))
    # the rule: each column's largest-magnitude entry is positive
    top = np.abs(got).argmax(axis=0)
    assert (got[top, np.arange(got.shape[1])] > 0).all()
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("n,d,block", [(5000, 24, 300), (1000, 64, 128), (640, 8, 100)])
def test_stacked_r_keeps_the_svd(n, d, block):
    """The blockwise QR the card takes for a tall sample past one
    ``gesvd`` call's size: the stacked Rs have at most ``block`` rows and
    the sample's singular values (1e-5 of the largest) and right singular
    subspace (the leading 4 directions' projector, 1e-5 of max)."""
    x = torch.from_numpy(_sample(n + d, n, d))
    x = x - x.mean(dim=0)
    r = linalg._stacked_r(x, block)
    assert r.shape[0] <= block and r.shape[1] == d
    _, s_want, vt_want = torch.linalg.svd(x.double(), full_matrices=False)
    _, s_got, vt_got = torch.linalg.svd(r.double(), full_matrices=False)
    assert _rel(s_got, s_want) <= TOL
    p_got, p_want = vt_got[:4].T @ vt_got[:4], vt_want[:4].T @ vt_want[:4]
    assert _rel(p_got, p_want) <= TOL
    with pytest.raises(ValueError, match="block_rows"):
        linalg._stacked_r(x, d)


def test_batch_pca_and_convert_match_jax():
    x = _sample(6, 400, 24)
    est = j_linalg.PCAEstimator(dims=5)
    mats = np.random.default_rng(7).normal(size=(3, 24, 9)).astype(np.float32)
    want = np.asarray(est.fit_batch(jnp.asarray(x))(jnp.asarray(mats)))
    got = linalg.PCAEstimator(dims=5).fit_batch(torch.from_numpy(x))(torch.from_numpy(mats))
    assert _rel(got.numpy(), want) <= TOL
    pca = np.asarray(est.fit(jnp.asarray(x)).pca_mat)
    conv = convert.pca_transformer(pca, batch=True, device="cpu")
    assert isinstance(conv, linalg.BatchPCATransformer)
    assert _rel(conv(torch.from_numpy(mats)).numpy(), want) <= TOL
    rows = convert.pca_transformer(pca, device="cpu")(torch.from_numpy(x))
    assert _rel(rows.numpy(), np.asarray(est.fit(jnp.asarray(x))(jnp.asarray(x)))) <= TOL


@pytest.mark.parametrize("classes,dims", [(3, 2), (5, 3)])
def test_lda_matches_jax_up_to_column_signs(classes, dims):
    rng = np.random.default_rng(classes)
    d, n = 10, 600
    labels = rng.integers(0, classes, size=n)
    centers = rng.normal(scale=3.0, size=(classes, d))
    x = (centers[labels] + rng.normal(size=(n, d)) * np.linspace(0.5, 2.0, d)).astype(np.float32)
    got = linalg.LinearDiscriminantAnalysis(num_dimensions=dims).fit(torch.from_numpy(x), labels)
    want = j_linalg.LinearDiscriminantAnalysis(num_dimensions=dims).fit(jnp.asarray(x), labels)
    w, wj = got.x.numpy(), np.asarray(want.x)
    assert w.shape == wj.shape == (d, dims)
    signs = np.sign((w * wj).sum(axis=0))
    assert (signs != 0).all()
    assert _rel(w * signs, wj) <= TOL
    proj = got(torch.from_numpy(x)).numpy() * signs
    assert _rel(proj, np.asarray(want(jnp.asarray(x)))) <= TOL
