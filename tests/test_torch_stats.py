"""keystone_tpu_torch's scaler, cosine random features and utility nodes
(ops/stats.py, ops/util.py) against the JAX package on the same seeded
numpy inputs.

Tolerances: the scaler's mean and std within 1e-6 of their scale and its
output within 1e-5 (f32 sums over a few hundred rows taken in another
order); cosine features within 8 f32 ulps of the largest sum |x|·|W|ᵀ +
|b|, absolute (the argument of the cosine is one f32 product summed in
another order, and the cosine's slope is at most 1 — Cauchy W makes that
sum large); the other nodes exact.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keystone_tpu.ops import stats as js  # noqa: E402
from keystone_tpu.ops import util as ju  # noqa: E402
from keystone_tpu_torch.ops import stats as ts  # noqa: E402
from keystone_tpu_torch.ops import util as tu  # noqa: E402


def _rows(shape, seed, scale=3.0, shift=1.0):
    return (shift + scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _near(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("n_valid", [None, 300, 173])
def test_standard_scaler_matches_jax(normalize, n_valid):
    x = _rows((300, 17), 0)
    x[:, 3] = 2.5  # a constant column: std below eps becomes 1
    if n_valid is not None:
        x[n_valid:] = 0.0  # pad rows
    jm = js.StandardScaler(normalize_std_dev=normalize).fit(jnp.asarray(x), n_valid=n_valid)
    tm = ts.StandardScaler(normalize_std_dev=normalize).fit(torch.from_numpy(x), n_valid=n_valid)
    _near(tm.mean, jm.mean, 1e-6)
    if normalize:
        _near(tm.std, jm.std, 1e-6)
        assert float(tm.std[3]) == 1.0 == float(jm.std[3])
    else:
        assert tm.std is None and jm.std is None
    _near(tm(torch.from_numpy(x)), jm(jnp.asarray(x)), 1e-5)


def test_masked_moments_are_population_moments():
    x = _rows((50, 4), 1)
    mean, var = ts._masked_moments(torch.from_numpy(x), 40)
    np.testing.assert_allclose(mean.numpy(), x[:40].mean(0), rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), x[:40].var(0), rtol=1e-5)


@pytest.mark.parametrize("distribution", ["gaussian", "cauchy"])
def test_cosine_features_on_carried_parameters(distribution):
    jf = js.CosineRandomFeatures.create(
        24, 40, jax.random.key(3), gamma=0.05555, distribution=distribution
    )
    tf = ts.CosineRandomFeatures(
        w=torch.tensor(np.asarray(jf.w)), b=torch.tensor(np.asarray(jf.b))
    )
    x = _rows((64, 24), 2)
    w, b = np.asarray(jf.w), np.asarray(jf.b)
    tol = 8 * np.finfo(np.float32).eps * float((np.abs(x) @ np.abs(w).T + np.abs(b)).max())
    got = tf(torch.from_numpy(x)).numpy()
    assert float(np.abs(got - np.asarray(jf(jnp.asarray(x)))).max()) <= tol


@pytest.mark.parametrize("distribution", ["gaussian", "cauchy"])
def test_cosine_features_create_draws_from_the_generator(distribution):
    def make():
        return ts.CosineRandomFeatures.create(
            440, 512, torch.Generator().manual_seed(5), gamma=0.5,
            distribution=distribution, device="cpu",
        )

    f, g = make(), make()
    assert torch.equal(f.w, g.w) and torch.equal(f.b, g.b)
    assert f.w.shape == (512, 440) and f.b.shape == (512,)
    assert float(f.b.min()) >= 0.0 and float(f.b.max()) <= 2 * math.pi
    med = float(f.w.abs().median())
    # |N(0, 0.5²)| has median 0.5·0.674; |0.5·Cauchy| has median 0.5
    assert med == pytest.approx(0.5 * (0.674 if distribution == "gaussian" else 1.0), rel=0.05)
    with pytest.raises(ValueError):
        ts.CosineRandomFeatures.create(4, 4, torch.Generator(), distribution="laplace", device="cpu")


def test_top_k_classifier_matches_jax():
    x = np.random.default_rng(4).permutation(60 * 9).reshape(60, 9).astype(np.float32)
    for k in (1, 3, 9):
        got = tu.TopKClassifier(k=k)(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(ju.TopKClassifier(k=k)(jnp.asarray(x))))


def test_cast_matrix_vectorizer_and_splitter_match_jax():
    x = _rows((5, 3, 4), 5)
    np.testing.assert_array_equal(
        tu.MatrixVectorizer()(torch.from_numpy(x)).numpy(),
        np.asarray(ju.MatrixVectorizer()(jnp.asarray(x))),
    )
    assert tu.Cast(dtype="bfloat16")(torch.from_numpy(x)).dtype == torch.bfloat16
    assert tu.FloatToDouble()(np.arange(3)).dtype == torch.float32
    assert ju.FloatToDouble().dtype == tu.FloatToDouble().dtype
    y = _rows((6, 10), 6)
    for block, num in ((4, None), (5, None), (3, 8), (16, None)):
        got = tu.VectorSplitter(block_size=block, num_features=num)(torch.from_numpy(y))
        want = ju.VectorSplitter(block_size=block, num_features=num)(jnp.asarray(y))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
