"""keystone_tpu_torch's pipeline DSL leftovers (core/pipeline.py): bound
transformers, suffixed and chained estimators, lifted estimators, the
fused fit and the cacher, against the JAX package on the same seeded
numpy inputs.

Tolerance: 1e-5 of max|out| for results that pass through a fit (f32
moments summed in another order); composition itself is held exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.core import pipeline as jp  # noqa: E402
from keystone_tpu.ops.linear import LinearMapEstimator as JLinearMap  # noqa: E402
from keystone_tpu.ops.stats import StandardScaler as JScaler  # noqa: E402
from keystone_tpu_torch.core import pipeline as tp  # noqa: E402
from keystone_tpu_torch.ops.linear import LinearMapEstimator  # noqa: E402
from keystone_tpu_torch.ops.stats import StandardScaler  # noqa: E402

TOL = 1e-5


def _rows(seed, shape=(120, 6)):
    return (2.0 + np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= TOL * max(float(np.abs(want).max()), 1.0)


def test_bind_carries_params():
    node = tp.bind(lambda p, b: b * p["w"] + p["c"], {"w": torch.tensor(2.0), "c": 1.0}, name="affine")
    jnode = jp.bind(lambda p, b: b * p["w"] + p["c"], {"w": jnp.asarray(2.0), "c": 1.0})
    x = _rows(0)
    _close(node(torch.from_numpy(x)), jnode(jnp.asarray(x)))
    assert repr(node) == "BoundTransformer(affine)"
    assert isinstance(tp.Pipeline.of(node, tp.Identity()).nodes[0], tp.BoundTransformer)


def test_then_dispatch_matches_jax():
    pre, jpre = tp.transformer(lambda b: b * 2.0), jp.transformer(lambda b: b * 2.0)
    cases = [
        (StandardScaler(), JScaler(), "ChainedEstimator"),
        (LinearMapEstimator(), JLinearMap(), "ChainedLabelEstimator"),
        (tp.Identity(), jp.Identity(), "Pipeline"),
        (lambda b: b, lambda b: b, "Pipeline"),
    ]
    for nxt, jnxt, name in cases:
        assert type(pre >> nxt).__name__ == type(jpre >> jnxt).__name__ == name
    assert type(StandardScaler() >> pre).__name__ == type(JScaler() >> jpre).__name__
    assert type(LinearMapEstimator().then(pre)).__name__ == "_SuffixedLabelEstimator"
    with pytest.raises(TypeError):
        pre >> 3


def test_chained_and_suffixed_estimators_match_jax():
    x = _rows(1)
    y = (x @ np.arange(6, dtype=np.float32)[:, None]).astype(np.float32)
    double, jdouble = tp.transformer(lambda b: b * 2.0), jp.transformer(lambda b: b * 2.0)
    # prefix >> estimator >> suffix, unsupervised and supervised
    fitted = (double >> (StandardScaler() >> double)).fit(torch.from_numpy(x))
    jfitted = (jdouble >> (JScaler() >> jdouble)).fit(jnp.asarray(x))
    assert len(fitted) == len(jfitted) == 3
    _close(fitted(torch.from_numpy(x)), jfitted(jnp.asarray(x)))
    chain = double >> (LinearMapEstimator(lam=0.1) >> double)
    jchain = jdouble >> (JLinearMap(lam=0.1) >> jdouble)
    _close(chain.fit(torch.from_numpy(x), torch.from_numpy(y))(torch.from_numpy(x)),
           jchain.fit(jnp.asarray(x), jnp.asarray(y))(jnp.asarray(x)))


@pytest.mark.parametrize("n_valid", [None, 100])
def test_fit_fused_is_the_fit(n_valid):
    x = _rows(2)
    y = (x[:, :2] * 3.0).astype(np.float32)
    double, jdouble = tp.transformer(lambda b: b * 2.0), jp.transformer(lambda b: b * 2.0)
    kw = {} if n_valid is None else {"n_valid": n_valid}
    fused = tp.ChainedEstimator(prefix=double, est=StandardScaler()).fit_fused(torch.from_numpy(x), **kw)
    plain = tp.ChainedEstimator(prefix=double, est=StandardScaler()).fit(torch.from_numpy(x), **kw)
    jfused = jp.ChainedEstimator(prefix=jdouble, est=JScaler()).fit_fused(jnp.asarray(x), **kw)
    assert torch.equal(fused(torch.from_numpy(x)), plain(torch.from_numpy(x)))
    _close(fused(torch.from_numpy(x)), jfused(jnp.asarray(x)))
    lfused = tp.ChainedLabelEstimator(prefix=double, est=LinearMapEstimator()).fit_fused(
        torch.from_numpy(x), torch.from_numpy(y), **kw)
    jlfused = jp.ChainedLabelEstimator(prefix=jdouble, est=JLinearMap()).fit_fused(
        jnp.asarray(x), jnp.asarray(y), **kw)
    _close(lfused(torch.from_numpy(x)), jlfused(jnp.asarray(x)))
    assert not lfused(torch.from_numpy(x)).requires_grad


def test_lifted_estimators_and_fit_pipeline():
    x = torch.from_numpy(_rows(3))
    est = tp.estimator(lambda data, scale=1.0: tp.transformer(lambda b: b - data.mean(0) * scale))
    jest = jp.estimator(lambda data, scale=1.0: jp.transformer(lambda b: b - data.mean(0) * scale))
    _close(est.fit(x, scale=2.0)(x), jest.fit(jnp.asarray(x.numpy()), scale=2.0)(jnp.asarray(x.numpy())))
    pipe = est.fit_pipeline(x)
    assert isinstance(pipe, tp.Pipeline) and len(pipe) == 1
    lest = tp.label_estimator(lambda data, labels: tp.transformer(lambda b: b * labels.mean()))
    assert torch.equal(lest.fit(x, torch.full((3,), 2.0))(x), x * 2.0)
    assert isinstance(tp.FnLabelEstimator(fn=lambda d, l: tp.Identity()), tp.LabelEstimator)


def test_cacher_returns_its_input():
    x = torch.from_numpy(_rows(4))
    assert tp.Cacher()(x) is x
    blocks = [x, x[:, :2]]
    assert tp.Cacher(name="blocks")(blocks) is blocks
    assert torch.equal(tp.Pipeline.of(tp.transformer(lambda b: b + 1), tp.Cacher())(x), x + 1)
