"""keystone_tpu_torch featurizer, label and evaluation nodes against the
JAX package on the same numpy inputs.

Tolerance: rtol 1e-5, with an absolute floor of 1e-5 × max|reference|
for the FFT outputs (entries near zero carry the rounding of the whole
row's sum, which two f32 FFT/gemm libraries order differently).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.evaluation.multiclass import (  # noqa: E402
    MulticlassClassifierEvaluator as JEvaluator,
)
from keystone_tpu.models import mnist_random_fft as jm  # noqa: E402
from keystone_tpu.ops import stats as js  # noqa: E402
from keystone_tpu.ops import util as ju  # noqa: E402
from keystone_tpu_torch.evaluation.multiclass import (  # noqa: E402
    MulticlassClassifierEvaluator,
)
from keystone_tpu_torch.models import mnist_random_fft as tm  # noqa: E402
from keystone_tpu_torch.ops import stats as ts  # noqa: E402
from keystone_tpu_torch.ops import util as tu  # noqa: E402

RTOL = 1e-5


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=RTOL * max(float(np.abs(want).max()), 1.0)
    )


def _signs(rng, d):
    return (2 * rng.integers(0, 2, size=d) - 1).astype(np.float32)


def test_random_sign_matches():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 100)).astype(np.float32)
    s = _signs(rng, 100)
    want = js.RandomSignNode(signs=jnp.asarray(s))(jnp.asarray(x))
    got = ts.RandomSignNode(signs=torch.from_numpy(s))(torch.from_numpy(x))
    _close(got, want)


def test_random_sign_create_is_rademacher_and_seeded():
    a = ts.RandomSignNode.create(784, torch.Generator().manual_seed(3), device="cpu")
    b = ts.RandomSignNode.create(784, torch.Generator().manual_seed(3), device="cpu")
    assert set(np.unique(a.signs.numpy())) == {-1.0, 1.0}
    assert torch.equal(a.signs, b.signs)


@pytest.mark.parametrize("impl", ["fft", "matmul", "auto"])
@pytest.mark.parametrize("d", [784, 100, 64])
def test_padded_fft_matches(impl, d):
    rng = np.random.default_rng(d)
    x = rng.normal(size=(24, d)).astype(np.float32)
    want = js.PaddedFFT(impl=impl)(jnp.asarray(x))
    got = ts.PaddedFFT(impl=impl)(torch.from_numpy(x))
    _close(got, want)


def test_padded_fft_auto_is_fft_on_cpu():
    x = torch.zeros((2, 784))
    assert ts.PaddedFFT().resolve_impl(x) == "fft"
    with pytest.raises(ValueError):
        ts.PaddedFFT(impl="bogus")(x)


@pytest.mark.parametrize("alpha,max_val", [(0.0, 0.0), (0.5, -1.0)])
def test_linear_rectifier_matches(alpha, max_val):
    x = np.random.default_rng(1).normal(size=(16, 40)).astype(np.float32)
    want = js.LinearRectifier(max_val=max_val, alpha=alpha)(jnp.asarray(x))
    got = ts.LinearRectifier(max_val=max_val, alpha=alpha)(torch.from_numpy(x))
    _close(got, want)


def test_fused_featurize_matches_jax_fused():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(40, 784)).astype(np.float32)
    signs = np.stack([_signs(rng, 784) for _ in range(3)])
    want = jm._featurize_fused(jnp.asarray(signs), jnp.asarray(x), 1024, 0.0, 0.0)
    got = tm._featurize_fused(torch.from_numpy(signs), torch.from_numpy(x), 1024, 0.0, 0.0)
    _close(got, want)


@pytest.mark.parametrize("impl", ["auto", "matmul"])
def test_featurize_bank_matches(impl):
    """The port's featurize (chain path for auto on CPU, fused gemm for
    matmul) against the JAX featurize on the same signs."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(30, 784)).astype(np.float32)
    signs = [[_signs(rng, 784) for _ in range(2)], [_signs(rng, 784)]]
    jbatches = [
        [
            js.RandomSignNode(signs=jnp.asarray(s))
            >> js.PaddedFFT(impl=impl)
            >> js.LinearRectifier()
            for s in batch
        ]
        for batch in signs
    ]
    from keystone_tpu_torch import convert

    bank = convert.featurizer_bank(signs, impl=impl, device="cpu")
    want = jm.featurize(jbatches, jnp.asarray(x))
    got = bank(torch.from_numpy(x))
    assert [g.shape[-1] for g in got] == [1024, 512]
    for g, w in zip(got, want):
        _close(g, w)


def test_batch_featurizer_grouping():
    batches = tm.build_batch_featurizers(num_ffts=5, block_size=2048, seed=0, device="cpu")
    assert [len(b) for b in batches] == [4, 1]


def test_class_label_indicators_single_label():
    y = np.array([0, 3, 1, 3], np.int32)
    want = ju.ClassLabelIndicators(num_classes=4)(y)
    got = tu.ClassLabelIndicators(num_classes=4)(y)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_class_label_indicators_padded_multilabel():
    y = np.array([[0, 2, -1], [1, -1, -1], [3, 3, 0]], np.int32)
    want = ju.ClassLabelIndicators(num_classes=4)(y)
    got = tu.ClassLabelIndicators(num_classes=4)(y)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_class_label_indicators_ragged():
    y = [[0, 2], [1], [3, 0, 1]]
    want = ju.ClassLabelIndicators(num_classes=4)(y)
    got = tu.ClassLabelIndicators(num_classes=4)(y)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_max_classifier_matches_with_ties():
    scores = np.array([[1.0, 3.0, 3.0], [2.0, 2.0, 0.0], [0.0, -1.0, 5.0]], np.float32)
    want = ju.MaxClassifier()(jnp.asarray(scores))
    got = tu.MaxClassifier()(torch.from_numpy(scores))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_zip_vectors():
    a, b = np.ones((3, 2), np.float32), np.zeros((3, 4), np.float32)
    got = tu.ZipVectors()([torch.from_numpy(a), torch.from_numpy(b)])
    want = ju.ZipVectors()([jnp.asarray(a), jnp.asarray(b)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_valid", [None, 150])
def test_multiclass_evaluator_matches(n_valid):
    rng = np.random.default_rng(4)
    pred = rng.integers(0, 5, size=200)
    actual = rng.integers(0, 5, size=200)
    want = JEvaluator(5)(pred, actual, n_valid=n_valid)
    got = MulticlassClassifierEvaluator(5)(torch.from_numpy(pred), actual, n_valid=n_valid)
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert got.error == want.error
    assert got.macro_f1 == pytest.approx(want.macro_f1)
    assert got.summary() == want.summary()
