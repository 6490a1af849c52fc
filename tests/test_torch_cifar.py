"""keystone_tpu_torch's CIFAR-10 loader, pixel nodes and LinearPixels
workload against the JAX package's: binary records the test writes
itself (the CIFAR-10 files are not in the repo), the nodes on numpy-seeded
images, and ``cifar_linear_pixels.run`` on synthetic images."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import keystone_tpu.native  # noqa: E402
import keystone_tpu_torch.native  # noqa: E402
from keystone_tpu.loaders import cifar as j_cifar  # noqa: E402
from keystone_tpu.models import cifar_linear_pixels as j_lp  # noqa: E402
from keystone_tpu.ops import images as j_images  # noqa: E402
from keystone_tpu.utils import images as j_utils  # noqa: E402
from keystone_tpu.utils.images import LabeledImages as JLabeledImages  # noqa: E402
from keystone_tpu_torch.loaders import cifar  # noqa: E402
from keystone_tpu_torch.models import cifar_linear_pixels  # noqa: E402
from keystone_tpu_torch.ops import images  # noqa: E402
from keystone_tpu_torch.utils.images import GRAY_WEIGHTS, LabeledImages  # noqa: E402


def _write_records(path: str, n: int, seed: int) -> np.ndarray:
    """``n`` CIFAR-10 records of seeded bytes; returns the raw records."""
    rng = np.random.default_rng(seed)
    recs = rng.integers(0, 256, size=(n, cifar.RECORD)).astype(np.uint8)
    recs[:, 0] = rng.integers(0, 10, size=n)
    recs.tofile(path)
    return recs


@pytest.mark.parametrize("numpy_branch", [True, False])
def test_loader_matches_jax(tmp_path, monkeypatch, numpy_branch):
    """A file, a directory of ``*.bin`` files and a glob, against
    ``load_cifar``: its numpy branch, and its native reader where that is
    built."""
    if numpy_branch:
        monkeypatch.setattr(keystone_tpu.native, "native_load_cifar", lambda f: None)
        monkeypatch.setattr(keystone_tpu_torch.native, "native_load_cifar", lambda f: None)
    a = _write_records(os.path.join(tmp_path, "data_batch_1.bin"), 7, 0)
    _write_records(os.path.join(tmp_path, "data_batch_2.bin"), 5, 1)
    for path in (os.path.join(tmp_path, "data_batch_1.bin"), str(tmp_path),
                 os.path.join(tmp_path, "data_batch_*.bin")):
        got, want = cifar.load_cifar(path), j_cifar.load_cifar(path)
        assert got.images.dtype == np.float32 and got.labels.dtype == np.int32
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
    got = cifar.load_cifar(str(tmp_path))
    assert got.images.shape == (12, 32, 32, 3) and len(got) == 12
    # record bytes 1..1024 are the R plane, row-major
    np.testing.assert_array_equal(got.images[0, :, :, 0].astype(np.uint8).ravel(), a[0, 1:1025])
    np.testing.assert_array_equal(got.images[0, 0, 1, 2], a[0, 1 + 2 * 1024 + 1])


def test_loader_rejects_a_bad_size(tmp_path):
    path = os.path.join(tmp_path, "bad.bin")
    np.zeros(100, np.uint8).tofile(path)
    with pytest.raises(ValueError, match="record"):
        cifar.load_cifar(path)


def test_pixel_nodes_match_jax():
    x = np.random.default_rng(2).uniform(0, 255, size=(4, 16, 16, 3)).astype(np.float32)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    assert GRAY_WEIGHTS == j_utils.GRAY_WEIGHTS
    for node, j_node in ((images.GrayScaler(), j_images.GrayScaler()),
                         (images.PixelScaler(), j_images.PixelScaler()),
                         (images.ImageVectorizer(), j_images.ImageVectorizer()),
                         (images.GrayScaler() >> images.ImageVectorizer(),
                          j_images.GrayScaler() >> j_images.ImageVectorizer())):
        got, want = node(t), np.asarray(j_node(j))
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    labeled = LabeledImages(labels=np.arange(4), images=x)
    j_labeled = JLabeledImages(labels=np.arange(4), images=x)
    assert images.LabelExtractor()(labeled) is labeled.labels
    np.testing.assert_array_equal(images.ImageExtractor()(labeled),
                                  j_images.ImageExtractor()(j_labeled))
    assert images.MultiLabelExtractor is images.LabelExtractor


def test_synthetic_data_matches_jax():
    conf, j_conf = (cifar_linear_pixels.LinearPixelsConfig(synthetic=50),
                    j_lp.LinearPixelsConfig(synthetic=50))
    for which in ("train", "test"):
        got, want = cifar_linear_pixels._load(conf, which), j_lp._load(j_conf, which)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)


@pytest.mark.parametrize("lam", [0.0, 10.0])
def test_linear_pixels_run_matches_jax(lam):
    """The exact solve on grayscale pixels: the same errors as the JAX
    package's run on the same synthetic images."""
    conf = dict(synthetic=200, lam=lam)
    j_res = j_lp.run(j_lp.LinearPixelsConfig(**conf))
    res = cifar_linear_pixels.run(cifar_linear_pixels.LinearPixelsConfig(**conf), device="cpu")
    assert res.keys() == j_res.keys()
    assert res["n_train"] == j_res["n_train"] and res["n_test"] == j_res["n_test"]
    for key in ("train_error", "test_error"):
        assert abs(res[key] - j_res[key]) <= 0.01, (key, res[key], j_res[key])


# --- the conv workloads: cifar_random_patch and cifar_random, at the JAX
# tests' own sizes (tests/test_cifar_pipelines.py: 150 images, 16 filters)

from keystone_tpu.core import fusion as j_fusion  # noqa: E402
from keystone_tpu.models import cifar_random as j_rc  # noqa: E402
from keystone_tpu.models import cifar_random_patch as j_rp  # noqa: E402
from keystone_tpu.ops import linear as j_linear  # noqa: E402
from keystone_tpu.ops import stats as j_stats  # noqa: E402
from keystone_tpu_torch.models import cifar_random, cifar_random_patch  # noqa: E402
from keystone_tpu_torch.ops import linear, stats  # noqa: E402

CONV_TOL = 1e-5  # of max|out|: f32 products, sums in another order
RP_CONF = dict(synthetic=150, num_filters=16, pool_size=14, pool_stride=13, lam=50.0,
               block_size=512, chunk_size=64)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("patch_steps", [1, 2])
def test_build_filters_match_jax(patch_steps):
    """The three draws of one generator in the JAX package's order (the
    images, the window subsample to 100,000, the filters), the ZCA
    whitener and the folded filters: the JAX package's filters up to
    float rounding."""
    conf = dict(RP_CONF, patch_steps=patch_steps)
    images = cifar_linear_pixels._load(cifar_linear_pixels.LinearPixelsConfig(synthetic=150),
                                       "train").images
    filters, means = cifar_random_patch.build_filters(
        images, cifar_random_patch.RandomCifarConfig(**conf), device="cpu")
    j_filters, j_means = j_rp.build_filters(images, j_rp.RandomCifarConfig(**conf))
    assert tuple(filters.shape) == (16, 108)
    assert _rel(filters.numpy(), np.asarray(j_filters)) <= CONV_TOL
    assert _rel(means.numpy(), np.asarray(j_means)) <= CONV_TOL


def test_random_patch_features_and_fit_match_jax():
    """On the JAX package's filters: the fused featurizer's features, the
    scaler and the one-pass block least squares' weights and scores."""
    jc = j_rp.RandomCifarConfig(**RP_CONF)
    data = cifar_linear_pixels._load(cifar_linear_pixels.LinearPixelsConfig(synthetic=150),
                                     "train")
    j_filters, j_means = j_rp.build_filters(data.images, jc)
    j_feat = j_fusion.optimize(
        j_images.Convolver(filters=j_filters, whitener_means=j_means, patch_size=6)
        >> j_images.SymmetricRectifier(alpha=0.25) >> j_images.Pooler(stride=13, pool_size=14)
        >> j_images.ImageVectorizer())
    want = np.array(j_feat(jnp.asarray(data.images)))
    feat = cifar_random_patch.make_featurizer(
        torch.from_numpy(np.array(j_filters)), torch.from_numpy(np.array(j_means)),
        cifar_random_patch.RandomCifarConfig(**RP_CONF))
    assert type(feat.nodes[0]).__name__ == "FusedConvRectifyPool"
    got = feat(torch.from_numpy(data.images))
    assert tuple(got.shape) == (150, 8 * 16)
    assert _rel(got.numpy(), want) <= CONV_TOL

    labels = data.labels
    j_scaled = j_stats.StandardScaler().fit(jnp.asarray(want))(jnp.asarray(want))
    j_ind = 2 * np.eye(10, dtype=np.float32)[labels] - 1  # ±1 indicators
    j_model = j_linear.BlockLeastSquaresEstimator(block_size=512, num_iter=1, lam=50.0).fit(
        j_scaled, jnp.asarray(j_ind))
    scaled = stats.StandardScaler().fit(torch.from_numpy(want))(torch.from_numpy(want))
    model = linear.BlockLeastSquaresEstimator(block_size=512, num_iter=1, lam=50.0).fit(
        scaled, torch.from_numpy(j_ind))
    assert _rel(scaled.numpy(), np.asarray(j_scaled)) <= CONV_TOL
    assert _rel(model.xs[0].numpy(), np.asarray(j_model.xs[0])) <= CONV_TOL
    assert _rel(model(scaled).numpy(), np.asarray(j_model(j_scaled))) <= CONV_TOL


def _errors_agree(res, j_res, n_train, n_test):
    assert set(j_res) <= set(res) and res["device"] == "cpu"
    assert res["n_train"] == j_res["n_train"] and res["n_test"] == j_res["n_test"]
    # within one sample
    assert abs(res["train_error"] - j_res["train_error"]) <= 1.0 / n_train + 1e-12
    assert abs(res["test_error"] - j_res["test_error"]) <= 1.0 / n_test + 1e-12


def test_cifar_random_patch_run_matches_jax():
    res = cifar_random_patch.run(cifar_random_patch.RandomCifarConfig(**RP_CONF), device="cpu")
    j_res = j_rp.run(j_rp.RandomCifarConfig(**RP_CONF), mesh=None)
    _errors_agree(res, j_res, 150, 30)
    assert res["num_features"] == 8 * 16 and len(res["test_predictions"]) == 30


@pytest.mark.parametrize("planned,sample_frac", [(False, 0.0), (True, 0.0), (False, 0.6)])
def test_cifar_random_run_matches_jax(monkeypatch, planned, sample_frac):
    """Classic and ``KEYSTONE_PLAN=1`` (the scaler streamed into the exact
    fit), and ``sample_frac``'s mask, drawn before the filter bank."""
    if planned:
        monkeypatch.setenv("KEYSTONE_PLAN", "1")
    else:
        monkeypatch.delenv("KEYSTONE_PLAN", raising=False)
    conf = dict(synthetic=150, num_filters=16, lam=10.0, chunk_size=64, sample_frac=sample_frac)
    res = cifar_random.run(cifar_random.RandomCifarFilterConfig(**conf), device="cpu")
    j_res = j_rc.run(j_rc.RandomCifarFilterConfig(**conf), mesh=None)
    _errors_agree(res, j_res, j_res["n_train"], 30)
    assert ("fit_decisions" in res) == planned
    if sample_frac:
        assert 0 < res["n_train"] < 150
    keep, filters = cifar_random.random_filters(cifar_random.RandomCifarFilterConfig(**conf), 150)
    assert filters.shape == (16, 108) and filters.dtype == np.float32
    assert (keep is None) == (sample_frac == 0.0)
