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
