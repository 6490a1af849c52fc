"""keystone_tpu_torch's LCS, HOG and DAISY extractors against the JAX
package's (``ops/lcs.py``, ``ops/hog.py``, ``ops/daisy.py``): the same
numpy-seeded images through both packages, plus the JAX package's own
property checks on the port's outputs.

Tolerance: 1e-5 of max|out| (float32 convolutions and sums taken in
another order). HOG's orientation snapping and per-pixel channel choice
are argmaxes; exact ties take the first index in both packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.ops import daisy as j_daisy  # noqa: E402
from keystone_tpu.ops import hog as j_hog  # noqa: E402
from keystone_tpu.ops import lcs as j_lcs  # noqa: E402
from keystone_tpu_torch.ops import daisy, hog, lcs  # noqa: E402

TOL = 1e-5  # of max|out|


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _texture(seed, n, h, w, c):
    """Noise + a sinusoid + a ramp per channel, scaled to [0, 1]."""
    rng = np.random.default_rng(seed)
    img = rng.random((n, h, w, c)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img += (0.5 * np.sin(xx / 4) + yy / h)[None, :, :, None]
    return img / img.max()


def _pixels(seed, n, size):
    """Synthetic 0-255 pixels as the ImageNet workload draws them, scaled
    as its LCS branch sees them: 8×8 class blocks upsampled plus noise."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(loc=128, scale=30, size=(n, 8, 8, 3))
    imgs = np.kron(centers, np.ones((1, size // 8, size // 8, 1)))
    imgs += rng.normal(scale=20, size=imgs.shape)
    return (np.clip(imgs, 0, 255) / 255.0).astype(np.float32)


@pytest.mark.parametrize(
    "images,stride,start,sps",
    [
        ("texture", 4, 16, 6),
        ("pixels", 4, 16, 6),
        ("texture", 3, 12, 4),
        ("pixels", 5, 20, 8),
        ("texture", 4, 8, 6),  # the neighborhood reaches above row 0: indices wrap
        ("texture", 4, 4, 6),  # and past the last row: NaN, as jnp.take fills
    ],
)
def test_lcs_matches_jax(images, stride, start, sps):
    x = _texture(0, 2, 64, 72, 3) if images == "texture" else _pixels(1, 2, 64)
    want = np.asarray(j_lcs.LCSExtractor(stride=stride, stride_start=start,
                                         sub_patch_size=sps)(jnp.asarray(x)))
    got = lcs.LCSExtractor(stride=stride, stride_start=start, sub_patch_size=sps)(
        torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = ~np.isnan(want)
    assert _rel(got[finite], want[finite]) <= TOL


def test_lcs_constant_image():
    """The JAX package's check: interior means 0.7, stds 0 (the clamp
    of E[x²] − m² at 0 keeps the cancellation's sign noise out)."""
    out = lcs.LCSExtractor()(torch.full((2, 64, 64, 3), 0.7)).numpy()
    assert out.shape == (2, 96, len(range(16, 48, 4)) ** 2)
    np.testing.assert_allclose(out[:, 0::2], 0.7, atol=1e-4)
    np.testing.assert_allclose(out[:, 1::2], 0.0, atol=1e-3)
    want = np.asarray(j_lcs.LCSExtractor()(jnp.full((2, 64, 64, 3), 0.7, jnp.float32)))
    np.testing.assert_allclose(out[:, 0::2], want[:, 0::2], rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,h,w,c,cell", [(2, 40, 40, 3, 8), (1, 48, 32, 3, 6), (2, 36, 44, 1, 4)])
def test_hog_matches_jax(n, h, w, c, cell):
    x = _texture(3, n, h, w, c)
    want = np.asarray(j_hog.HogExtractor(cell_size=cell)(jnp.asarray(x)))
    got = hog.HogExtractor(cell_size=cell)(torch.from_numpy(x)).numpy()
    assert got.shape == (n, h // cell, w // cell, 31)
    assert _rel(got, want) <= TOL
    assert got.min() >= -1e-6


def test_hog_ties_take_the_first_channel():
    """A gray image copied to three channels ties every pixel's channel
    magnitudes: both argmaxes take channel 0, so the outputs agree."""
    x = np.repeat(_texture(4, 1, 40, 40, 1), 3, axis=-1)
    want = np.asarray(j_hog.HogExtractor()(jnp.asarray(x)))
    got = hog.HogExtractor()(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= TOL


def test_hog_flat_and_edges():
    """The JAX package's checks on the port: a flat image gives zeros;
    vertical and horizontal edges excite different insensitive bins."""
    flat = hog.HogExtractor()(torch.full((1, 40, 40, 3), 0.5)).numpy()
    np.testing.assert_allclose(flat, 0.0, atol=1e-6)
    v = np.zeros((1, 40, 40, 3), np.float32)
    v[:, :, 20:] = 1.0
    hv = hog.HogExtractor()(torch.from_numpy(v)).numpy()[0, 2, 2, 18:27]
    hh = hog.HogExtractor()(torch.from_numpy(v.transpose(0, 2, 1, 3).copy())).numpy()[0, 2, 2, 18:27]
    assert hv.argmax() != hh.argmax()
    want = np.asarray(j_hog.HogExtractor()(jnp.asarray(v)))
    assert _rel(hog.HogExtractor()(torch.from_numpy(v)).numpy(), want) <= TOL


@pytest.mark.parametrize(
    "kw,shape",
    [({}, (1, 64, 64)), ({"daisy_t": 4, "daisy_q": 2, "daisy_r": 5, "daisy_h": 6,
                          "pixel_border": 8, "stride": 5}, (2, 48, 56, 1))],
)
def test_daisy_matches_jax(kw, shape):
    x = _texture(5, shape[0], shape[1], shape[2], 1)[..., 0]
    if len(shape) == 4:
        x = x[..., None]
    ext = daisy.DaisyExtractor(**kw)
    want = np.asarray(j_daisy.DaisyExtractor(**kw)(jnp.asarray(x)))
    got = ext(torch.from_numpy(x)).numpy()
    assert got.shape[-1] == ext.feature_size
    assert _rel(got, want) <= TOL
    hists = got.reshape(got.shape[0], got.shape[1], -1, ext.daisy_h)
    norms = np.linalg.norm(hists, axis=-1)
    assert ((np.abs(norms - 1) < 1e-3) | (norms < 1e-6)).all()


def test_daisy_kernels_bit_for_bit():
    for q, r in [(3, 7), (2, 5), (4, 11)]:
        for k_t, k_j in zip(daisy._daisy_kernels(q, r), j_daisy._daisy_kernels(q, r)):
            np.testing.assert_array_equal(k_t, k_j)
