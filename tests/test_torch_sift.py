"""keystone_tpu_torch's dense SIFT against the JAX package's: each stage,
the whole extractor and the two direct-summation goldens — the same
numpy-seeded images through both packages, on the CPU.

Tolerances: the float stages (gradients, orientation planes, the
edge-padded convolutions, the unnormalized scale descriptors) 1e-5 of
max|out| (float32 products and sums taken in another order); the
quantized output ``min(floor(512·v), 255)`` flips by one where ``512·v``
lies within rounding of an integer, so quantized descriptors are held at
every entry within ±1 and ≥ 99.9 % equal (the reference's own gate
against its goldens is ≥ 99.5 % within ±1)."""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.ops import sift as j_sift  # noqa: E402
from keystone_tpu_torch.ops import sift  # noqa: E402

TOL = 1e-5  # of max|out|
MIN_EQUAL = 0.999
GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _quantized_agree(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= 1.0
    assert (got == want).mean() >= MIN_EQUAL, (got == want).mean()


def _images(seed, n, h, w):
    return np.random.default_rng(seed).uniform(0, 1, size=(n, h, w)).astype(np.float32)


def test_kernels_equal_the_reference():
    for sigma in (4 / 6, 1.0, 2.0):
        np.testing.assert_array_equal(sift.gaussian_kernel(sigma), j_sift.gaussian_kernel(sigma))
    for b in (4, 6, 12):
        np.testing.assert_array_equal(sift.triangular_kernel(b), j_sift.triangular_kernel(b))
        for i in range(4):
            assert sift.bin_window_mean(b, i) == j_sift.bin_window_mean(b, i)


@pytest.mark.parametrize("channels", [None, 8])
@pytest.mark.parametrize("radius", [0.3, 1.0, 2.0])
def test_conv_edge_padded_matches_jax(channels, radius):
    shape = (2, 19, 23) + ((channels,) if channels else ())
    x = np.random.default_rng(3).uniform(0, 1, size=shape).astype(np.float32)
    k = sift.gaussian_kernel(radius)
    got = sift._conv_edge_padded(torch.from_numpy(x), k)
    want = np.asarray(j_sift._conv_edge_padded(jnp.asarray(x), k))
    assert _rel(got.numpy(), want) <= TOL


def test_gradients_match_jax():
    x = _images(0, 2, 17, 21)
    for got, want in zip(sift._gradients(torch.from_numpy(x)), j_sift._gradients(jnp.asarray(x))):
        assert _rel(got.numpy(), np.asarray(want)) <= TOL


def test_orientation_planes_match_jax():
    """Random images, and a flat one with exact axis-aligned gradients:
    the angle's wrap (−π, 0, ±π/2) lands on bin edges there."""
    x = _images(1, 2, 24, 20)
    flat = np.zeros((1, 8, 8), np.float32)
    flat[0, :, 4:] = 1.0
    flat[0, 4:, :] += 0.5
    for img in (x, flat):
        got = sift._orientation_planes(torch.from_numpy(img))
        want = np.asarray(j_sift._orientation_planes(jnp.asarray(img)))
        assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("bin_size,step,offset", [(4, 3, 5), (6, 3, 2), (8, 4, 0)])
def test_scale_descriptors_match_jax(bin_size, step, offset):
    x = _images(2, 2, 40, 36)
    got = sift._scale_descriptors(torch.from_numpy(x), bin_size, step, offset)
    want = np.asarray(j_sift._scale_descriptors(jnp.asarray(x), bin_size, step, offset))
    assert _rel(got.numpy(), want) <= TOL


def test_finalize_matches_jax():
    """Quantized: within ±1 everywhere and ≥ 99.9 % equal; the contrast
    threshold zeroes the same descriptors."""
    x = _images(4, 2, 40, 36)
    desc = np.array(j_sift._scale_descriptors(jnp.asarray(x), 6, 3, 2))
    desc[0, :5] *= 1e-4  # below the contrast threshold
    got = sift._finalize(torch.from_numpy(desc)).numpy()
    want = np.asarray(j_sift._finalize(jnp.asarray(desc)))
    _quantized_agree(got, want)
    np.testing.assert_array_equal(got.any(axis=-1), want.any(axis=-1))
    assert not got[0, :5].any()


@pytest.mark.parametrize("hw,scales", [(32, 1), (32, 2), (64, 1), (64, 2), (64, 3)])
def test_sift_extractor_matches_jax(hw, scales):
    x = _images(hw + scales, 3, hw, hw)
    got = sift.SIFTExtractor(num_scales=scales)(torch.from_numpy(x))
    want = np.asarray(j_sift.SIFTExtractor(num_scales=scales)(jnp.asarray(x)))
    assert got.dtype == torch.float32 and got.shape[1] == 128
    _quantized_agree(got.numpy(), want)


def test_sift_extractor_takes_a_channel_axis():
    x = _images(5, 2, 32, 32)
    ext = sift.SIFTExtractor(num_scales=2)
    torch.testing.assert_close(ext(torch.from_numpy(x)[..., None]), ext(torch.from_numpy(x)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", ["synthetic", "voc000012"])
def test_sift_matches_direct_golden(name):
    """The reference's gate (tests/test_sift_golden.py): ≥ 99.5 % of
    entries within ±1 of the direct-summation golden."""
    golden = np.loadtxt(GOLDEN_DIR / f"sift_{name}.csv", delimiter=",")
    img = np.loadtxt(GOLDEN_DIR / f"sift_{name}_input.csv", delimiter=",").astype(np.float32)
    header = (GOLDEN_DIR / f"sift_{name}.csv").read_text().splitlines()[0]
    p = dict(kv.split("=") for kv in header.lstrip("# ").split() if "=" in kv)
    ext = sift.SIFTExtractor(step=int(p["step"]), bin_size=int(p["bin_size"]),
                             num_scales=int(p["num_scales"]), scale_step=int(p["scale_step"]))
    out = ext(torch.from_numpy(img)[None]).numpy()
    assert out.shape == (1, 128, golden.shape[0])
    assert (np.abs(out[0].T - golden) <= 1.0).mean() >= 0.995


def test_native_backend_raises_and_never_falls_back(monkeypatch):
    """A native backend whose host library cannot be built raises; it
    never falls back to the device path. The working native path is held
    in ``test_torch_native.py``."""
    import keystone_tpu_torch.native as native

    x = torch.zeros((1, 32, 32))
    broken = native.HostLibrary("missing", ["/nonexistent/dsift.cpp"], lambda lib: None)
    monkeypatch.setattr(native, "IO_LIB", broken)
    with pytest.raises(RuntimeError, match="unavailable"):
        sift.SIFTExtractor(backend="native")(x)
    with pytest.raises(ValueError, match="expected device\\|native"):
        sift.SIFTExtractor(backend="host")(x)
