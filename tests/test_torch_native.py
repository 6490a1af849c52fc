"""keystone_tpu_torch's host C++ paths against the JAX package's: the CSV,
CIFAR and dense-SIFT readers (the same ``native/*.cpp`` sources, built by
the port into its own ``_build/``) on the same files, bit for bit; the
port's enceval shim against ``keystone_tpu.native.enceval`` from the JAX
package's start; and the native backends of ``SIFTExtractor``,
``GaussianMixtureModelEstimator`` and ``FisherVector`` against the port's
device paths, on the CPU.

Tolerances: the readers and dense SIFT exactly (one C source). The EM and
the Fisher vectors run the same double-precision loops, but the JAX
package's FFI adds the threads' partial sums under ``omp critical`` in
finishing order and the shim adds them in thread order, so sums can round
differently in the last place: means, variances and weights within 1e-5 of
max|value|, Fisher vectors 1e-6 of max|f|. Native against the port's
float32 device paths: the JAX package's own native-vs-device tolerances
(``tests/test_native_enceval.py``: EM 1e-3 absolute, Fisher 5e-4) and
``tests/test_torch_sift.py``'s bar for SIFT (every entry within ±1, ≥ 99.9 % equal)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import keystone_tpu.native as j_native  # noqa: E402
from keystone_tpu.native import enceval as j_enceval  # noqa: E402
from keystone_tpu.ops import gmm as j_gmm  # noqa: E402
from keystone_tpu_torch import native  # noqa: E402
from keystone_tpu_torch.loaders import cifar, csv_loader  # noqa: E402
from keystone_tpu_torch.native import enceval  # noqa: E402
from keystone_tpu_torch.ops import gmm, sift  # noqa: E402

ENCEVAL_TOL = 1e-5  # of max|value|, shim against the FFI (reduction order)
FISHER_TOL = 1e-6  # of max|f|
MIN_EQUAL = 0.999


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture
def planted():
    rng = np.random.default_rng(11)
    centers = rng.normal(scale=4, size=(3, 8)).astype(np.float32)
    return np.concatenate(
        [c + rng.normal(scale=0.3, size=(200, 8)).astype(np.float32) for c in centers]
    )


def test_library_builds_into_the_port_tree():
    lib = native.require_lib()
    assert "/keystone_tpu_torch/_build/libkeystone_io" in lib._name
    for sym in ("csv_dims", "csv_read", "cifar_read", "dsift_descriptor_count",
                "dsift_flat", "dsift_flat_batch"):
        assert hasattr(lib, sym)
    assert enceval.available()


def test_serial_build_gives_the_same_results(tmp_path):
    """Where the compiler has no OpenMP runtime the sources build serially
    (the pragmas ignored, an empty ``omp.h`` for the header): the readers
    and dense SIFT give the OpenMP build's bits, the EM its values within
    the reduction-order tolerance."""
    import ctypes

    def serial(host):
        target = host._target(openmp=False)
        host._compile(target, openmp=False)
        lib = ctypes.CDLL(target)
        host._bind(lib)
        return lib

    io = serial(native.HostLibrary("io_serial_test", native.IO_LIB.sources, native._bind_io))
    rng = np.random.default_rng(5)
    imgs = rng.random((2, 40, 40)).astype(np.float32)
    count = io.dsift_descriptor_count(40, 40, 3, 4, 2, 0)
    out = np.empty((2, count, 128), np.int16)
    assert io.dsift_flat_batch(imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               2, 40, 40, 3, 4, 2, 0,
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))) == count
    want = native.native_dsift(imgs, num_scales=2)
    np.testing.assert_array_equal(np.transpose(out, (0, 2, 1)).astype(np.float32), want)
    em = serial(native.HostLibrary("enceval_serial_test", enceval.ENCEVAL_LIB.sources,
                                   enceval._bind))
    x = rng.normal(size=(300, 4)).astype(np.float32)
    start = [np.ascontiguousarray(a, np.float32) for a in
             (x[:3].T, np.ones((4, 3)), np.full(3, 1 / 3))]
    got = [np.empty((4, 3), np.float32), np.empty((4, 3), np.float32), np.empty(3, np.float32)]
    ptr = enceval._ptr
    assert em.keystone_gmm_em(ptr(x), 300, 4, 3, *(ptr(a) for a in start), 8, 1e-5,
                              *(ptr(a) for a in got)) == 0
    for g, w in zip(got, enceval.gmm_em(x, 3, 8, init=tuple(start))):
        assert _rel(g, w) <= ENCEVAL_TOL


def test_csv_matches_jax_native(tmp_path):
    rng = np.random.default_rng(0)
    mat = rng.normal(size=(50, 7)).astype(np.float32)
    path = str(tmp_path / "m.csv")
    np.savetxt(path, mat, delimiter=",", fmt="%.6f")
    with open(tmp_path / "e.csv", "w") as f:
        f.write("1.5e-3,-2,0\n-1e4,3.25,7\n")
    for p in (path, str(tmp_path / "e.csv")):
        got, want = native.native_load_csv(p), j_native.native_load_csv(p)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(csv_loader.load_csv(path), j_native.native_load_csv(path))
    np.testing.assert_allclose(
        csv_loader.load_csv(path), np.loadtxt(path, delimiter=",", dtype=np.float32), atol=1e-6
    )
    with open(tmp_path / "r.csv", "w") as f:
        f.write("1,2,3\n4,5\n")
    assert native.native_load_csv(str(tmp_path / "r.csv")) is None  # the caller falls back


def test_cifar_matches_jax_native(tmp_path):
    rng = np.random.default_rng(1)
    recs = rng.integers(0, 256, size=(6, cifar.RECORD)).astype(np.uint8)
    recs[:, 0] = rng.integers(0, 10, size=6)
    path = str(tmp_path / "c.bin")
    recs.tofile(path)
    labels, images = native.native_load_cifar(path)
    j_labels, j_images = j_native.native_load_cifar(path)
    np.testing.assert_array_equal(labels, j_labels)
    np.testing.assert_array_equal(images, j_images)
    np.testing.assert_array_equal(images, cifar._read_numpy(path)[1])
    np.testing.assert_array_equal(cifar.load_cifar(path).images, images)


@pytest.mark.parametrize("num_scales,scale_step", [(2, 0), (3, 1)])
def test_dsift_matches_jax_native_and_the_device(num_scales, scale_step):
    rng = np.random.default_rng(num_scales)
    imgs = rng.random((2, 48, 40)).astype(np.float32)
    kw = dict(step=3, bin_size=4, num_scales=num_scales, scale_step=scale_step)
    got = native.native_dsift(imgs, **kw)
    np.testing.assert_array_equal(got, j_native.native_dsift(imgs, **kw))
    ours = sift.SIFTExtractor(**kw, backend="native")(torch.from_numpy(imgs)).numpy()
    np.testing.assert_array_equal(ours, got)
    device = sift.SIFTExtractor(**kw)(torch.from_numpy(imgs)).numpy()
    assert ours.shape == device.shape
    assert np.abs(ours - device).max() <= 1.0
    assert (ours == device).mean() >= MIN_EQUAL


def test_gmm_em_matches_jax_native_from_its_start(planted):
    mu0, var0, w0 = (np.asarray(a) for a in j_gmm.gmm_init(jnp.asarray(planted), 3, 42, 1e-5))
    want = j_enceval.gmm_em(planted, k=3, max_iter=30)
    got = enceval.gmm_em(planted, 3, 30, init=(mu0, var0, w0))
    for g, w in zip(got, want):
        assert _rel(g, w) <= ENCEVAL_TOL
    np.testing.assert_allclose(got[2].sum(), 1.0, atol=1e-5)
    # bitwise repeatable: the shim sums the threads' partials in order
    again = enceval.gmm_em(planted, 3, 30, init=(mu0, var0, w0))
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g, a)


def test_fisher_matches_jax_native(planted):
    mu, var, w = j_enceval.gmm_em(planted, k=3, max_iter=20)
    batch = np.random.default_rng(2).normal(size=(4, 8, 50)).astype(np.float32)
    want = j_enceval.fisher_vectors(batch, mu, var, w)
    assert _rel(enceval.fisher_vectors(batch, mu, var, w), want) <= FISHER_TOL


def test_native_backends_match_the_device_paths(planted):
    x = torch.from_numpy(planted)
    est = dict(k=3, max_iter=10)
    m_native = gmm.GaussianMixtureModelEstimator(**est, backend="native").fit(x)
    m_device = gmm.GaussianMixtureModelEstimator(**est).fit(x)
    for a in ("means", "variances"):
        np.testing.assert_allclose(getattr(m_native, a).numpy(), getattr(m_device, a).numpy(),
                                   atol=1e-3)
    np.testing.assert_allclose(m_native.weights.numpy(), m_device.weights.numpy(), atol=1e-4)
    batch = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 8, 50)).astype(np.float32))
    fv_native = gmm.FisherVector(gmm=m_device, backend="native")(batch)
    assert fv_native.device == batch.device and fv_native.dtype == torch.float32
    np.testing.assert_allclose(fv_native.numpy(), gmm.FisherVector(gmm=m_device)(batch).numpy(),
                               atol=5e-4)
