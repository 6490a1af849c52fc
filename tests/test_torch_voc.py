"""keystone_tpu_torch's VOC SIFT-Fisher slice against the JAX package's:
the row-normalization, Hellinger and sampling nodes, the Fisher branch
from shared artifacts, the mAP and binary evaluators, the retry policy,
the VOC tar loader and ``voc_sift_fisher.run`` as a whole — the same
numpy-seeded inputs through both packages, on the CPU.

Tolerances: samplers and evaluators exactly (the same numpy index draw
and the same host arithmetic); elementwise nodes and the Fisher branch
from artifacts 1e-5 of max|out| (float32 products and sums taken in
another order); the branch fitted from a column sample 1e-4 (its PCA is
an SVD: held by the projector onto its subspace, which a sign flip does
not move); the whole run's train and test mAP within 1e-4 from the same
PCA and GMM artifacts."""

import io
import os
import tarfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.evaluation import binary as j_binary  # noqa: E402
from keystone_tpu.evaluation import mean_ap as j_mean_ap  # noqa: E402
from keystone_tpu.loaders import image_loaders as j_loaders  # noqa: E402
from keystone_tpu.models import fisher_common as j_fisher  # noqa: E402
from keystone_tpu.models import voc_sift_fisher as j_voc  # noqa: E402
from keystone_tpu.ops import stats as j_stats  # noqa: E402
from keystone_tpu.resilience import retry as j_retry  # noqa: E402
from keystone_tpu.utils import stats as j_ustats  # noqa: E402
from keystone_tpu_torch.evaluation import (  # noqa: E402
    BinaryClassifierEvaluator,
    MeanAveragePrecisionEvaluator,
)
from keystone_tpu_torch.loaders import image_loaders  # noqa: E402
from keystone_tpu_torch.models import fisher_common, voc_sift_fisher  # noqa: E402
from keystone_tpu_torch.ops import stats  # noqa: E402
from keystone_tpu_torch.resilience import retry  # noqa: E402
from keystone_tpu_torch.utils import stats as ustats  # noqa: E402

TOL = 1e-5  # of max|out|
MAP_TOL = 1e-4


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tiny_conf(pkg, **kw):
    """The JAX package's own VOC test configuration (tests/test_voc_pipeline.py)."""
    base = dict(synthetic=24, image_size=64, sift_scales=2, desc_dim=16, vocab_size=4,
                num_pca_samples=2000, num_gmm_samples=1000, lam=5.0, block_size=512,
                chunk_size=8)
    base.update(kw)
    return pkg.VOCConfig(**base)


def test_normalize_rows_and_hellinger_match_jax():
    x = np.random.default_rng(0).normal(size=(7, 33)).astype(np.float32)
    x[3] = 0.0  # the eps floor
    for ours, theirs in ((stats.NormalizeRows(), j_stats.NormalizeRows()),
                         (stats.SignedHellingerMapper(), j_stats.SignedHellingerMapper())):
        got = ours(torch.from_numpy(x)).numpy()
        assert _rel(got, np.asarray(theirs(jnp.asarray(x)))) <= TOL
    assert not stats.NormalizeRows()(torch.from_numpy(x))[3].any()


@pytest.mark.parametrize("n,d,m,num", [(3, 5, 7, 10), (4, 16, 50, 64), (2, 3, 4, 100)])
def test_sample_columns_takes_the_jax_rows(n, d, m, num):
    """The same rows in the same order, bit for bit, gathered without the
    transposed copy; all of them when there are no more than ``num``."""
    desc = np.random.default_rng(n * m).normal(size=(n, d, m)).astype(np.float32)
    want = np.asarray(j_stats.sample_columns(jnp.asarray(desc), num, 5))
    got = stats.sample_columns(torch.from_numpy(desc), num, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(stats.ColumnSampler(num_cols=num, seed=5)(torch.from_numpy(desc))
                                  .numpy(), want)


def test_sample_columns_of_ragged_matrices_takes_the_jax_rows():
    rng = np.random.default_rng(1)
    mats = [rng.normal(size=(6, w)).astype(np.float32) for w in (9, 4, 13)]
    want = np.asarray(j_stats.sample_columns([jnp.asarray(m) for m in mats], 11, 2))
    got = stats.sample_columns([torch.from_numpy(m) for m in mats], 11, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampler_takes_the_jax_rows():
    x = np.random.default_rng(2).normal(size=(50, 3)).astype(np.float32)
    for size in (10, 50, 80):
        want = np.asarray(j_stats.Sampler(size=size, seed=4)(jnp.asarray(x)))
        got = stats.Sampler(size=size, seed=4)(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want)


def test_fisher_branch_from_shared_artifacts_matches_jax(tmp_path):
    """Both packages' branches load one PCA matrix and one GMM from CSV
    and featurize the same descriptors."""
    rng = np.random.default_rng(3)
    desc = rng.uniform(0, 255, size=(5, 32, 60)).astype(np.float32)
    pca = np.linalg.qr(rng.normal(size=(32, 8)))[0].astype(np.float32)
    pca_file = str(tmp_path / "pca.csv")
    np.savetxt(pca_file, pca, delimiter=",")
    gmm_files = tuple(str(tmp_path / f) for f in ("m.csv", "v.csv", "w.csv"))
    np.savetxt(gmm_files[0], rng.normal(scale=50, size=(8, 3)), delimiter=",")
    np.savetxt(gmm_files[1], rng.uniform(500, 2000, size=(8, 3)), delimiter=",")
    np.savetxt(gmm_files[2], np.array([[0.5, 0.3, 0.2]]), delimiter=",")
    args = (8, 3, 1000, 1000, 0, pca_file, gmm_files)
    theirs = j_fisher.FisherBranch(*args)
    want_proj = np.asarray(theirs.fit(jnp.asarray(desc), chunk_size=2))
    want = np.asarray(theirs.featurize(jnp.asarray(desc), chunk_size=2))
    ours = fisher_common.FisherBranch(*args, device="cpu")
    got_proj = ours.fit(torch.from_numpy(desc), chunk_size=2)
    got = ours.featurize(torch.from_numpy(desc), chunk_size=2)
    assert _rel(got_proj.numpy(), want_proj) <= TOL
    assert got.shape == (5, 8 * 2 * 3)
    assert _rel(got.numpy(), want) <= TOL
    assert set(ours.times) == {"pca_s", "gmm_s"}


def test_fisher_branch_fit_from_samples_matches_jax(tmp_path):
    """The streaming path's fit: PCA from the first rows of a column
    sample, the GMM from the artifacts; both branches then featurize."""
    rng = np.random.default_rng(4)
    cols = rng.normal(size=(400, 12)).astype(np.float32)
    gmm_files = tuple(str(tmp_path / f) for f in ("m.csv", "v.csv", "w.csv"))
    np.savetxt(gmm_files[0], rng.normal(size=(4, 2)), delimiter=",")
    np.savetxt(gmm_files[1], rng.uniform(0.5, 2, size=(4, 2)), delimiter=",")
    np.savetxt(gmm_files[2], np.array([[0.6, 0.4]]), delimiter=",")
    theirs = j_fisher.FisherBranch(4, 2, 300, 200, 0, gmm_files=gmm_files)
    ours = fisher_common.FisherBranch(4, 2, 300, 200, 0, gmm_files=gmm_files, device="cpu")
    theirs.fit_from_samples(jnp.asarray(cols))
    ours.fit_from_samples(cols)
    # a PCA direction's sign is fixed by its largest entry; compare the subspace's projector
    p_want = np.asarray(theirs.pca.pca_mat, np.float64)
    p_got = ours.pca.pca_mat.numpy().astype(np.float64)
    assert _rel(p_got @ p_got.T, p_want @ p_want.T) <= 1e-4
    desc = rng.normal(size=(3, 12, 20)).astype(np.float32)
    assert _rel(ours.featurize(torch.from_numpy(desc), 2).numpy(),
                np.asarray(theirs.featurize(jnp.asarray(desc), 2))) <= 1e-4


def test_mean_average_precision_equals_jax():
    rng = np.random.default_rng(5)
    actual = np.where(rng.random((60, 20)) < 0.2, 1, -1).astype(np.int32)
    actual[:, 7] = -1  # a class with no positive
    scores = rng.normal(size=(60, 20)).astype(np.float32)
    want = j_mean_ap.MeanAveragePrecisionEvaluator(20)(actual, scores, n_valid=50)
    ev = MeanAveragePrecisionEvaluator(20)
    np.testing.assert_array_equal(ev(actual, scores, n_valid=50), want)
    np.testing.assert_array_equal(ev(torch.from_numpy(actual), torch.from_numpy(scores), 50), want)
    assert want[7] == 0.0


def test_binary_evaluator_equals_jax():
    rng = np.random.default_rng(6)
    pred, actual = rng.random(101) < 0.4, rng.random(101) < 0.5
    want = j_binary.BinaryClassifierEvaluator.evaluate(pred, actual, n_valid=90)
    got = BinaryClassifierEvaluator.evaluate(torch.from_numpy(pred), torch.from_numpy(actual), 90)
    assert (got.tp, got.fp, got.tn, got.fn) == (want.tp, want.fp, want.tn, want.fn)
    for name in ("accuracy", "error", "precision", "recall", "specificity", "f1"):
        assert getattr(got, name) == getattr(want, name), name
    merged = got + BinaryClassifierEvaluator()(pred, actual)
    assert merged.total == 90 + 101


def test_utils_stats_equal_jax():
    pred = np.array([[1, 2, 3], [4, 5, 6], [0, 1, 2]])
    actual = np.array([3, 9, 0])
    for k in (None, 1, 2):
        assert ustats.classification_error(pred, actual, k) == j_ustats.classification_error(
            pred, actual, k)
    assert ustats.get_err_percent(pred[:, 0], actual) == j_ustats.get_err_percent(pred[:, 0], actual)
    assert ustats.about_eq(1.0, 1.0 + 1e-9) and not ustats.about_eq([1.0, 2.0], [1.0, 2.1])


def test_retry_policy_attempts_and_deadline():
    """The schedule (the jitter's seeded hash included) equals the JAX
    package's; the attempt cap and the deadline stop a transient error."""
    kw = dict(max_attempts=5, base_delay_s=1.0, multiplier=2.0, max_delay_s=5.0, jitter=0.1, seed=3)
    assert ([retry.RetryPolicy(**kw).delay_s(i) for i in range(5)]
            == [j_retry.RetryPolicy(**kw).delay_s(i) for i in range(5)])
    sleeps = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise IOError("transient")
        return 42

    p = retry.RetryPolicy(max_attempts=4, base_delay_s=1.0, jitter=0.0, sleep=sleeps.append,
                          monotonic=lambda: 0.0)
    assert p.call(flaky, label="t") == 42 and sleeps == [1.0, 2.0]
    with pytest.raises(retry.RetryExhausted, match="2/2 attempts") as ei:
        retry.RetryPolicy(max_attempts=2, jitter=0.0, sleep=lambda s: None,
                          monotonic=lambda: 0.0).call(lambda: (_ for _ in ()).throw(IOError("x")))
    assert isinstance(ei.value.__cause__, IOError)
    clock = {"t": 0.0}

    def sleep(s):
        sleeps.append(s)
        clock["t"] += s

    sleeps.clear()
    p = retry.RetryPolicy(max_attempts=10, base_delay_s=4.0, multiplier=1.0, jitter=0.0,
                          deadline_s=10.0, sleep=sleep, monotonic=lambda: clock["t"])
    with pytest.raises(retry.RetryExhausted, match="3/10 attempts.*deadline exceeded"):
        p.call(lambda: (_ for _ in ()).throw(IOError("x")))
    assert sleeps == [4.0, 4.0]
    wrapped = retry.retrying(retry.RetryPolicy(max_attempts=3, jitter=0.0, sleep=lambda s: None))(
        flaky)
    calls["n"] = 0
    assert wrapped() == 42
    for exc in (IOError("x"), tarfile.ReadError("bad"), FileNotFoundError("f"),
                OSError(28, "full"), RuntimeError("UNAVAILABLE: x"), RuntimeError("OOM"),
                ValueError("shape")):
        assert retry.is_transient(exc) == j_retry.is_transient(exc), exc
    assert (retry.IO_POLICY.max_attempts, retry.IO_POLICY.base_delay_s,
            retry.IO_POLICY.deadline_s) == (j_retry.IO_POLICY.max_attempts,
                                            j_retry.IO_POLICY.base_delay_s,
                                            j_retry.IO_POLICY.deadline_s)


def _png(color) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.full((12, 10, 3), color, np.uint8)).save(buf, "PNG")
    return buf.getvalue()


def _add(tf, name, data):
    ti = tarfile.TarInfo(name)
    ti.size = len(data)
    tf.addfile(ti, io.BytesIO(data))


@pytest.fixture
def voc_tar(tmp_path):
    """A tiny VOC tar: three PNGs under the VOC prefix, one corrupt
    member, one outside the prefix and a non-image."""
    path = str(tmp_path / "voc.tar")
    prefix = "VOCdevkit/VOC2007/JPEGImages/"
    with tarfile.open(path, "w") as tf:
        _add(tf, prefix + "000001.png", _png(10))
        _add(tf, prefix + "000002.png", _png(120))
        _add(tf, prefix + "000003.jpg", b"\xff\xd8garbage")
        _add(tf, prefix + "000004.png", _png(250))
        _add(tf, "other/000005.png", _png(77))
        _add(tf, prefix + "notes.txt", b"skip me")
    return path


@pytest.mark.parametrize("layout", ["reference", "simple"])
def test_load_voc_matches_jax(voc_tar, tmp_path, layout):
    """Both CSV layouts; the corrupt member is skipped; the same images
    and padded multi-labels as the JAX package's loader."""
    labels = str(tmp_path / "labels.csv")
    with open(labels, "w") as f:
        if layout == "reference":
            f.write("id,class,classname,traintesteval,filename\n")
            for fname, cls in (("000001.png", 3), ("000002.png", 5), ("000002.png", 1),
                               ("000004.png", 20)):
                f.write(f'1,{cls},x,train,"VOCdevkit/VOC2007/JPEGImages/{fname}"\n')
        else:
            f.write("000001.png,3\n000002.png,5\n000002.png,1\n000004.png,20\n")
    kw = dict(target_size=8, name_prefix="VOCdevkit/VOC2007/JPEGImages/")
    want = j_loaders.load_voc(voc_tar, labels, **kw)
    got = image_loaders.load_voc(voc_tar, labels, **kw)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.images.shape == (3, 8, 8, 3)
    assert got.labels.tolist() == [[2, -1], [0, 4], [19, -1]]


def test_tar_loader_skips_corrupt_images_and_counts(voc_tar):
    from keystone_tpu_torch.observe import metrics

    counter = metrics.get_registry().counter("ingest_decode_failures", loader="image_loaders")
    before = counter.value
    names, imgs = image_loaders.load_tar_images([voc_tar], 16)
    assert [os.path.basename(n) for n in names] == ["000001.png", "000002.png", "000004.png",
                                                    "000005.png"]
    assert imgs.shape == (4, 16, 16, 3) and imgs.dtype == np.float32
    assert counter.value == before + 1


def test_unreadable_tar_is_skipped_or_raises(tmp_path):
    bad = str(tmp_path / "bad.tar")
    with open(bad, "wb") as f:
        f.write(b"not a tar at all" * 64)
    assert list(image_loaders._iter_tar_images(bad)) == []
    with pytest.raises(tarfile.ReadError):
        list(image_loaders._iter_tar_images(bad, strict=True))


def test_voc_synthetic_draw_equals_jax():
    for which in ("train", "test"):
        got = voc_sift_fisher._load(_tiny_conf(voc_sift_fisher), which)
        want = j_voc._load(_tiny_conf(j_voc), which)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)


def test_voc_run_matches_jax_from_its_artifacts(tmp_path):
    """The slice as a whole: the JAX package's run fits and writes the PCA
    and GMM CSVs, the port's run loads them; train and test mAP agree
    within 1e-4."""
    files = dict(pca_file=str(tmp_path / "pca.csv"), gmm_mean_file=str(tmp_path / "m.csv"),
                 gmm_var_file=str(tmp_path / "v.csv"), gmm_wt_file=str(tmp_path / "w.csv"))
    want = j_voc.run(_tiny_conf(j_voc, **files), mesh=None)
    assert all(os.path.exists(f) for f in files.values())
    got = voc_sift_fisher.run(_tiny_conf(voc_sift_fisher, **files), device="cpu")
    assert (got["n_train"], got["n_test"]) == (want["n_train"], want["n_test"]) == (24, 6)
    assert abs(got["train_map"] - want["train_map"]) <= MAP_TOL
    assert abs(got["test_map"] - want["test_map"]) <= MAP_TOL
    assert got["device"] == "cpu" and got["num_features"] == 16 * 2 * 4


def test_voc_run_fits_its_own_artifacts(tmp_path):
    """A port-only run that fits its own PCA and GMM (the JAX package's
    gate: train mAP > 0.3), writes them, and a second run that loads them
    reproduces it."""
    files = dict(pca_file=str(tmp_path / "pca.csv"), gmm_mean_file=str(tmp_path / "m.csv"),
                 gmm_var_file=str(tmp_path / "v.csv"), gmm_wt_file=str(tmp_path / "w.csv"))
    first = voc_sift_fisher.main(
        ["--synthetic", "24", "--image-size", "64", "--sift-scales", "2", "--desc-dim", "16",
         "--vocab-size", "4", "--num-pca-samples", "2000", "--num-gmm-samples", "1000",
         "--lam", "5", "--block-size", "512", "--chunk-size", "8",
         "--pca-file", files["pca_file"], "--gmm-mean-file", files["gmm_mean_file"],
         "--gmm-var-file", files["gmm_var_file"], "--gmm-wt-file", files["gmm_wt_file"]],
        device="cpu")
    assert first["train_map"] > 0.3 and 0.0 <= first["test_map"] <= 1.0
    assert np.loadtxt(files["pca_file"], delimiter=",").shape == (128, 16)
    for key in ("load_s", "sift_s", "pca_s", "gmm_s", "fisher_s", "fit_s", "total_s"):
        assert first[key] >= 0.0, key
    second = voc_sift_fisher.run(_tiny_conf(voc_sift_fisher, **files), device="cpu")
    assert abs(second["train_map"] - first["train_map"]) < 1e-6


def test_voc_lambda_sweep_matches_jax(tmp_path):
    files = dict(pca_file=str(tmp_path / "pca.csv"), gmm_mean_file=str(tmp_path / "m.csv"),
                 gmm_var_file=str(tmp_path / "v.csv"), gmm_wt_file=str(tmp_path / "w.csv"))
    want = j_voc.run(_tiny_conf(j_voc, synthetic=40, lam_sweep="0.1,5,100", **files), mesh=None)
    got = voc_sift_fisher.run(_tiny_conf(voc_sift_fisher, synthetic=40, lam_sweep="0.1,5,100",
                                         **files), device="cpu")
    assert got["lam"] in (0.1, 5.0, 100.0)
    assert abs(got["train_map"] - want["train_map"]) <= MAP_TOL
    assert abs(got["test_map"] - want["test_map"]) <= MAP_TOL


def test_voc_entry_point_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry point would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        voc_sift_fisher.main(["--synthetic", "8", "--image-size", "32"])
