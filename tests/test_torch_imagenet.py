"""keystone_tpu_torch's ImageNet SIFT + LCS Fisher workload against the
JAX package's (``models/imagenet_sift_lcs_fv.py``), on the CPU at a tiny
width: 48 synthetic 64² images of 4 classes, ``desc_dim`` 8,
``vocab_size`` 4, small sample budgets. Both ``run`` and
``run_streaming`` (plain and under ``KEYSTONE_PLAN``) go through both
packages; the planner's weighted branch and the ImageNet tar loader are
checked beside them.

The two packages draw their GMM starts differently (``jax.random`` against
a ``torch.Generator``), so each branch's PCA and GMM are written by the
JAX package's run and loaded by the port's. Tolerances: the features
within 1e-3 of max|f| as ``sign(f)·f²``. The last stages are a signed
square root and an L2 norm, so ``sign(f)·f²`` is the encoding before the
root over its L1 norm: the root turns an absolute difference ε near zero
into one of √ε, while the squared form keeps the comparison linear. From
the same descriptors the two branches agree to about 2e-6 of max there
(``test_torch_voc`` holds 1e-5); the run's SIFT descriptors differ by one
quantization step in about 1e-5 of their entries (``test_torch_sift``
holds them to ±1), and each such step moves an image's encoding by up to
about 3e-4 of max, hence 1e-3. The top-1 and top-5 errors equal; loaders
exactly."""

import io
import tarfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.loaders import image_loaders as j_loaders  # noqa: E402
from keystone_tpu.loaders import streaming as j_streaming  # noqa: E402
from keystone_tpu.models import fisher_common as j_fisher  # noqa: E402
from keystone_tpu.models import imagenet_sift_lcs_fv as j_imnet  # noqa: E402
from keystone_tpu.ops import weighted_linear as j_weighted  # noqa: E402
from keystone_tpu.core import pipeline as j_pipeline  # noqa: E402
from keystone_tpu import plan as j_plan  # noqa: E402
from keystone_tpu_torch import plan  # noqa: E402
from keystone_tpu_torch.core.pipeline import ChainedLabelEstimator, Identity  # noqa: E402
from keystone_tpu_torch.loaders import image_loaders, streaming  # noqa: E402
from keystone_tpu_torch.models import fisher_common  # noqa: E402
from keystone_tpu_torch.models import imagenet_sift_lcs_fv as imnet  # noqa: E402
from keystone_tpu_torch.observe import metrics  # noqa: E402
from keystone_tpu_torch.ops import weighted_linear  # noqa: E402

FEAT_TOL = 1e-3  # of max|sign(f)·f²|
CPU = torch.device("cpu")
ARGV = ["--synthetic", "48", "--synthetic-classes", "4", "--desc-dim", "8", "--vocab-size", "4",
        "--num-pca-samples", "2000", "--num-gmm-samples", "1000", "--image-size", "64",
        "--chunk-size", "8", "--stream-batch", "16"]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _conf(mod, **kw):
    base = dict(synthetic=48, synthetic_classes=4, desc_dim=8, vocab_size=4,
                num_pca_samples=2000, num_gmm_samples=1000, image_size=64, chunk_size=8,
                stream_batch=16)
    base.update(kw)
    return mod.ImageNetConfig(**base)


def _share_artifacts(monkeypatch, tmp_path):
    """Both packages' branches read and write one PCA and one GMM per
    branch seed: the JAX package's run writes them, the port's loads."""
    def factory(cls):
        def make(desc_dim, vocab, n_pca, n_gmm, seed, **kw):
            f = {k: str(tmp_path / f"branch{seed}_{k}.csv") for k in ("pca", "m", "v", "w")}
            return cls(desc_dim, vocab, n_pca, n_gmm, seed, pca_file=f["pca"],
                       gmm_files=(f["m"], f["v"], f["w"]), **kw)
        return make

    monkeypatch.setattr(j_imnet, "FisherBranch", factory(j_fisher.FisherBranch))
    monkeypatch.setattr(imnet, "FisherBranch", factory(fisher_common.FisherBranch))


def _record_zips(monkeypatch, mod, concat):
    """Record every zipped feature matrix a module's eager run builds."""
    seen = []

    def zip_vectors():
        def call(parts):
            out = concat(parts)
            seen.append(np.asarray(out))
            return out
        return call

    monkeypatch.setattr(mod, "ZipVectors", zip_vectors)
    return seen


def _record_streams(monkeypatch, module):
    seen = []
    inner = module.featurize_stream

    def featurize_stream(*a, **kw):
        out = inner(*a, **kw)
        seen.append(np.asarray(out))
        return out

    monkeypatch.setattr(module, "featurize_stream", featurize_stream)
    return seen


def _unrooted(f):
    """``sign(f)·f²``: the encoding before the signed square root,
    normalized by its L1 norm."""
    f = np.asarray(f, np.float64)
    return np.sign(f) * f * f


def _same_errors(got, want):
    for key in ("train_top1_error", "train_top5_error", "test_top1_error", "test_top5_error"):
        assert got[key] == pytest.approx(want[key], abs=1e-12), key
    assert (got["n_train"], got["n_test"]) == (want["n_train"], want["n_test"]) == (48, 12)


def test_synthetic_load_equals_jax():
    for which in ("train", "test"):
        got, k = imnet._load(_conf(imnet, label_noise=0.2), which)
        want, kj = j_imnet._load(_conf(j_imnet, label_noise=0.2), which)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert k == kj == 4


def test_run_matches_jax(monkeypatch, tmp_path):
    _share_artifacts(monkeypatch, tmp_path)
    want_f = _record_zips(monkeypatch, j_imnet, lambda p: jnp.concatenate(p, axis=-1))
    want = j_imnet.run(_conf(j_imnet))
    got_f = _record_zips(monkeypatch, imnet, lambda p: torch.cat(p, dim=-1))
    got = imnet.run(_conf(imnet), device="cpu")
    _same_errors(got, want)
    assert len(got_f) == len(want_f) == 2
    for g, w, n in zip(got_f, want_f, (48, 12)):
        assert g.shape == (n, 2 * 2 * 8 * 4)
        assert _rel(_unrooted(g), _unrooted(w[:n])) <= FEAT_TOL
    assert got["test_predictions"].shape == (12, 4) and got["device"] == "cpu"
    for key in ("load_s", "sift_s", "lcs_s", "pca_s", "gmm_s", "fisher_s", "fit_s", "test_s"):
        assert got[key] >= 0.0, key


@pytest.mark.parametrize("planned", [False, True])
def test_run_streaming_matches_jax(monkeypatch, tmp_path, planned):
    if planned:
        monkeypatch.setenv("KEYSTONE_PLAN", "1")
    else:
        monkeypatch.delenv("KEYSTONE_PLAN", raising=False)
    _share_artifacts(monkeypatch, tmp_path)
    want_f = _record_streams(monkeypatch, j_streaming)
    want = j_imnet.run_streaming(_conf(j_imnet, streaming=True))
    got_f = _record_streams(monkeypatch, streaming)
    saved = metrics.get_registry().counter("plan_featurize_passes_saved")
    shared = metrics.get_registry().counter("plan_shared_prefix_applies")
    before = (saved.value, shared.value)
    got = imnet.run_streaming(_conf(imnet, streaming=True), device="cpu")
    _same_errors(got, want)
    assert len(got_f) == len(want_f) == 2  # train, then test
    for g, w in zip(got_f, want_f):
        assert _rel(_unrooted(g), _unrooted(w)) <= FEAT_TOL
    if planned:
        # one corpus pass saved; one shared apply per stream batch (48 / 16)
        assert (saved.value, shared.value) == (before[0] + 1, before[1] + 3)
        ops = {d["action"]: d for d in got["fit_decisions"]}
        assert ops["fit_operator"]["reason"] == "exact_per_class_grams"
        assert "fuse_fit" in ops
    else:
        assert (saved.value, shared.value) == before and got["fit_decisions"] == []


def _weighted_problem():
    rng = np.random.default_rng(0)
    cls = rng.integers(0, 5, size=300)
    x = (rng.normal(size=(5, 40))[cls] + rng.normal(size=(300, 40))).astype(np.float32)
    y = -np.ones((300, 5), np.float32)
    y[np.arange(300), cls] = 1.0
    return x, y


def test_planner_keeps_weighted_grams_exact(monkeypatch):
    """The weighted solver gets fp32 with ``exact_per_class_grams``
    whatever ``KEYSTONE_GRAM_OP`` asks, as in the JAX package's planner."""
    monkeypatch.setenv("KEYSTONE_GRAM_OP", "int8")
    x, y = _weighted_problem()
    est = weighted_linear.BlockWeightedLeastSquaresEstimator(block_size=16, lam=0.1)
    p = plan.plan_fit(ChainedLabelEstimator(prefix=Identity(), est=est), x, y, device=CPU)
    j_est = j_weighted.BlockWeightedLeastSquaresEstimator(block_size=16, lam=0.1)
    jp = j_plan.plan_fit(j_pipeline.ChainedLabelEstimator(prefix=j_pipeline.Identity(), est=j_est),
                         jnp.asarray(x), jnp.asarray(y))
    got = p.decision("fit_operator")
    want = next(d for d in jp.decisions if d["action"] == "fit_operator")
    assert (got["op"], got["reason"]) == (want["op"], want["reason"]) == ("fp32",
                                                                          "exact_per_class_grams")
    assert p.fit.fused and p.prefix[-1].op.gram == "fp32"


def test_planner_falls_back_when_the_state_is_over_budget():
    """A budget below the (C, D, D) state: the materialized fit runs,
    the decision and the ``plan_fit_materialized`` count record it, and
    the model is the estimator's own fit. A budget between the state and
    the fit's peak (the finalize's per-class systems) falls back too."""
    x, y = _weighted_problem()
    est = weighted_linear.BlockWeightedLeastSquaresEstimator(block_size=16, lam=0.1, num_iter=2)
    chain = ChainedLabelEstimator(prefix=Identity(), est=est)
    counter = metrics.get_registry().counter("plan_fit_materialized")
    before = counter.value
    state, peak = est.fit_stats_state_bytes(40, 5), est.fit_stats_peak_bytes(40, 5)
    assert state < peak
    for budget in (1024, (state + peak) // 2):
        fitted, p = plan.fit_streaming(chain, x, y, device=CPU, budget_bytes=budget,
                                       return_plan=True)
        d = p.decision("fit_fallback")
        assert d["reason"] == "state_over_budget" and d["budget_bytes"] == budget
        assert (d["state_bytes"], d["peak_bytes"]) == (state, peak)
        direct = est.fit(torch.from_numpy(x), torch.from_numpy(y))
        for a, b in zip(fitted.nodes[-1].xs, direct.xs):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert counter.value == before + 2
    fused = plan.fit_streaming(chain, x, y, device=CPU, budget_bytes=peak)
    direct = est.fit(torch.from_numpy(x), torch.from_numpy(y))
    xs_f, xs_d = torch.cat(fused.nodes[-1].xs), torch.cat(direct.xs)
    assert float((xs_f - xs_d).abs().max() / xs_d.abs().max()) <= 2e-3
    assert counter.value == before + 2


def _jpeg(color) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.full((10, 12, 3), color, np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


def test_load_imagenet_matches_jax(tmp_path):
    """Synset prefixes and directory names through the class map;
    unmapped images dropped."""
    path = str(tmp_path / "train.tar")
    with tarfile.open(path, "w") as tf:
        for name, color in (("n01/n01_1.jpg", 10), ("n02_7.jpg", 90), ("n03/x.jpg", 160),
                            ("n09_3.jpg", 200), ("n01_2.JPEG", 250)):
            data = _jpeg(color)
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    class_map = tmp_path / "map.txt"
    class_map.write_text("n01 0\nn02 1\nn03 2\n")
    assert image_loaders.load_class_map(str(class_map)) == j_loaders.load_class_map(str(class_map))
    label_of = image_loaders.make_synset_label_of({"n01": 0, "n03": 2})
    assert [label_of(n) for n in ("a/n01_5.jpg", "n03/q.jpg", "n07_1.jpg")] == [0, 2, -1]
    got = image_loaders.load_imagenet(path, str(class_map), target_size=8)
    want = j_loaders.load_imagenet(path, str(class_map), target_size=8)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.images, want.images)
    assert got.labels.tolist() == [0, 1, 2, 0]


def test_entry_points_refuse_what_is_not_ported(tmp_path):
    # --checkpoint-dir is ported: the weighted solver checkpoints between
    # BCD passes (tests/test_torch_checkpoint.py holds the resume)
    res = imnet.main(ARGV + ["--checkpoint-dir", str(tmp_path / "ck")], device="cpu")
    assert np.isfinite(res["test_top1_error"]) and (tmp_path / "ck" / "step_1").is_dir()
    with pytest.raises(SystemExit):
        imnet.main([], device="cpu")
