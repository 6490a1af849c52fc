"""The TIMIT slice end to end on the CPU: keystone_tpu_torch against the
JAX package on the same frames and the same cosine features, drawn with
``jax.random`` and carried across with ``keystone_tpu_torch.convert``
(the port's ``make_featurizers`` is patched to return them).

Tolerances: fitted weights within 5e-4 relative and 1e-5 absolute, as the
JAX package's own fused-fit test holds its streamed fit to its classic
one (f32 Grams and moments summed in another order, through multi-pass
BCD); train and test errors within 0.02; ≥ 99 % of test predictions
agree. The int8 fits are given the same chunk-centered features (centered
in float64, as ``test_torch_mnist.py`` does), so both packages quantize
the same f32 operand to the same codes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keystone_tpu import plan as jplan  # noqa: E402
from keystone_tpu.core.pipeline import ChainedLabelEstimator as JChained  # noqa: E402
from keystone_tpu.core.pipeline import Identity as JIdentity  # noqa: E402
from keystone_tpu.core.pipeline import Pipeline as JPipeline  # noqa: E402
from keystone_tpu.evaluation import model_selection as jms  # noqa: E402
from keystone_tpu.evaluation.model_selection import holdout_lambda_sweep as j_sweep  # noqa: E402
from keystone_tpu.loaders import timit as jloader  # noqa: E402
from keystone_tpu.models import timit_pipeline as jt  # noqa: E402
from keystone_tpu.ops.linear import BlockLeastSquaresEstimator as JBLS  # noqa: E402
from keystone_tpu.ops.stats import CosineRandomFeatures as JCosine  # noqa: E402
from keystone_tpu.ops.stats import StandardScaler as JScaler  # noqa: E402
from keystone_tpu.ops.util import ClassLabelIndicators as JCLI  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch import plan as tplan  # noqa: E402
from keystone_tpu_torch.core.pipeline import ChainedLabelEstimator, Identity  # noqa: E402
from keystone_tpu_torch.loaders import timit as tloader  # noqa: E402
from keystone_tpu_torch.models import timit_pipeline as tt  # noqa: E402
from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator  # noqa: E402
from keystone_tpu_torch.ops.stats import CosineRandomFeatures  # noqa: E402
from keystone_tpu_torch.ops.util import ClassLabelIndicators  # noqa: E402
from keystone_tpu_torch.parallel import create_mesh  # noqa: E402

CPU = torch.device("cpu")
RTOL, ATOL = 5e-4, 1e-5
# the JAX package's own small TIMIT configs (tests/test_nlp.py,
# tests/test_streaming_fit.py)
CLASSIC = dict(synthetic=300, num_cosines=2, cosine_features=512, lam=5.0, num_epochs=2)
PLANNED = dict(synthetic=400, num_cosines=2, cosine_features=128, num_epochs=2)


def _jax_featurizers(conf):
    """The reference run's own draws: one key per cosine bank."""
    keys = jax.random.split(jax.random.key(conf.seed), conf.num_cosines)
    return [
        JCosine.create(jt.TIMIT_DIMENSION, conf.cosine_features, keys[i],
                       gamma=conf.gamma, distribution=conf.rf_type)
        for i in range(conf.num_cosines)
    ]


def _carried(jfs, device=CPU):
    return [CosineRandomFeatures(w=torch.tensor(np.asarray(f.w)).to(device),
                                 b=torch.tensor(np.asarray(f.b)).to(device)) for f in jfs]


@pytest.fixture
def carried(monkeypatch):
    """Patch the port's featurizer draw to the JAX package's draws."""
    monkeypatch.setattr(tt, "make_featurizers", lambda conf, device: _carried(_jax_featurizers(conf), device))


def _weights(model):
    return np.concatenate([np.asarray(x) for x in model.xs], axis=0)


def _jax_blocks(conf, x, n):
    jfs = _jax_featurizers(conf)
    raws = [f(jnp.asarray(x)) for f in jfs]
    scalers = [JScaler().fit(r, n_valid=n) for r in raws]
    return jfs, scalers, [s(r) for s, r in zip(scalers, raws)]


def test_port_loads_the_same_frames():
    for which in ("train", "test"):
        t = tt._load(tt.TimitConfig(synthetic=250), which)
        j = jt._load(jt.TimitConfig(synthetic=250), which)
        np.testing.assert_array_equal(t.data, j.data)
        np.testing.assert_array_equal(t.labels, j.labels)
    assert (tloader.TIMIT_DIMENSION, tloader.NUM_CLASSES) == (jloader.TIMIT_DIMENSION, jloader.NUM_CLASSES)


def test_loader_parses_sparse_one_indexed_labels(tmp_path):
    rows = np.random.default_rng(0).normal(size=(4, 440)).astype(np.float32)
    np.savetxt(tmp_path / "train.csv", rows, delimiter=",")
    (tmp_path / "train.lab").write_text("3 7\n1 1\n\n2 147\n4 20 extra\n9 5\n")
    got = tloader.load_timit_split(str(tmp_path / "train.csv"), str(tmp_path / "train.lab"))
    want = jloader.load_timit_split(str(tmp_path / "train.csv"), str(tmp_path / "train.lab"))
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.data, want.data)
    assert got.labels.tolist() == [0, 146, 6, 19]
    # the train split reads the train label file (the reference's fix)
    train, test = tloader.load_timit(*(str(tmp_path / f) for f in ("train.csv", "train.lab") * 2))
    assert train.labels.tolist() == test.labels.tolist()
    (tmp_path / "short.lab").write_text("1 1\n")
    with pytest.raises(ValueError, match="3 rows have no label"):
        tloader.load_timit_split(str(tmp_path / "train.csv"), str(tmp_path / "short.lab"))


def test_classic_fit_matches_jax():
    conf = jt.TimitConfig(**CLASSIC)
    train = jt._load(conf, "train")
    n = len(train)
    jfs, _, jblocks = _jax_blocks(conf, train.data, n)
    jmodel = JBLS(block_size=512, num_iter=2, lam=5.0).fit(jblocks, JCLI(num_classes=147)(train.labels), n_valid=n)

    x = torch.from_numpy(train.data)
    scalers, blocks = tt.fit_scalers(_carried(jfs), x, n, keep_blocks=True)
    tmodel = BlockLeastSquaresEstimator(block_size=512, num_iter=2, lam=5.0).fit(
        blocks, ClassLabelIndicators(num_classes=147)(train.labels), n_valid=n)
    np.testing.assert_allclose(_weights(tmodel), _weights(jmodel), rtol=RTOL, atol=ATOL)


def test_streamed_bank_fit_matches_classic_and_jax():
    """The JAX package's TIMIT-shaped bank test: 2 banks of 24 features,
    3 BCD passes, λ 0.5, 256-row chunks — streamed equal to classic in
    the port, and to the JAX package's streamed fit on the carried bank."""
    rng = np.random.default_rng(0)
    n, d_in, feat_d, k = 700, 30, 24, 6
    x = rng.normal(size=(n, d_in)).astype(np.float32)
    labels = rng.integers(0, k, size=n).astype(np.int32)
    keys = jax.random.split(jax.random.key(0), 2)
    jchains, chains = [], []
    for i in range(2):
        f = JCosine.create(d_in, feat_d, keys[i], gamma=0.1)
        s = JScaler().fit(f(jnp.asarray(x)), n_valid=n)
        jchains.append(JPipeline.of(f, s))
        chains.append({"w": np.asarray(f.w), "b": np.asarray(f.b), "mean": np.asarray(s.mean), "std": np.asarray(s.std)})
    jbank = jt.ScaledCosineBank(chains=tuple(jchains))
    bank = convert.scaled_cosine_bank(chains, device="cpu")
    jest = JBLS(block_size=feat_d, num_iter=3, lam=0.5)
    est = BlockLeastSquaresEstimator(block_size=feat_d, num_iter=3, lam=0.5)
    jy, y = JCLI(num_classes=k)(labels), ClassLabelIndicators(num_classes=k)(labels)
    jfitted = jplan.fit_streaming(JChained(prefix=jbank, est=jest), jnp.asarray(x), jy, n_valid=n, chunk_size=256)
    fitted, plan = tplan.fit_streaming(ChainedLabelEstimator(prefix=bank, est=est), torch.from_numpy(x), y,
                                       n_valid=n, chunk_size=256, device=CPU, return_plan=True)
    classic = est.fit(bank(torch.from_numpy(x)), y, n_valid=n)
    assert plan.fit.widths == (feat_d, feat_d) and plan.chunk_size == 256
    for a, b in zip(fitted[-1].xs, classic.xs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)
    for a, b in zip(fitted[-1].xs, jfitted[-1].xs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


def test_int8_fit_matches_the_references_xla_fit():
    """``gram="int8"`` against the JAX package's int8 fit off the TPU
    (``ata_int8_xla``), on the same chunk-centered bank features."""
    conf = jt.TimitConfig(**PLANNED)
    train = jt._load(conf, "train")
    n, chunk = len(train), 128
    _, _, jblocks = _jax_blocks(conf, train.data, n)
    feats = np.concatenate([np.asarray(b) for b in jblocks], axis=1)
    shared = np.empty_like(feats)
    for s in range(0, n, chunk):
        blk = feats[s : s + chunk].astype(np.float64)
        shared[s : s + chunk] = (blk - blk.mean(axis=0)).astype(np.float32)
    widths = (128, 128)
    jfitted, jp = jplan.fit_streaming(
        JChained(prefix=JIdentity(), est=JBLS(block_size=128, num_iter=2)), jnp.asarray(shared),
        JCLI(num_classes=147)(train.labels), n_valid=n, gram="int8", chunk_size=chunk, return_plan=True)
    fitted, tp = tplan.fit_streaming(
        ChainedLabelEstimator(prefix=Identity(), est=BlockLeastSquaresEstimator(block_size=128, num_iter=2)),
        torch.from_numpy(shared), ClassLabelIndicators(num_classes=147)(train.labels), n_valid=n,
        gram="int8", chunk_size=chunk, device=CPU, return_plan=True)
    jop = next(d for d in jp.decisions if d["action"] == "fit_operator")
    assert tp.decision("fit_operator")["op"] == jop["op"] == "int8"
    assert tp.decision("fit_operator")["quantization_error"] == jop["quantization_error"]
    assert tuple(x.shape[0] for x in fitted[-1].xs) == widths
    np.testing.assert_allclose(_weights(fitted[-1]), _weights(jfitted[-1]), rtol=RTOL, atol=ATOL)


def _errors_close(got, want):
    assert got["n_train"] == want["n_train"] and got["n_test"] == want["n_test"]
    assert abs(got["train_error"] - want["train_error"]) <= 0.02
    assert abs(got["test_error"] - want["test_error"]) <= 0.02


@pytest.mark.parametrize("planned", [False, True])
def test_run_matches_jax(carried, monkeypatch, planned):
    if planned:
        monkeypatch.setenv("KEYSTONE_PLAN", "1")
    else:
        monkeypatch.delenv("KEYSTONE_PLAN", raising=False)
    conf = dict(PLANNED if planned else CLASSIC)
    want = jt.run(jt.TimitConfig(**conf), mesh=None)
    got = tt.run(tt.TimitConfig(**conf), device="cpu")
    _errors_close(got, want)
    assert got["test_predictions"].shape == (got["n_test"],)
    assert ("fit_decisions" in got) == planned
    if planned:
        op = next(d for d in got["fit_decisions"] if d["action"] == "fit_operator")
        assert op["reason"] == "no_int8_advantage"  # a CPU has no int8 advantage


def test_lam_sweep_run_matches_jax(carried, monkeypatch):
    monkeypatch.setenv("KEYSTONE_PLAN", "1")  # a sweep keeps the classic path
    reports = []

    def recorded(*args, **kw):  # the report the reference's run only logs
        reports.append(j_sweep(*args, **kw))
        return reports[-1]

    monkeypatch.setattr(jms, "holdout_lambda_sweep", recorded)
    conf = dict(CLASSIC, synthetic=500, lam_sweep="0.01,10,100000")
    want = jt.run(jt.TimitConfig(**conf), mesh=None)
    got = tt.run(tt.TimitConfig(**conf), device="cpu")
    _errors_close(got, want)
    assert "fit_decisions" not in got
    assert got["lam_sweep"]["lams"] == reports[0]["lams"] == [0.01, 10.0, 1e5]
    assert got["lam_sweep"]["best_lam"] == reports[0]["best_lam"]
    np.testing.assert_allclose(got["lam_sweep"]["val_errors"], reports[0]["val_errors"], atol=0.02)


def test_run_on_a_cpu_mesh_pads_the_rows(carried, monkeypatch):
    monkeypatch.delenv("KEYSTONE_PLAN", raising=False)
    conf = tt.TimitConfig(**dict(CLASSIC, synthetic=302))  # 302 % 4 ≠ 0
    plain = tt.run(conf, device="cpu")
    meshed = tt.run(conf, device="cpu", mesh=create_mesh(devices=["cpu"] * 4))
    assert meshed["n_train"] == plain["n_train"] == 302
    assert meshed["test_error"] == plain["test_error"]
    assert (meshed["test_predictions"] == plain["test_predictions"]).mean() >= 0.99


def test_main_on_cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("KEYSTONE_PLAN", "1")
    res = tt.main(["--synthetic", "400", "--num-cosines", "2", "--cosine-features", "128"], device="cpu")
    assert res["device"] == "cpu" and res["n_test"] == 80 and res["test_error"] <= 0.05
    assert res["fit_chunk_size"] is None
    with pytest.raises(SystemExit):
        tt.main([], device="cpu")
    # --checkpoint-dir takes the classic fit through the resumable fit
    ck = tt.main(["--synthetic", "50", "--num-cosines", "1", "--cosine-features", "16",
                  "--checkpoint-dir", str(tmp_path / "ck")], device="cpu")
    assert "fit_chunk_size" not in ck and (tmp_path / "ck" / "fit_meta.json").exists()
