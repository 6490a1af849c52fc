"""The MNIST random-FFT slice end to end on the CPU: keystone_tpu_torch
against the JAX package on the same rows and the same random signs
(carried across with ``keystone_tpu_torch.convert``), for the classic fit
and for the planner's streamed fit with the int8 Gram.

Tolerances: fitted weights within 1e-3 of max|x| (f32 Grams and
Cholesky solves summed in different orders, through a solve whose
condition number amplifies them); ≥ 99.5 % of test predictions agree;
errors equal within 1/n_test.

One exception, the weights of the int8 fit from each package's own
features: their f32 features and chunk means differ by ~1e-7 of their
scale, which flips a few int8 codes across a rounding boundary
(``test_int8_codes_flip_rarely`` counts them), and the solve carries the
flips to ~2e-3 of max|x|; those weights are held to 5e-3. Given the same
chunk-centered features, so that the codes agree,
``test_streamed_int8_fit_on_shared_features`` holds the int8 fit's weights
to 1e-3, as every other path is held.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu import plan as jplan  # noqa: E402
from keystone_tpu.core.pipeline import ChainedLabelEstimator as JChained  # noqa: E402
from keystone_tpu.core.pipeline import Identity as JIdentity  # noqa: E402
from keystone_tpu.core.pipeline import Pipeline as JPipeline  # noqa: E402
from keystone_tpu.evaluation.multiclass import (  # noqa: E402
    MulticlassClassifierEvaluator as JEvaluator,
)
from keystone_tpu.models import mnist_random_fft as jm  # noqa: E402
from keystone_tpu.ops.gram import _quantize_cols as j_quantize_cols  # noqa: E402
from keystone_tpu.ops.linear import BlockLeastSquaresEstimator as JBLS  # noqa: E402
from keystone_tpu.ops.util import ClassLabelIndicators as JCLI  # noqa: E402
from keystone_tpu.ops.util import MaxClassifier as JMax  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch import plan as tplan  # noqa: E402
from keystone_tpu_torch.core.pipeline import ChainedLabelEstimator  # noqa: E402
from keystone_tpu_torch.core.pipeline import Identity, Pipeline  # noqa: E402
from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator  # noqa: E402
from keystone_tpu_torch.models import mnist_random_fft as tm  # noqa: E402
from keystone_tpu_torch.ops.gram import _quantize_cols  # noqa: E402
from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator  # noqa: E402
from keystone_tpu_torch.ops.util import ClassLabelIndicators, MaxClassifier  # noqa: E402

N_TRAIN, NUM_FFTS, BLOCK, CHUNK, LAM = 2000, 2, 512, 512, 0.01
CPU = torch.device("cpu")
INT8_WEIGHT_TOL = 5e-3  # see the module docstring


@pytest.fixture(scope="module")
def slice_inputs():
    conf = jm.MnistRandomFFTConfig(
        synthetic=N_TRAIN, num_ffts=NUM_FFTS, block_size=BLOCK, lam=LAM
    )
    train, test = jm._load(conf, "train"), jm._load(conf, "test")
    jbf = jm.build_batch_featurizers(NUM_FFTS, BLOCK, seed=0)
    signs = [[np.asarray(c.nodes[0].signs) for c in batch] for batch in jbf]
    return train, test, jbf, signs


def _weights(model):
    return np.concatenate([np.asarray(x) for x in model.xs], axis=0)


def _compare(tmodel, tpred, jmodel, jpred, test, tol=1e-3):
    jw, tw = _weights(jmodel), _weights(tmodel)
    gap = np.abs(tw - jw).max() / np.abs(jw).max()
    print(f"weights differ by {gap:.3e} of max|x| (limit {tol:g})")
    assert gap <= tol
    tpred, jpred = np.asarray(tpred), np.asarray(jpred)
    assert (tpred == jpred).mean() >= 0.995
    terr = MulticlassClassifierEvaluator(10)(torch.from_numpy(tpred), test.labels).error
    jerr = JEvaluator(10)(jpred, test.labels).error
    assert abs(terr - jerr) <= 1.0 / len(test)


def test_port_loads_the_same_rows():
    conf = tm.MnistRandomFFTConfig(synthetic=300)
    jconf = jm.MnistRandomFFTConfig(synthetic=300)
    for which in ("train", "test"):
        t, j = tm._load(conf, which), jm._load(jconf, which)
        np.testing.assert_array_equal(t.data, j.data)
        np.testing.assert_array_equal(t.labels, j.labels)


def test_classic_fit_matches_jax(slice_inputs):
    train, test, jbf, signs = slice_inputs
    jest = JBLS(block_size=BLOCK, num_iter=1, lam=LAM)
    jmodel = jest.fit(
        jm.featurize(jbf, jnp.asarray(train.data)),
        JCLI(num_classes=10)(train.labels),
        n_valid=len(train),
    )
    jpred = JMax()(jmodel(jm.featurize(jbf, jnp.asarray(test.data))))

    bank = convert.featurizer_bank(signs, device="cpu")
    tmodel = BlockLeastSquaresEstimator(block_size=BLOCK, num_iter=1, lam=LAM).fit(
        bank(torch.from_numpy(train.data)),
        ClassLabelIndicators(num_classes=10)(train.labels),
        n_valid=len(train),
    )
    tpred = MaxClassifier()(tmodel(bank(torch.from_numpy(test.data))))
    _compare(tmodel, tpred, jmodel, jpred, test)


@pytest.mark.parametrize("gram_op,tol", [("int8", INT8_WEIGHT_TOL), ("fp32", 1e-3)])
def test_streamed_fit_matches_jax(slice_inputs, gram_op, tol):
    train, test, jbf, signs = slice_inputs
    jbank = jm.FeaturizerBank(batches=tuple(tuple(g) for g in jbf))
    jfitted, jp = jplan.fit_streaming(
        JChained(prefix=jbank, est=JBLS(block_size=BLOCK, num_iter=1, lam=LAM)),
        jnp.asarray(train.data),
        JCLI(num_classes=10)(train.labels),
        n_valid=len(train),
        gram=gram_op,
        chunk_size=CHUNK,
        return_plan=True,
    )
    jpred = jplan.execute(JPipeline.of(jbank, jfitted[-1], JMax()), jnp.asarray(test.data))

    tbank = convert.featurizer_bank(signs, device="cpu")
    tfitted, tp = tplan.fit_streaming(
        ChainedLabelEstimator(
            prefix=tbank, est=BlockLeastSquaresEstimator(block_size=BLOCK, num_iter=1, lam=LAM)
        ),
        torch.from_numpy(train.data),
        ClassLabelIndicators(num_classes=10)(train.labels),
        n_valid=len(train),
        device=CPU,
        gram=gram_op,
        chunk_size=CHUNK,
        return_plan=True,
    )
    tpred = tplan.execute(Pipeline.of(tbank, tfitted[-1], MaxClassifier()), torch.from_numpy(test.data), device=CPU)

    jop = next(d for d in jp.decisions if d["action"] == "fit_operator")
    top = tp.decision("fit_operator")
    assert top["op"] == jop["op"] == gram_op
    if gram_op == "int8":
        assert top["quantization_error"] == pytest.approx(jop["quantization_error"], rel=1e-3)
    assert tp.chunk_size == jp.chunk_size == CHUNK
    _compare(tfitted[-1], tpred, jfitted[-1], jpred, test, tol=tol)


def _jax_features(jbf, rows):
    return np.concatenate([np.asarray(b) for b in jm.featurize(jbf, jnp.asarray(rows))], axis=1)


def test_int8_codes_flip_rarely(slice_inputs):
    """The witness for the int8 slice's looser weight limit: each package
    featurizes, centers and quantizes the first fit chunk on its own; the
    features agree to f32 rounding, and only a handful of codes land one
    step apart."""
    train, _, jbf, signs = slice_inputs
    rows = train.data[:CHUNK]
    jf = _jax_features(jbf, rows)
    tf = torch.cat(convert.featurizer_bank(signs, device="cpu")(torch.from_numpy(rows)), dim=-1)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0, atol=1e-5 * np.abs(jf).max())
    jq = np.asarray(j_quantize_cols(jnp.asarray(jf) - jnp.asarray(jf).mean(axis=0))[0])
    tq = _quantize_cols(tf - tf.mean(dim=0))[0].numpy()
    step = np.abs(tq.astype(np.int32) - jq.astype(np.int32))
    flips = int((step > 0).sum())
    print(f"int8 codes one step apart: {flips} of {step.size}")
    assert step.max() <= 1
    assert flips <= 1e-4 * step.size


def test_streamed_int8_fit_on_shared_features(slice_inputs):
    """The int8 streamed fit held to 1e-3: both packages are given the same
    features, already centered chunk by chunk (in float64), so their chunk
    means are ~0, the centered operand is the same f32 array on both sides,
    and so are its int8 codes."""
    train, test, jbf, _ = slice_inputs
    feats = _jax_features(jbf, train.data)
    shared = np.empty_like(feats)
    for s in range(0, len(feats), CHUNK):
        blk = feats[s : s + CHUNK].astype(np.float64)
        shared[s : s + CHUNK] = (blk - blk.mean(axis=0)).astype(np.float32)
    test_feats = _jax_features(jbf, test.data)

    jfitted, jp = jplan.fit_streaming(
        JChained(prefix=JIdentity(), est=JBLS(block_size=BLOCK, num_iter=1, lam=LAM)),
        jnp.asarray(shared),
        JCLI(num_classes=10)(train.labels),
        n_valid=len(train),
        gram="int8",
        chunk_size=CHUNK,
        return_plan=True,
    )
    jpred = JMax()(jfitted[-1](jnp.asarray(test_feats)))
    tfitted, tp = tplan.fit_streaming(
        ChainedLabelEstimator(
            prefix=Identity(), est=BlockLeastSquaresEstimator(block_size=BLOCK, num_iter=1, lam=LAM)
        ),
        torch.from_numpy(shared),
        ClassLabelIndicators(num_classes=10)(train.labels),
        n_valid=len(train),
        device=CPU,
        gram="int8",
        chunk_size=CHUNK,
        return_plan=True,
    )
    tpred = MaxClassifier()(tfitted[-1](torch.from_numpy(test_feats)))
    assert tp.decision("fit_operator")["op"] == "int8"
    assert next(d for d in jp.decisions if d["action"] == "fit_operator")["op"] == "int8"
    _compare(tfitted[-1], tpred, jfitted[-1], jpred, test, tol=1e-3)


@pytest.mark.parametrize("plan_on,gram_op", [(False, None), (True, "int8"), (True, "fp32")])
def test_entry_point_on_cpu(monkeypatch, plan_on, gram_op):
    """``main`` runs both branches on the CPU when asked to."""
    if plan_on:
        monkeypatch.setenv("KEYSTONE_PLAN", "1")
        monkeypatch.setenv("KEYSTONE_GRAM_OP", gram_op)
    else:
        monkeypatch.delenv("KEYSTONE_PLAN", raising=False)
    res = tm.main(
        ["--synthetic", "1200", "--num-ffts", "2", "--block-size", "512", "--lam", "0.01"],
        device="cpu",
    )
    assert res["device"] == "cpu"
    assert res["train_error"] < 0.05 and res["test_error"] < 0.05
    assert res["test_predictions"].shape == (200,)
    if plan_on:
        op = next(d for d in res["fit_decisions"] if d["action"] == "fit_operator")
        assert op["op"] == gram_op
    else:
        assert "fit_decisions" not in res
