"""TIMIT phoneme classification — port of
``keystone_tpu/models/timit_pipeline.py``: 440-wide pre-featurized frames
→ ``num_cosines`` banks of ``cosine_features`` cosine random features
(Gaussian or Cauchy W), each standard-scaled → block least squares over
the banks with ``num_epochs`` BCD passes → argmax → multiclass error over
147 classes.

Two fit paths, as in the reference:

- streamed (``KEYSTONE_PLAN=1``, no ``--lam-sweep``, no
  ``--checkpoint-dir``): the planner's fused fit streams 8,192-row chunks
  through the bank and the normal-equation accumulation (the int8 Gram,
  kernel K1, when the planner's cost model picks it), then solves the
  Gram-form BCD; the bank's blocks never exist for the whole corpus;
- classic: every bank's scaled block is resident and fitted by the
  data-form BCD through :func:`checkpointed_fit`; ``--lam-sweep`` picks λ
  on a held-out tenth of the train rows first.

Scoring runs in 8,192-row chunks (:func:`apply_in_chunks`): it is
row-wise, so the result is the whole batch's, and the bank's output for
131,072 rows at D = 32,768 would be 17 GB of f32.

Run on the card: ``python -m keystone_tpu_torch.models.timit_pipeline
--synthetic 131072 --num-cosines 8 --cosine-features 4096``;
``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from keystone_tpu_torch import plan as plan_mod
from keystone_tpu_torch.core.batching import apply_in_chunks, pad_labels
from keystone_tpu_torch.core.checkpoint import checkpointed_fit
from keystone_tpu_torch.core.config import arg, parse_config
from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.core.pipeline import ChainedLabelEstimator, Pipeline, Transformer
from keystone_tpu_torch.core.runtime import resolve_device, synchronize
from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
from keystone_tpu_torch.evaluation.model_selection import holdout_lambda_sweep
from keystone_tpu_torch.loaders.labeled import LabeledData
from keystone_tpu_torch.loaders.timit import NUM_CLASSES, TIMIT_DIMENSION, load_timit_split
from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.stats import CosineRandomFeatures, StandardScaler
from keystone_tpu_torch.ops.util import ClassLabelIndicators, MaxClassifier
from keystone_tpu_torch.parallel.mesh import shard_batch

logger = get_logger("keystone_tpu_torch.models.timit")

SCORE_CHUNK = 8192


@dataclasses.dataclass
class TimitConfig:
    """TIMIT workload (reference TimitConfig: 50 batches x 4096 cosine
    features, gamma 0.0555, 5 epochs)."""

    train_data_location: str = arg(default="")
    train_labels_location: str = arg(default="")
    test_data_location: str = arg(default="")
    test_labels_location: str = arg(default="")
    num_cosines: int = arg(default=50, help="number of 4096-wide batches")
    cosine_features: int = arg(default=4096)
    gamma: float = arg(default=0.05555)
    rf_type: str = arg(default="gaussian", choices=("gaussian", "cauchy"))
    lam: float = arg(default=0.0)
    lam_sweep: str = arg(
        default="",
        help="comma-separated λ list: ridge path at shared-Gram cost, "
        "selected on a held-out 10%% of train, refit at the winner "
        "(overrides --lam)",
    )
    num_epochs: int = arg(default=5)
    checkpoint_dir: str = arg(
        default="",
        help="checkpoint the solver between BCD epochs and resume from this directory",
    )
    checkpoint_every: int = arg(default=1, help="BCD epochs per checkpoint chunk")
    seed: int = arg(default=123)
    synthetic: int = arg(default=0, help="if > 0, N synthetic frames")


@dataclasses.dataclass(eq=False)
class ScaledCosineBank(Transformer):
    """The whole TIMIT featurizer as one row-wise Transformer: every
    (cosine features → fitted scaler) chain applied to the batch, giving
    the list of (N, cosine_features) blocks the block solver takes. The
    planner's fused fit folds it into the streaming sink."""

    chains: tuple  # of Pipeline(featurizer >> fitted scaler)

    def __call__(self, batch):
        return [chain(batch) for chain in self.chains]


def make_featurizers(conf: TimitConfig, device) -> list:
    """``num_cosines`` cosine banks drawn in order from one generator
    seeded with ``conf.seed``, placed on ``device``."""
    gen = torch.Generator().manual_seed(conf.seed)
    return [
        CosineRandomFeatures.create(
            TIMIT_DIMENSION,
            conf.cosine_features,
            gen,
            gamma=conf.gamma,
            distribution=conf.rf_type,
            device=device,
        )
        for _ in range(conf.num_cosines)
    ]


def fit_scalers(featurizers, x, n_valid: int, keep_blocks: bool) -> tuple:
    """One pass per bank: its scaler fitted on the raw features of the
    first ``n_valid`` rows, and (``keep_blocks``) its scaled block kept.
    Returns ``(scalers, blocks)``."""
    scalers, blocks = [], []
    for f in featurizers:
        raw = f(x)
        scaler = StandardScaler().fit(raw, n_valid=n_valid)
        scalers.append(scaler)
        if keep_blocks:
            blocks.append(scaler(raw))
        del raw
    return scalers, blocks


def _load(conf: TimitConfig, which: str) -> LabeledData:
    if conf.synthetic:
        n = conf.synthetic if which == "train" else max(conf.synthetic // 5, 1)
        rng = np.random.default_rng(0 if which == "train" else 1)
        k = min(NUM_CLASSES, 12)
        labels = rng.integers(0, k, size=n).astype(np.int32)
        centers = np.random.default_rng(42).normal(size=(k, TIMIT_DIMENSION))
        data = (centers[labels] * 2 + rng.normal(size=(n, TIMIT_DIMENSION))).astype(
            np.float32
        )
        return LabeledData(labels=labels, data=data)
    if which == "train":
        return load_timit_split(conf.train_data_location, conf.train_labels_location)
    return load_timit_split(conf.test_data_location, conf.test_labels_location)


def run(conf: TimitConfig, device=None, mesh=None) -> dict:
    """Fit and evaluate on ``device`` (default: the card). With a ``mesh``
    the rows are padded to its data axis and placed on its first device
    (:func:`shard_batch`). The result holds the reference's keys, the test
    predictions, and, for the streamed fit, the planner's decisions."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    train, test = _load(conf, "train"), _load(conf, "test")
    n_train, n_test = len(train), len(test)
    x_train = shard_batch(train.data, mesh, device=device)
    x_test = shard_batch(test.data, mesh, device=device)
    featurizers = make_featurizers(conf, x_train.device)
    t_load = time.perf_counter()

    # the λ sweep and the checkpointed fit consume resident blocks: those
    # runs keep the classic path
    streamed_fit = plan_mod.enabled() and not (conf.lam_sweep or conf.checkpoint_dir)
    scalers, train_blocks = fit_scalers(featurizers, x_train, n_train, not streamed_fit)
    y = pad_labels(train.labels, x_train.shape[0])
    indicators = ClassLabelIndicators(num_classes=NUM_CLASSES)(y).to(x_train.device)
    synchronize(x_train.device)
    t_feat = time.perf_counter()

    lam, sweep = conf.lam, None
    if conf.lam_sweep:
        # selection at one BCD pass: cheap next to the final multi-epoch fit
        sweep = holdout_lambda_sweep(
            BlockLeastSquaresEstimator(block_size=conf.cosine_features, num_iter=1),
            train_blocks,
            indicators,
            y,
            conf.lam_sweep,
            n_train=n_train,
            num_classes=NUM_CLASSES,
        )
        lam = sweep["best_lam"]
        logger.info(
            "lambda sweep %s -> val errors %s; refitting at best lam=%g",
            sweep["lams"],
            [round(e, 4) for e in sweep["val_errors"]],
            lam,
        )
    est = BlockLeastSquaresEstimator(
        block_size=conf.cosine_features, num_iter=conf.num_epochs, lam=lam
    )
    bank = ScaledCosineBank(chains=tuple(Pipeline.of(f, s) for f, s in zip(featurizers, scalers)))
    fit_plan = None
    if streamed_fit:
        fitted, fit_plan = plan_mod.fit_streaming(
            ChainedLabelEstimator(prefix=bank, est=est),
            x_train,
            indicators,
            n_valid=n_train,
            device=x_train.device,
            return_plan=True,
        )
        model = fitted[-1]
    else:
        model = checkpointed_fit(
            est,
            train_blocks,
            indicators,
            checkpoint_dir=conf.checkpoint_dir,
            every=conf.checkpoint_every,
            n_valid=n_train,
        )
    synchronize(x_train.device)
    t_fit = time.perf_counter()

    classify = MaxClassifier()
    evaluator = MulticlassClassifierEvaluator(NUM_CLASSES)
    score = Pipeline.of(bank, model, classify)
    # classic path: the blocks are already resident — don't re-featurize
    if streamed_fit:
        train_pred = apply_in_chunks(score, x_train, SCORE_CHUNK, x_train.device)
    else:
        train_pred = classify(model(train_blocks))
    del train_blocks
    train_eval = evaluator(train_pred, y, n_valid=n_train)
    test_pred = apply_in_chunks(score, x_test, SCORE_CHUNK, x_test.device)
    test_eval = evaluator(test_pred, pad_labels(test.labels, x_test.shape[0]), n_valid=n_test)
    synchronize(x_train.device)
    t_end = time.perf_counter()

    result = {
        "train_error": train_eval.error,
        "test_error": test_eval.error,
        "n_train": n_train,
        "n_test": n_test,
        "featurize_s": t_feat - t_load,
        "fit_s": t_fit - t_feat,
        "total_s": t_end - t0,
        "device": str(x_train.device),
        "load_s": t_load - t0,
        "train_samples_per_s": n_train / (t_fit - t_load),
        "test_predictions": test_pred[:n_test].cpu().numpy(),
    }
    if sweep is not None:
        result["lam_sweep"] = sweep
    if fit_plan is not None:
        result["fit_decisions"] = fit_plan.decisions
        result["fit_chunk_size"] = fit_plan.chunk_size
    logger.info(
        "Timit: train err %.4f, test err %.4f", train_eval.error, test_eval.error
    )
    return result


def main(argv=None, device=None) -> dict:
    """CLI entry: the config flags plus ``--device`` (default: the card)."""
    import argparse

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None)
    known, rest = pre.parse_known_args(argv)
    conf = parse_config(TimitConfig, rest)
    if not conf.synthetic and not conf.train_data_location:
        raise SystemExit("need the four TIMIT locations, or --synthetic N")
    return run(conf, device=device if device is not None else known.device)


if __name__ == "__main__":
    main()
