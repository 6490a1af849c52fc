"""CIFAR-10 random-filter convolution — port of
``keystone_tpu/models/cifar_random.py`` (the reference's
``RandomCifar.scala``): a Gaussian random filter bank (no patch sampling,
no whitening) convolved with patch normalization, then
``SymmetricRectifier → sum Pooler → ImageVectorizer`` (rewritten by
:func:`optimize` into the fused node) → ``StandardScaler`` dividing by the
std → the exact ridge ``LinearMapEstimator`` → argmax → error.

Two fit paths, as in the reference:

- ``KEYSTONE_PLAN=1``: the planner's fused fit streams the raw features
  through the scaler and the normal-equation accumulation
  (``plan.fit_streaming``), so the scaled copy never exists whole;
- classic: the scaled features resident, one exact fit.

Run on the card: ``python -m keystone_tpu_torch.models.cifar_random
--synthetic 50000 --num-filters 256``; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from keystone_tpu_torch import plan as plan_mod
from keystone_tpu_torch.core.batching import apply_in_chunks, pad_labels
from keystone_tpu_torch.core.config import arg, parse_config
from keystone_tpu_torch.core.fusion import optimize
from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.core.pipeline import ChainedLabelEstimator
from keystone_tpu_torch.core.runtime import resolve_device, synchronize
from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
from keystone_tpu_torch.models.cifar_linear_pixels import LinearPixelsConfig, _load
from keystone_tpu_torch.ops.images import (
    Convolver,
    ImageVectorizer,
    Pooler,
    SymmetricRectifier,
)
from keystone_tpu_torch.ops.linear import LinearMapEstimator
from keystone_tpu_torch.ops.stats import StandardScaler
from keystone_tpu_torch.ops.util import ClassLabelIndicators, MaxClassifier
from keystone_tpu_torch.parallel.mesh import shard_batch

logger = get_logger("keystone_tpu_torch.models.cifar_random")

NUM_CLASSES = 10


@dataclasses.dataclass
class RandomCifarFilterConfig:
    """Random-filter CIFAR workload (reference RandomCifarConfig,
    RandomCifar.scala:72-81)."""

    train_location: str = arg(default="", help="CIFAR-10 binary file/dir")
    test_location: str = arg(default="", help="CIFAR-10 binary file/dir")
    num_filters: int = arg(default=100)
    patch_size: int = arg(default=6)
    pool_size: int = arg(default=14)
    pool_stride: int = arg(default=13)
    alpha: float = arg(default=0.25, help="rectifier offset")
    lam: float = arg(default=0.0, help="L2 regularization (0 = OLS)")
    chunk_size: int = arg(default=1024, help="featurization chunk (images)")
    sample_frac: float = arg(default=0.0, help="if > 0, subsample train")
    seed: int = arg(default=0)
    synthetic: int = arg(default=0, help="if > 0, N synthetic samples")


def random_filters(conf: RandomCifarFilterConfig, n_train: int) -> tuple:
    """``(keep, filters)``: the ``sample_frac`` mask of the train rows (None
    when 0) and the (num_filters, patch_size²·3) float32 Gaussian bank,
    drawn in that order from one numpy generator seeded with
    ``conf.seed``, as the JAX package draws them."""
    rng = np.random.default_rng(conf.seed)
    keep = rng.random(n_train) < conf.sample_frac if conf.sample_frac > 0.0 else None
    filters = rng.normal(size=(conf.num_filters, conf.patch_size**2 * 3)).astype(np.float32)
    return keep, filters


def make_featurizer(filters, conf: RandomCifarFilterConfig):
    """The conv chain after :func:`optimize`: ``FusedConvRectifyPool >>
    ImageVectorizer`` over ``filters`` with patch normalization and no
    whitener means."""
    return optimize(
        Convolver(
            filters=filters,
            whitener_means=None,
            patch_size=conf.patch_size,
            normalize_patches=True,
        )
        >> SymmetricRectifier(alpha=conf.alpha)
        >> Pooler(stride=conf.pool_stride, pool_size=conf.pool_size)
        >> ImageVectorizer()
    )


def run(conf: RandomCifarFilterConfig, device=None, mesh=None) -> dict:
    """Fit and evaluate on ``device`` (default: the card). With a ``mesh``
    the rows are padded to its data axis (:func:`shard_batch`)."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    lp_conf = LinearPixelsConfig(
        train_location=conf.train_location,
        test_location=conf.test_location,
        synthetic=conf.synthetic,
    )
    train, test = _load(lp_conf, "train"), _load(lp_conf, "test")
    t_load = time.perf_counter()

    keep, filters = random_filters(conf, len(train))
    if keep is not None:
        train = dataclasses.replace(train, images=train.images[keep], labels=train.labels[keep])
    n_train, n_test = len(train), len(test)
    featurizer = make_featurizer(torch.from_numpy(filters).to(device), conf)
    t_setup = time.perf_counter()

    def featurize(images):
        x = shard_batch(images, mesh, device=device) if mesh is not None else images
        return apply_in_chunks(featurizer, x, conf.chunk_size, device)

    f_train_raw = featurize(train.images)
    scaler = StandardScaler(normalize_std_dev=True).fit(f_train_raw, n_valid=n_train)
    y = pad_labels(train.labels, f_train_raw.shape[0])
    indicators = ClassLabelIndicators(num_classes=NUM_CLASSES)(y).to(device)
    synchronize(device)
    t_feat = time.perf_counter()

    fit_plan = None
    if plan_mod.enabled():
        fitted, fit_plan = plan_mod.fit_streaming(
            ChainedLabelEstimator(prefix=scaler, est=LinearMapEstimator(lam=conf.lam)),
            f_train_raw,
            indicators,
            n_valid=n_train,
            device=device,
            return_plan=True,
        )
        apply_model = score_train = fitted
        train_in = f_train_raw
    else:
        f_train = scaler(f_train_raw)
        model = LinearMapEstimator(lam=conf.lam).fit(f_train, indicators, n_valid=n_train)
        apply_model = lambda raw: model(scaler(raw))  # noqa: E731
        # the scaled copy is resident: score it, not the raw features again
        score_train, train_in = model, f_train
    synchronize(device)
    t_fit = time.perf_counter()

    classify = MaxClassifier()
    evaluator = MulticlassClassifierEvaluator(NUM_CLASSES)
    train_eval = evaluator(classify(score_train(train_in)), y, n_valid=n_train)
    f_test_raw = featurize(test.images)
    test_pred = classify(apply_model(f_test_raw))
    test_eval = evaluator(test_pred, pad_labels(test.labels, f_test_raw.shape[0]), n_valid=n_test)
    synchronize(device)
    t_end = time.perf_counter()

    result = {
        "train_error": train_eval.error,
        "test_error": test_eval.error,
        "n_train": n_train,
        "n_test": n_test,
        "setup_s": t_setup - t0,
        "featurize_s": t_feat - t_setup,
        "fit_s": t_fit - t_feat,
        "total_s": t_end - t0,
        "featurize_fit_samples_per_s": n_train / (t_fit - t_setup),
        "device": str(device),
        "load_s": t_load - t0,
        "num_features": int(f_train_raw.shape[1]),
        "test_predictions": test_pred[:n_test].cpu().numpy(),
    }
    if fit_plan is not None:
        result["fit_decisions"] = fit_plan.decisions
    logger.info(
        "RandomCifar: train err %.4f, test err %.4f, %.0f samples/s",
        train_eval.error,
        test_eval.error,
        result["featurize_fit_samples_per_s"],
    )
    return result


def main(argv=None, device=None) -> dict:
    """CLI entry: the config flags plus ``--device`` (default: the card)."""
    import argparse

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None)
    known, rest = pre.parse_known_args(argv)
    conf = parse_config(RandomCifarFilterConfig, rest)
    if not conf.synthetic and not (conf.train_location and conf.test_location):
        raise SystemExit("need --train-location AND --test-location, or --synthetic N")
    return run(conf, device=device if device is not None else known.device)


if __name__ == "__main__":
    main()
