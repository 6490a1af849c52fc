"""CIFAR-10 LinearPixels — port of
``keystone_tpu/models/cifar_linear_pixels.py``: grayscale pixels, flattened,
then an exact linear solve (the reference's ``LinearPixels.scala``).

Run on the card: ``python -m keystone_tpu_torch.models.cifar_linear_pixels
--synthetic 50000`` (or ``--train-location``/``--test-location`` of CIFAR-10
binary files); ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from keystone_tpu_torch.core.batching import pad_labels
from keystone_tpu_torch.core.config import arg, parse_config
from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.core.runtime import resolve_device, synchronize
from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.cifar import load_cifar
from keystone_tpu_torch.ops.images import GrayScaler, ImageVectorizer
from keystone_tpu_torch.ops.linear import LinearMapEstimator
from keystone_tpu_torch.ops.util import ClassLabelIndicators, MaxClassifier
from keystone_tpu_torch.parallel.mesh import shard_batch
from keystone_tpu_torch.utils.images import LabeledImages

logger = get_logger("keystone_tpu_torch.models.cifar_linear_pixels")

NUM_CLASSES = 10


@dataclasses.dataclass
class LinearPixelsConfig:
    """CIFAR LinearPixels workload (reference LinearPixelsConfig)."""

    train_location: str = arg(default="", help="CIFAR-10 binary file/dir")
    test_location: str = arg(default="", help="CIFAR-10 binary file/dir")
    lam: float = arg(default=0.0, help="L2 regularization")
    synthetic: int = arg(default=0, help="if > 0, N synthetic samples")


def _load(conf: LinearPixelsConfig, which: str) -> LabeledImages:
    """The split's images: the CIFAR-10 files, or ``synthetic`` train rows
    (a fifth of that for test) around ten fixed class centres, drawn from
    the same numpy seeds as the JAX package's."""
    if conf.synthetic:
        n = conf.synthetic if which == "train" else max(conf.synthetic // 5, 1)
        rng = np.random.default_rng(0 if which == "train" else 1)
        labels = rng.integers(0, NUM_CLASSES, size=n).astype(np.int32)
        centers = np.random.default_rng(42).normal(
            loc=128, scale=40, size=(NUM_CLASSES, 32, 32, 3)
        )
        images = (centers[labels] + rng.normal(scale=25, size=(n, 32, 32, 3))).astype(
            np.float32
        )
        return LabeledImages(labels=labels, images=images)
    return load_cifar(conf.train_location if which == "train" else conf.test_location)


def run(conf: LinearPixelsConfig, device=None, mesh=None) -> dict:
    """Fit and evaluate on ``device`` (default: the card). With a ``mesh``
    the rows are padded to its data axis (:func:`shard_batch`)."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    train, test = _load(conf, "train"), _load(conf, "test")

    featurizer = GrayScaler() >> ImageVectorizer()
    x_train = shard_batch(train.images, mesh, device=device)
    x_test = shard_batch(test.images, mesh, device=device)
    y = pad_labels(train.labels, x_train.shape[0])
    indicators = ClassLabelIndicators(num_classes=NUM_CLASSES)(y).to(x_train.device)

    f_train = featurizer(x_train)
    model = LinearMapEstimator(lam=conf.lam).fit(f_train, indicators, n_valid=len(train))

    predict = featurizer >> model >> MaxClassifier()
    evaluator = MulticlassClassifierEvaluator(NUM_CLASSES)
    train_eval = evaluator(predict(x_train), y, n_valid=len(train))
    y_test = pad_labels(test.labels, x_test.shape[0])
    test_eval = evaluator(predict(x_test), y_test, n_valid=len(test))
    synchronize(x_train.device)

    result = {
        "train_error": train_eval.error,
        "test_error": test_eval.error,
        "n_train": len(train),
        "n_test": len(test),
        "total_s": time.perf_counter() - t0,
    }
    logger.info(
        "LinearPixels: train acc %.4f, test acc %.4f", train_eval.accuracy, test_eval.accuracy
    )
    return result


def main(argv=None, device=None) -> dict:
    """CLI entry: the config flags plus ``--device`` (default: the card)."""
    import argparse

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None)
    known, rest = pre.parse_known_args(argv)
    conf = parse_config(LinearPixelsConfig, rest)
    if not conf.synthetic and not (conf.train_location and conf.test_location):
        raise SystemExit("need --train-location AND --test-location, or --synthetic N")
    return run(conf, device=device if device is not None else known.device)


if __name__ == "__main__":
    main()
