"""CIFAR-10 random-patch convolution — port of
``keystone_tpu/models/cifar_random_patch.py`` (the reference's
``RandomPatchCifar.scala``), the flagship image workload:

1. sample windows of the training images (``Windower`` → vectorize →
   subsample to :data:`WHITENER_SAMPLES`);
2. normalize each patch (variance constant 10) and fit a ZCA whitener;
3. filters: whitened, L2-normalized sampled patches, folded back through
   ``Wᵀ`` so the convolution sees mean-subtracted normalized patches;
4. featurize: ``Convolver → SymmetricRectifier → sum Pooler →
   ImageVectorizer`` rewritten by :func:`optimize` into the fused node,
   in chunks staged to the device (:func:`apply_in_chunks`), then a
   ``StandardScaler``;
5. block least squares on ±1 indicators (one pass) → argmax → error.

Run on the card: ``python -m keystone_tpu_torch.models.cifar_random_patch
--synthetic 50000 --num-filters 256`` (or ``--train-location`` and
``--test-location`` of CIFAR-10 binary files); ``--device cpu`` runs on
the CPU.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from keystone_tpu_torch.core.batching import apply_in_chunks, pad_labels
from keystone_tpu_torch.core.config import arg, parse_config
from keystone_tpu_torch.core.fusion import optimize
from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.core.runtime import resolve_device, synchronize
from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
from keystone_tpu_torch.models.cifar_linear_pixels import LinearPixelsConfig, _load
from keystone_tpu_torch.ops.images import (
    Convolver,
    ImageVectorizer,
    Pooler,
    SymmetricRectifier,
    Windower,
    normalize_patch_rows,
)
from keystone_tpu_torch.ops.linalg import ZCAWhitenerEstimator
from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.stats import StandardScaler
from keystone_tpu_torch.ops.util import ClassLabelIndicators, MaxClassifier
from keystone_tpu_torch.parallel.mesh import shard_batch

logger = get_logger("keystone_tpu_torch.models.cifar_random_patch")

NUM_CLASSES = 10
WHITENER_SAMPLES = 100_000


@dataclasses.dataclass
class RandomCifarConfig:
    """Random-patch CIFAR workload (reference RandomCifarConfig)."""

    train_location: str = arg(default="", help="CIFAR-10 binary file/dir")
    test_location: str = arg(default="", help="CIFAR-10 binary file/dir")
    num_filters: int = arg(default=100)
    patch_size: int = arg(default=6)
    patch_steps: int = arg(default=1)
    pool_size: int = arg(default=14)
    pool_stride: int = arg(default=13)
    alpha: float = arg(default=0.25, help="rectifier offset")
    lam: float = arg(default=0.0, help="L2 regularization")
    block_size: int = arg(default=4096)
    chunk_size: int = arg(default=1024, help="featurization chunk (images)")
    seed: int = arg(default=0)
    synthetic: int = arg(default=0, help="if > 0, N synthetic samples")


def patch_sample(images: np.ndarray, conf: RandomCifarConfig, rng, device) -> torch.Tensor:
    """The whitener's sample on ``device``: every window of ``2·⌊100,000 /
    windows per image⌋`` images drawn by ``rng``, subsampled by ``rng``
    to :data:`WHITENER_SAMPLES` rows, each row normalized (variance
    constant 10). (rows, k²C)."""
    per_image = ((images.shape[1] - conf.patch_size) // conf.patch_steps + 1) ** 2
    n_img = min(images.shape[0], max(WHITENER_SAMPLES // max(per_image, 1), 1) * 2)
    idx = rng.choice(images.shape[0], size=n_img, replace=False)
    windows = Windower(stride=conf.patch_steps, window_size=conf.patch_size)(
        torch.as_tensor(images[np.sort(idx)], device=device)
    )
    flat = ImageVectorizer()(windows)
    if flat.shape[0] > WHITENER_SAMPLES:
        sel = rng.choice(flat.shape[0], WHITENER_SAMPLES, replace=False)
        flat = flat[torch.as_tensor(np.sort(sel), device=device)]
    return normalize_patch_rows(flat, 10.0)


def build_filters(
    images: np.ndarray, conf: RandomCifarConfig, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample patches, fit the ZCA whitener, build whitened normalized
    filters on ``device`` (default: the card). Returns (filters (F, k²C),
    whitener means (k²C,)); the whitener is folded into the filters.

    One numpy generator seeded with ``conf.seed`` draws, in the JAX
    package's order, the images, the window subsample and the filters,
    so the filters are the reference's up to float rounding."""
    device = resolve_device(device)
    rng = np.random.default_rng(conf.seed)
    base = patch_sample(images, conf, rng, device)
    whitener = ZCAWhitenerEstimator().fit(base)
    sel = rng.choice(base.shape[0], conf.num_filters, replace=False)
    unnorm = whitener(base[torch.as_tensor(np.sort(sel), device=device)])
    norms = torch.linalg.norm(unnorm, dim=1, keepdim=True)
    filters = (unnorm / (norms + 1e-10)) @ whitener.whitener.T
    return filters, whitener.means


def make_featurizer(filters, means, conf: RandomCifarConfig):
    """The conv chain after :func:`optimize`: ``FusedConvRectifyPool >>
    ImageVectorizer``."""
    return optimize(
        Convolver(
            filters=filters,
            whitener_means=means,
            patch_size=conf.patch_size,
            normalize_patches=True,
        )
        >> SymmetricRectifier(alpha=conf.alpha)
        >> Pooler(stride=conf.pool_stride, pool_size=conf.pool_size)
        >> ImageVectorizer()
    )


def run(conf: RandomCifarConfig, device=None, mesh=None) -> dict:
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
    n_train, n_test = len(train), len(test)
    t_load = time.perf_counter()

    filters, means = build_filters(train.images, conf, device)
    featurizer = make_featurizer(filters, means, conf)
    synchronize(device)
    t_setup = time.perf_counter()

    def featurize(images):
        x = shard_batch(images, mesh, device=device) if mesh is not None else images
        return apply_in_chunks(featurizer, x, conf.chunk_size, device)

    f_train_raw = featurize(train.images)
    scaler = StandardScaler().fit(f_train_raw, n_valid=n_train)
    f_train = scaler(f_train_raw)
    del f_train_raw
    y = pad_labels(train.labels, f_train.shape[0])
    indicators = ClassLabelIndicators(num_classes=NUM_CLASSES)(y).to(device)
    synchronize(device)
    t_feat = time.perf_counter()

    est = BlockLeastSquaresEstimator(block_size=conf.block_size, num_iter=1, lam=conf.lam)
    model = est.fit(f_train, indicators, n_valid=n_train)
    synchronize(device)
    t_fit = time.perf_counter()

    classify = MaxClassifier()
    evaluator = MulticlassClassifierEvaluator(NUM_CLASSES)
    train_eval = evaluator(classify(model(f_train)), y, n_valid=n_train)
    f_test = scaler(featurize(test.images))
    test_pred = classify(model(f_test))
    test_eval = evaluator(test_pred, pad_labels(test.labels, f_test.shape[0]), n_valid=n_test)
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
        "num_features": int(f_train.shape[1]),
        "test_predictions": test_pred[:n_test].cpu().numpy(),
    }
    logger.info(
        "RandomPatchCifar: train err %.4f, test err %.4f, %.0f samples/s",
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
    conf = parse_config(RandomCifarConfig, rest)
    if not conf.synthetic and not (conf.train_location and conf.test_location):
        raise SystemExit("need --train-location AND --test-location, or --synthetic N")
    return run(conf, device=device if device is not None else known.device)


if __name__ == "__main__":
    main()
