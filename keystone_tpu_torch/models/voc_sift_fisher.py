"""PASCAL VOC SIFT + Fisher vector pipeline — port of
``keystone_tpu/models/voc_sift_fisher.py`` (the reference's
``VOCSIFTFisher.scala``).

Stages: pixel-scale → grayscale → dense SIFT → PCA projection (fitted on
sampled descriptor columns, or loaded from a CSV artifact) → GMM (fitted
on sampled projected descriptors, or loaded) → Fisher vectors →
vectorize → L2 → signed sqrt → L2 → block least squares on ±1
multi-label indicators → mean average precision. Every descriptor stays
resident on the device, as in the reference's design.

Run on the card: ``python -m keystone_tpu_torch.models.voc_sift_fisher
--synthetic 1024`` (or ``--train-location``/``--train-labels`` and the
test pair for VOC2007 tars); ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from keystone_tpu_torch.core.batching import apply_in_chunks
from keystone_tpu_torch.core.config import arg, parse_config
from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.core.runtime import resolve_device, synchronize
from keystone_tpu_torch.evaluation import MeanAveragePrecisionEvaluator
from keystone_tpu_torch.loaders.image_loaders import VOC_NUM_CLASSES, load_voc
from keystone_tpu_torch.models.fisher_common import FisherBranch
from keystone_tpu_torch.ops.images import GrayScaler, PixelScaler
from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.sift import SIFTExtractor
from keystone_tpu_torch.ops.util import ClassLabelIndicators
from keystone_tpu_torch.utils.images import LabeledImages

logger = get_logger("keystone_tpu_torch.models.voc_sift_fisher")


@dataclasses.dataclass
class VOCConfig:
    """VOC SIFT/Fisher workload (the reference's SIFTFisherConfig
    defaults: descDim 80, vocabSize 256, 1e6 PCA and GMM samples)."""

    train_location: str = arg(default="", help="train tar file/dir/glob")
    train_labels: str = arg(default="", help="train multi-label csv")
    test_location: str = arg(default="", help="test tar file/dir/glob")
    test_labels: str = arg(default="", help="test multi-label csv")
    name_prefix: str = arg(
        default="VOCdevkit/VOC2007/JPEGImages/",
        help="tar entry prefix to load (reference VOCDataPath.namePrefix)",
    )
    desc_dim: int = arg(default=80, help="PCA output dim")
    vocab_size: int = arg(default=256, help="GMM centroids")
    num_pca_samples: int = arg(default=1_000_000)
    num_gmm_samples: int = arg(default=1_000_000)
    lam: float = arg(default=0.5)
    lam_sweep: str = arg(
        default="",
        help="comma-separated λ list: ridge path at shared-Gram cost, "
        "selected by mean-AP on a held-out 10%% of train (overrides "
        "--lam)",
    )
    block_size: int = arg(default=4096)
    chunk_size: int = arg(default=64, help="images per featurize chunk")
    image_size: int = arg(default=256)
    sift_scales: int = arg(default=5)
    seed: int = arg(default=0)
    pca_file: str = arg(default="", help="load/save PCA matrix csv")
    gmm_mean_file: str = arg(default="")
    gmm_var_file: str = arg(default="")
    gmm_wt_file: str = arg(default="")
    synthetic: int = arg(default=0, help="if > 0, N synthetic images")


def _load(conf: VOCConfig, which: str) -> LabeledImages:
    """The split's images: ``synthetic`` train images (a quarter as many
    test images) drawn in the JAX package's numpy order, so they are its
    images, or the VOC tars."""
    if conf.synthetic:
        n = conf.synthetic if which == "train" else max(conf.synthetic // 4, 1)
        rng = np.random.default_rng(0 if which == "train" else 1)
        centers = np.random.default_rng(42).normal(
            loc=128, scale=30, size=(VOC_NUM_CLASSES, 8, 8, 3)
        )
        labels = -np.ones((n, 2), np.int32)
        labels[:, 0] = rng.integers(0, VOC_NUM_CLASSES, size=n)
        # upsample the class pattern to the image size so SIFT sees class structure
        base = centers[labels[:, 0]]
        imgs = np.kron(base, np.ones((1, conf.image_size // 8, conf.image_size // 8, 1)))
        imgs += rng.normal(scale=20, size=imgs.shape)
        return LabeledImages(labels=labels, images=np.clip(imgs, 0, 255).astype(np.float32))
    location, labels = (
        (conf.train_location, conf.train_labels)
        if which == "train"
        else (conf.test_location, conf.test_labels)
    )
    return load_voc(location, labels, target_size=conf.image_size,
                    name_prefix=conf.name_prefix or None)


def run(conf: VOCConfig, device=None) -> dict:
    """Fit and evaluate on ``device`` (default: the card)."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    train = _load(conf, "train")
    test = _load(conf, "test")
    n_train, n_test = len(train), len(test)
    t_load = time.perf_counter()

    gray_sift = PixelScaler() >> GrayScaler() >> SIFTExtractor(num_scales=conf.sift_scales)
    branch = FisherBranch(
        conf.desc_dim,
        conf.vocab_size,
        conf.num_pca_samples,
        conf.num_gmm_samples,
        conf.seed,
        pca_file=conf.pca_file,
        gmm_files=(conf.gmm_mean_file, conf.gmm_var_file, conf.gmm_wt_file),
        device=device,
    )
    sift_train = apply_in_chunks(gray_sift, train.images, conf.chunk_size, device)
    synchronize(device)
    t_sift = time.perf_counter()
    pca_train = branch.fit(sift_train, conf.chunk_size, n_valid=n_train)
    del sift_train
    t_branch = time.perf_counter()
    f_train = branch.featurize_projected(pca_train, conf.chunk_size)
    del pca_train
    synchronize(device)
    t_feat = time.perf_counter()

    y = -np.ones((f_train.shape[0], train.labels.shape[1]), np.int32)
    y[:n_train] = train.labels
    indicators = ClassLabelIndicators(num_classes=VOC_NUM_CLASSES)(y).to(device)
    evaluator = MeanAveragePrecisionEvaluator(VOC_NUM_CLASSES)
    lam = conf.lam
    if conf.lam_sweep:
        from keystone_tpu_torch.evaluation.model_selection import holdout_lambda_sweep

        def map_scorer(model, val_inputs, rows):
            lo, hi = rows
            aps = evaluator(indicators[lo:hi], model(val_inputs)[: hi - lo])
            return -float(np.mean(aps))  # lower loss = higher MAP

        report = holdout_lambda_sweep(
            BlockLeastSquaresEstimator(block_size=conf.block_size, num_iter=1),
            f_train,
            indicators,
            None,
            conf.lam_sweep,
            n_train=n_train,
            scorer=map_scorer,
        )
        lam = report["best_lam"]
        logger.info(
            "lambda sweep %s -> val -MAP %s; refitting at best lam=%g",
            report["lams"],
            [round(e, 4) for e in report["val_errors"]],
            lam,
        )
    model = BlockLeastSquaresEstimator(block_size=conf.block_size, num_iter=1, lam=lam).fit(
        f_train, indicators, n_valid=n_train
    )
    synchronize(device)
    t_fit = time.perf_counter()

    sift_test = apply_in_chunks(gray_sift, test.images, conf.chunk_size, device)
    test_scores = model(branch.featurize(sift_test, conf.chunk_size))
    del sift_test
    y_test = ClassLabelIndicators(num_classes=VOC_NUM_CLASSES)(test.labels)
    aps = evaluator(y_test, test_scores[:n_test])
    train_aps = evaluator(indicators[:n_train], model(f_train)[:n_train])
    synchronize(device)
    t_end = time.perf_counter()

    result = {
        "test_map": float(aps.mean()),
        "train_map": float(train_aps.mean()),
        "n_train": n_train,
        "n_test": n_test,
        "lam": lam,
        "num_features": int(f_train.shape[1]),
        "load_s": t_load - t0,
        "sift_s": t_sift - t_load,
        "pca_s": branch.times.get("pca_s", 0.0),
        "gmm_s": branch.times.get("gmm_s", 0.0),
        "fisher_s": t_feat - t_branch,
        "featurize_s": t_feat - t0,
        "fit_s": t_fit - t_feat,
        "test_s": t_end - t_fit,
        "total_s": t_end - t0,
        "featurize_fit_samples_per_s": n_train / (t_fit - t_load),
        "device": str(device),
    }
    logger.info(
        "VOCSIFTFisher: train MAP %.4f, test MAP %.4f", result["train_map"], result["test_map"]
    )
    return result


def main(argv=None, device=None) -> dict:
    """CLI entry: the config flags plus ``--device`` (default: the card)."""
    import argparse

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None)
    known, rest = pre.parse_known_args(argv)
    conf = parse_config(VOCConfig, rest)
    if not conf.synthetic and not (conf.train_location and conf.train_labels):
        raise SystemExit("need --train-location/--train-labels (+ test), or --synthetic N")
    return run(conf, device=device if device is not None else known.device)


if __name__ == "__main__":
    main()
