"""ImageNet SIFT + LCS Fisher-vector pipeline — port of
``keystone_tpu/models/imagenet_sift_lcs_fv.py`` (the reference's
``ImageNetSiftLcsFV.scala``).

Two descriptor branches — grayscale dense SIFT and color LCS — each with
its own PCA, GMM and Fisher-vector featurization, zipped into one
feature family and solved with the class-weighted block least squares
estimator; the headline metric is top-5 error (the reference's defaults:
descDim 64, vocabSize 16, 4,096-column solver blocks, 1,000 classes).

- :func:`run` holds every descriptor on the device, as the reference's
  eager path does;
- :func:`run_streaming` streams the corpus twice: pass 1 fills bounded
  descriptor-column reservoirs for the PCA and GMM samples, pass 2 keeps
  only the Fisher features. With ``KEYSTONE_PLAN`` both branches ride one
  pixel-scaling prefix a chunk (:func:`~keystone_tpu_torch.plan.apply_shared`)
  and the weighted fit goes through the planner's streaming fit, which
  falls back to the materialized fit when the per-class state does not
  fit the card.

Run on the card: ``python -m keystone_tpu_torch.models.imagenet_sift_lcs_fv
--synthetic 1024`` (``--streaming`` for the two-pass path); ``--device
cpu`` runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from keystone_tpu_torch.core.batching import apply_in_chunks
from keystone_tpu_torch.core.checkpoint import checkpointed_fit
from keystone_tpu_torch.core.config import arg, parse_config
from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.core.runtime import resolve_device, synchronize
from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.image_loaders import load_imagenet
from keystone_tpu_torch.loaders.imagenet_stream import (
    assemble_global,
    render_classes,
    synthetic_centers,
    synthetic_source,
    tar_source,
)
from keystone_tpu_torch.models.fisher_common import FisherBranch
from keystone_tpu_torch.ops.images import GrayScaler, PixelScaler
from keystone_tpu_torch.ops.lcs import LCSExtractor
from keystone_tpu_torch.ops.sift import SIFTExtractor
from keystone_tpu_torch.ops.util import ClassLabelIndicators, TopKClassifier, ZipVectors
from keystone_tpu_torch.ops.weighted_linear import BlockWeightedLeastSquaresEstimator
from keystone_tpu_torch.parallel.mesh import data_sharding, shard_batch
from keystone_tpu_torch.utils.images import LabeledImages

logger = get_logger("keystone_tpu_torch.models.imagenet_sift_lcs_fv")


@dataclasses.dataclass
class ImageNetConfig:
    """ImageNet SIFT/LCS FV workload (the reference's
    ImageNetSiftLcsFVConfig)."""

    train_location: str = arg(default="", help="train tar file/dir/glob")
    test_location: str = arg(default="", help="test tar file/dir/glob")
    label_map: str = arg(default="", help="'synset class_idx' map file")
    num_classes: int = arg(default=1000)
    desc_dim: int = arg(default=64, help="PCA dim per branch")
    vocab_size: int = arg(default=16, help="GMM centroids per branch")
    num_pca_samples: int = arg(default=10_000_000)
    num_gmm_samples: int = arg(default=10_000_000)
    mixture_weight: float = arg(default=0.25)
    lam: float = arg(default=6e-5)
    block_size: int = arg(default=4096)
    num_iter: int = arg(default=1)
    chunk_size: int = arg(default=32)
    image_size: int = arg(default=256)
    sift_scales: int = arg(default=5)
    lcs_stride: int = arg(default=4)
    lcs_border: int = arg(default=16)
    lcs_patch: int = arg(default=6)
    checkpoint_dir: str = arg(
        default="",
        help="if set, checkpoint the weighted solver between BCD passes "
        "and resume from this directory",
    )
    checkpoint_every: int = arg(default=1)
    seed: int = arg(default=0)
    synthetic: int = arg(default=0, help="if > 0, N synthetic images")
    synthetic_classes: int = arg(default=8)
    label_noise: float = arg(
        default=0.0,
        help="fraction q of synthetic images rendered from a random OTHER "
        "class's center while keeping their label: a top-1 error floor of "
        "exactly q",
    )
    streaming: bool = arg(
        default=False,
        help="two-pass streaming ingestion: never materializes the image "
        "corpus or its descriptors on the host (ImageNet-scale)",
    )
    stream_batch: int = arg(default=256, help="host images per stream batch")


def _load(conf: ImageNetConfig, which: str) -> tuple[LabeledImages, int]:
    """The split's images and class count: ``synthetic`` train images (a
    quarter as many test images) drawn in the JAX package's numpy order,
    or the ImageNet tars."""
    if conf.synthetic:
        k = conf.synthetic_classes
        n = conf.synthetic if which == "train" else max(conf.synthetic // 4, 1)
        rng = np.random.default_rng(0 if which == "train" else 1)
        labels = rng.integers(0, k, size=n).astype(np.int32)
        centers = synthetic_centers(k)
        render = render_classes(labels, k, conf.label_noise, rng)
        imgs = np.kron(centers[render], np.ones((1, conf.image_size // 8, conf.image_size // 8, 1)))
        imgs += rng.normal(scale=20, size=imgs.shape)
        return LabeledImages(labels=labels, images=np.clip(imgs, 0, 255).astype(np.float32)), k
    data = load_imagenet(
        conf.train_location if which == "train" else conf.test_location,
        conf.label_map,
        target_size=conf.image_size,
    )
    return data, conf.num_classes


def _descriptor_cols(desc) -> np.ndarray:
    """(N, d, m) device descriptors → (N·m, d) host rows for a reservoir."""
    n, d, m = desc.shape
    return desc.permute(0, 2, 1).reshape(n * m, d).cpu().numpy()


def _branch_apply(branch: FisherBranch, desc):
    """Project and Fisher-encode one descriptor batch."""
    return branch.post(branch.pca(desc))


def _extractors(conf: ImageNetConfig):
    """The SIFT branch's (pixel scale → gray → SIFT) and the LCS branch's
    (pixel scale → LCS) featurizers."""
    sift = SIFTExtractor(num_scales=conf.sift_scales)
    lcs = LCSExtractor(
        stride=conf.lcs_stride, stride_start=conf.lcs_border, sub_patch_size=conf.lcs_patch
    )
    return sift, lcs, PixelScaler() >> GrayScaler() >> sift, PixelScaler() >> lcs


def _branches(conf: ImageNetConfig, device) -> tuple[FisherBranch, FisherBranch]:
    def branch(seed):
        return FisherBranch(conf.desc_dim, conf.vocab_size, conf.num_pca_samples,
                            conf.num_gmm_samples, seed, device=device)

    return branch(conf.seed), branch(conf.seed + 100)


def _estimator(conf: ImageNetConfig, num_classes: int) -> BlockWeightedLeastSquaresEstimator:
    return BlockWeightedLeastSquaresEstimator(
        block_size=conf.block_size,
        num_iter=conf.num_iter,
        lam=conf.lam,
        mixture_weight=conf.mixture_weight,
        class_chunk=min(16, num_classes),
    )


def _top_errors(model, features, labels: np.ndarray, num_classes: int):
    """(top-1 error, top-5 error, (n, k) top-k classes) of the first
    ``len(labels)`` rows."""
    topk = TopKClassifier(k=min(5, num_classes))(model(features))[: len(labels)].cpu().numpy()
    top1 = MulticlassClassifierEvaluator(num_classes)(
        torch.from_numpy(topk[:, 0]), torch.from_numpy(labels)
    ).error
    top5 = 1.0 - float(np.mean((topk == labels[:, None]).any(axis=1)))
    return top1, top5, topk


def _clock(device, t0: float) -> tuple[float, float]:
    synchronize(device)
    t = time.perf_counter()
    return t, t - t0


def run_streaming(
    conf: ImageNetConfig, device=None, mesh=None, train_source=None, test_source=None
) -> dict:
    """Two-pass streaming variant of :func:`run`, on ``device`` (the card
    unless the caller asks for the CPU; with a ``mesh``, its data device).

    Pass 1 streams the corpus once, filling bounded descriptor-column
    reservoirs (the PCA and GMM samples); pass 2 streams it again and
    keeps only the Fisher features and labels. Sources are callables
    returning a fresh (images, labels) iterator, by default this
    process's share of the tar corpus (or the synthetic corpus)."""
    from keystone_tpu_torch import plan as plan_mod
    from keystone_tpu_torch.core.pipeline import ChainedLabelEstimator, Identity
    from keystone_tpu_torch.loaders.streaming import (
        ColumnReservoir,
        featurize_stream,
        prefetch_batches,
    )
    from keystone_tpu_torch.observe import metrics

    device = resolve_device(data_sharding(mesh) if mesh is not None else device)
    if train_source is None:
        train_source = synthetic_source(conf, "train") if conf.synthetic else tar_source(conf, "train")
    if test_source is None:
        test_source = synthetic_source(conf, "test") if conf.synthetic else tar_source(conf, "test")
    num_classes = conf.synthetic_classes if conf.synthetic else conf.num_classes
    t0 = time.perf_counter()
    sift, lcs, sift_fn, lcs_fn = _extractors(conf)
    sift_branch, lcs_branch = _branches(conf, device)

    # pass 1: bounded descriptor-column reservoirs, sized for the larger
    # of the PCA and GMM sample budgets
    res_cap = max(conf.num_pca_samples, conf.num_gmm_samples)
    res_sift = ColumnReservoir(res_cap, conf.seed)
    res_lcs = ColumnReservoir(res_cap, conf.seed + 1)
    planned = plan_mod.enabled()
    if planned:
        # both descriptor branches ride one pixel-scaling prefix a chunk:
        # the corpus is scaled once instead of once per branch
        sift_tail = GrayScaler() >> sift
        for imgs, _ in train_source():
            sift_desc, lcs_desc = plan_mod.apply_shared(
                PixelScaler(), (sift_tail, lcs), np.asarray(imgs),
                chunk_size=conf.chunk_size, device=device, mesh=mesh,
            )
            res_sift.add(_descriptor_cols(sift_desc))
            res_lcs.add(_descriptor_cols(lcs_desc))
        # one corpus pass over pixel scaling saved, however many batches
        # the stream took
        metrics.get_registry().counter("plan_featurize_passes_saved").inc()
    else:
        for imgs, _ in train_source():
            res_sift.add(_descriptor_cols(apply_in_chunks(sift_fn, imgs, conf.chunk_size, device)))
            res_lcs.add(_descriptor_cols(apply_in_chunks(lcs_fn, imgs, conf.chunk_size, device)))
    t_pass1, pass1_s = _clock(device, t0)
    sift_branch.fit_from_samples(res_sift.sample())
    lcs_branch.fit_from_samples(res_lcs.sample())
    t_sample, branch_s = _clock(device, t_pass1)

    # pass 2: the stream → (N, D) Fisher features + labels, one chunk
    # shape for every chunk of the train and test streams
    def featurize_chunk(b):
        return ZipVectors()([_branch_apply(sift_branch, sift_fn(b)), _branch_apply(lcs_branch, lcs_fn(b))])

    def features_labels_of(source):
        label_parts: list[np.ndarray] = []

        def image_batches():
            for imgs, labels in source():
                label_parts.append(np.asarray(labels, np.int32))
                yield imgs

        feats = featurize_stream(
            prefetch_batches(image_batches(), depth=2), featurize_chunk,
            chunk_size=conf.chunk_size, device=device, mesh=mesh,
        )
        labels = np.concatenate(label_parts) if label_parts else np.zeros(0, np.int32)
        return feats, labels

    f_train_np, y_train = assemble_global(*features_labels_of(train_source))
    n_train = len(y_train)
    f_train = shard_batch(f_train_np, mesh, device=device)
    t_feat, featurize_s = _clock(device, t_sample)

    y_pad = np.zeros(f_train.shape[0], np.int32)
    y_pad[:n_train] = y_train
    indicators = ClassLabelIndicators(num_classes=num_classes)(y_pad).to(f_train.device)
    est = _estimator(conf, num_classes)
    fit_decisions: list[dict] = []
    if planned and not conf.checkpoint_dir:
        # the weighted fit streams chunks through the per-class
        # statistics; the planner prices the (C, D, D) state against the
        # card's budget and falls back to the materialized fit, with a
        # recorded decision, when it does not fit
        fitted, fit_plan = plan_mod.fit_streaming(
            ChainedLabelEstimator(prefix=Identity(), est=est),
            f_train, indicators, n_valid=n_train, device=f_train.device, return_plan=True,
        )
        model = fitted
        fit_decisions = [
            d for d in fit_plan.decisions
            if d["action"] in ("fit_fallback", "fit_operator", "fuse_fit")
        ]
    else:
        model = checkpointed_fit(
            est, f_train, indicators, checkpoint_dir=conf.checkpoint_dir,
            every=conf.checkpoint_every, n_valid=n_train,
        )
    t_fit, fit_s = _clock(device, t_feat)

    train_top1, train_top5, _ = _top_errors(model, f_train, y_train, num_classes)
    f_test_np, y_test = assemble_global(*features_labels_of(test_source))
    test_top1, test_top5, test_topk = _top_errors(
        model, shard_batch(f_test_np, mesh, device=device), y_test, num_classes)
    t_end, test_s = _clock(device, t_fit)

    result = {
        "train_top1_error": train_top1,
        "train_top5_error": train_top5,
        "test_top1_error": test_top1,
        "test_top5_error": test_top5,
        "n_train": n_train,
        "n_test": len(y_test),
        "num_features": int(f_train.shape[1]),
        "sample_pass_s": t_sample - t0,
        "pass1_s": pass1_s,
        "branch_fit_s": branch_s,
        "featurize_s": featurize_s,
        "fit_s": fit_s,
        "test_s": test_s,
        "total_s": t_end - t0,
        "samples_per_s": n_train / (t_fit - t0),
        "fit_decisions": fit_decisions,
        "test_predictions": test_topk,
        "device": str(device),
    }
    logger.info(
        "ImageNetSiftLcsFV[streaming]: train top1/top5 err %.4f/%.4f, "
        "test top1/top5 err %.4f/%.4f (%d train imgs)",
        train_top1, train_top5, test_top1, test_top5, n_train,
    )
    return result


def run(conf: ImageNetConfig, device=None, mesh=None) -> dict:
    """Fit and evaluate on ``device`` (the card unless the caller asks for
    the CPU; with a ``mesh``, its data device), every descriptor resident
    on the device as in the reference's design."""
    device = resolve_device(data_sharding(mesh) if mesh is not None else device)
    t0 = time.perf_counter()
    train, num_classes = _load(conf, "train")
    test, _ = _load(conf, "test")
    n_train, n_test = len(train), len(test)
    t_load = time.perf_counter()

    _, _, sift_fn, lcs_fn = _extractors(conf)
    sift_branch, lcs_branch = _branches(conf, device)

    x = shard_batch(train.images, mesh, device=device) if mesh is not None else train.images
    sift_desc = apply_in_chunks(sift_fn, x, conf.chunk_size, device)
    t_sift, sift_s = _clock(device, t_load)
    lcs_desc = apply_in_chunks(lcs_fn, x, conf.chunk_size, device)
    t_lcs, lcs_s = _clock(device, t_sift)
    proj_sift = sift_branch.fit(sift_desc, conf.chunk_size, n_valid=n_train)
    del sift_desc
    proj_lcs = lcs_branch.fit(lcs_desc, conf.chunk_size, n_valid=n_train)
    del lcs_desc
    t_branch, _ = _clock(device, t_lcs)
    f_train = ZipVectors()([
        sift_branch.featurize_projected(proj_sift, conf.chunk_size),
        lcs_branch.featurize_projected(proj_lcs, conf.chunk_size),
    ])
    del proj_sift, proj_lcs
    t_feat, fisher_s = _clock(device, t_branch)

    y = np.zeros(f_train.shape[0], np.int32)
    y[:n_train] = train.labels
    indicators = ClassLabelIndicators(num_classes=num_classes)(y).to(device)
    model = checkpointed_fit(
        _estimator(conf, num_classes), f_train, indicators, checkpoint_dir=conf.checkpoint_dir,
        every=conf.checkpoint_every, n_valid=n_train,
    )
    t_fit, fit_s = _clock(device, t_feat)

    train_top1, train_top5, _ = _top_errors(model, f_train, train.labels, num_classes)
    xt = shard_batch(test.images, mesh, device=device) if mesh is not None else test.images
    f_test = ZipVectors()([
        sift_branch.featurize(apply_in_chunks(sift_fn, xt, conf.chunk_size, device), conf.chunk_size),
        lcs_branch.featurize(apply_in_chunks(lcs_fn, xt, conf.chunk_size, device), conf.chunk_size),
    ])
    test_top1, test_top5, test_topk = _top_errors(model, f_test, test.labels, num_classes)
    t_end, test_s = _clock(device, t_fit)

    pca_s = sift_branch.times.get("pca_s", 0.0) + lcs_branch.times.get("pca_s", 0.0)
    gmm_s = sift_branch.times.get("gmm_s", 0.0) + lcs_branch.times.get("gmm_s", 0.0)
    result = {
        "train_top1_error": train_top1,
        "train_top5_error": train_top5,
        "test_top1_error": test_top1,
        "test_top5_error": test_top5,
        "n_train": n_train,
        "n_test": n_test,
        "num_features": int(f_train.shape[1]),
        "load_s": t_load - t0,
        "sift_s": sift_s,
        "lcs_s": lcs_s,
        "pca_s": pca_s,
        "gmm_s": gmm_s,
        "fisher_s": fisher_s,
        "featurize_s": t_feat - t0,
        "fit_s": fit_s,
        "test_s": test_s,
        "total_s": t_end - t0,
        "samples_per_s": n_train / (t_fit - t_load),
        "test_predictions": test_topk,
        "device": str(device),
    }
    logger.info(
        "ImageNetSiftLcsFV: train top1/top5 err %.4f/%.4f, test top1/top5 err %.4f/%.4f",
        train_top1, train_top5, test_top1, test_top5,
    )
    return result


def main(argv=None, device=None) -> dict:
    """CLI entry: the config flags plus ``--device`` (default: the card)."""
    import argparse

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None)
    known, rest = pre.parse_known_args(argv)
    conf = parse_config(ImageNetConfig, rest)
    if not conf.synthetic and not (conf.train_location and conf.label_map):
        raise SystemExit("need --train-location/--test-location/--label-map, or --synthetic N")
    device = device if device is not None else known.device
    if conf.streaming:
        return run_streaming(conf, device=device)
    return run(conf, device=device)


if __name__ == "__main__":
    main()
