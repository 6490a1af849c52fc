"""ViT-ridge — port of ``keystone_tpu/models/vit_ridge.py``: a frozen
random ViT featurizer (:class:`~keystone_tpu_torch.ops.vit.ViTFeaturizer`)
and an exact ridge solve on its pooled features, CIFAR-shaped by default.

The images are featurized in chunks of ``--chunk-size`` rows
(:func:`apply_in_chunks`, the last chunk zero-padded), each chunk staged
to the device ahead of use; on the card every block's attention is kernel
K2 in f32. Run on the card: ``python -m keystone_tpu_torch.models.vit_ridge
--synthetic 50000``; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from keystone_tpu_torch.core.batching import apply_in_chunks, pad_labels
from keystone_tpu_torch.core.config import arg, parse_config
from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.core.runtime import resolve_device, synchronize
from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
from keystone_tpu_torch.models.cifar_linear_pixels import LinearPixelsConfig, _load
from keystone_tpu_torch.ops.linear import LinearMapEstimator
from keystone_tpu_torch.ops.util import ClassLabelIndicators, MaxClassifier
from keystone_tpu_torch.ops.vit import ViTFeaturizer
from keystone_tpu_torch.parallel.mesh import shard_batch

logger = get_logger("keystone_tpu_torch.models.vit_ridge")

NUM_CLASSES = 10


@dataclasses.dataclass
class ViTRidgeConfig:
    train_location: str = arg(default="", help="CIFAR-10 binary file/dir")
    test_location: str = arg(default="")
    patch_size: int = arg(default=8)
    dim: int = arg(default=128)
    depth: int = arg(default=4)
    num_heads: int = arg(default=4)
    lam: float = arg(default=1.0)
    chunk_size: int = arg(default=512)
    seed: int = arg(default=0)
    synthetic: int = arg(default=0, help="if > 0, N synthetic samples")


def make_featurizer(conf: ViTRidgeConfig, image_size: int, device) -> ViTFeaturizer:
    """The ViT drawn from a generator seeded with ``conf.seed``."""
    return ViTFeaturizer.create(
        image_size=image_size,
        patch_size=conf.patch_size,
        dim=conf.dim,
        depth=conf.depth,
        num_heads=conf.num_heads,
        generator=torch.Generator(device=device).manual_seed(conf.seed),
        device=device,
    )


def run(conf: ViTRidgeConfig, device=None, mesh=None) -> dict:
    """Featurize, fit and evaluate on ``device`` (default: the card). With
    a ``mesh`` the rows are padded to its data axis (:func:`shard_batch`);
    the featurizer itself holds no mesh, as in the JAX package."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    lp_conf = LinearPixelsConfig(
        train_location=conf.train_location,
        test_location=conf.test_location,
        synthetic=conf.synthetic,
    )
    train, test = _load(lp_conf, "train"), _load(lp_conf, "test")
    n_train, n_test = len(train), len(test)
    vit = make_featurizer(conf, train.images.shape[1], device)

    def feat_fn(b):
        return vit(b / 255.0)

    def featurize(images):
        x = shard_batch(images, mesh, device=device) if mesh is not None else images
        return apply_in_chunks(feat_fn, x, conf.chunk_size, device)

    f_train = featurize(train.images)
    synchronize(device)
    t_feat = time.perf_counter()

    y = pad_labels(train.labels, f_train.shape[0])
    indicators = ClassLabelIndicators(num_classes=NUM_CLASSES)(y).to(device)
    model = LinearMapEstimator(lam=conf.lam).fit(f_train, indicators, n_valid=n_train)
    synchronize(device)
    t_fit = time.perf_counter()

    classify = MaxClassifier()
    evaluator = MulticlassClassifierEvaluator(NUM_CLASSES)
    train_eval = evaluator(classify(model(f_train)), y, n_valid=n_train)
    f_test = featurize(test.images)
    y_test = pad_labels(test.labels, f_test.shape[0])
    test_eval = evaluator(classify(model(f_test)), y_test, n_valid=n_test)
    synchronize(device)

    result = {
        "train_error": train_eval.error,
        "test_error": test_eval.error,
        "n_train": n_train,
        "n_test": n_test,
        "featurize_s": t_feat - t0,
        "fit_s": t_fit - t_feat,
        "total_s": time.perf_counter() - t0,
        "featurize_fit_samples_per_s": n_train / (t_fit - t0),
    }
    logger.info(
        "ViTRidge: train err %.4f, test err %.4f, %.0f samples/s",
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
    conf = parse_config(ViTRidgeConfig, rest)
    if not conf.synthetic and not (conf.train_location and conf.test_location):
        raise SystemExit("need --train-location AND --test-location, or --synthetic N")
    return run(conf, device=device if device is not None else known.device)


if __name__ == "__main__":
    main()
