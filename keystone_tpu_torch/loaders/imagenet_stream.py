"""ImageNet-scale streaming batch sources and the calibrated synthetic
corpus — port of ``keystone_tpu/loaders/imagenet_stream.py``, the
ingestion side of ``models/imagenet_sift_lcs_fv``.

The tar source serves each process its disjoint shard of the corpus; the
synthetic source draws the same distribution lazily, a batch at a time
from per-batch numpy streams, so a large run never holds the corpus's
pixels; ``label_noise`` gives the corpus a top-1 error floor of exactly q.
"""

from __future__ import annotations

import numpy as np


def synthetic_centers(k: int) -> np.ndarray:
    """The (k, 8, 8, 3) class centers every synthetic path shares."""
    return np.random.default_rng(42).normal(loc=128, scale=30, size=(k, 8, 8, 3))


def render_classes(labels, k: int, q: float, rng) -> np.ndarray:
    """Class each synthetic image is RENDERED from: with probability
    ``q`` a uniformly random OTHER class, while the label stays, so the
    top-1 error floor is exactly ``q``."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(
            f"label_noise={q} must be in [0, 1] — it IS the top-1 error "
            "floor the calibrated eval asserts against"
        )
    render = labels.copy()
    if q and k > 1:
        flip = rng.random(len(labels)) < q
        other = (labels + rng.integers(1, k, size=len(labels))) % k
        render[flip] = other[flip]
    return render


def synthetic_source(conf, which: str):
    """The synthetic corpus as a re-streamable source: each call of the
    returned function yields fresh (images, labels) host batches of
    ``conf.stream_batch``, batch s drawn from ``default_rng((seed, s))``
    (seed 0 for train, 1 for test) in the JAX package's order. ``conf``
    is any object with the ImageNetConfig synthetic fields."""
    k = conf.synthetic_classes
    n = conf.synthetic if which == "train" else max(conf.synthetic // 4, 1)
    seed = 0 if which == "train" else 1
    centers = synthetic_centers(k)
    up = conf.image_size // 8

    def source():
        for s in range(0, n, conf.stream_batch):
            b = min(conf.stream_batch, n - s)
            rng = np.random.default_rng((seed, s))
            labels = rng.integers(0, k, size=b).astype(np.int32)
            render = render_classes(labels, k, conf.label_noise, rng)
            imgs = np.kron(centers[render], np.ones((1, up, up, 1)))
            imgs += rng.normal(scale=20, size=imgs.shape)
            yield np.clip(imgs, 0, 255).astype(np.float32), labels

    return source


def process_index_count() -> tuple[int, int]:
    """(rank, world size) of an initialized ``torch.distributed`` group,
    else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def tar_source(conf, which: str):
    """Re-streamable source over the tar corpus: each call returns a fresh
    iterator of (images, labels) host batches of this process's share of
    the tar files."""
    from keystone_tpu_torch.loaders.image_loaders import load_class_map, make_synset_label_of
    from keystone_tpu_torch.loaders.streaming import iter_tar_image_batches

    label_of = make_synset_label_of(load_class_map(conf.label_map))
    location = conf.train_location if which == "train" else conf.test_location
    index, count = process_index_count()

    def source():
        for _, imgs, labels in iter_tar_image_batches(
            location,
            batch_size=conf.stream_batch,
            target_size=conf.image_size,
            label_of=label_of,
            process_index=index,
            process_count=count,
        ):
            yield imgs, labels

    return source


def assemble_global(features: np.ndarray, labels: np.ndarray):
    """Every process's local (n_p, D) features and labels as the global
    training set, in rank order, on every process (each process streamed a
    disjoint tar shard). One process: passed through. A process whose
    shard was empty may hold (0, 0) features: the width is gathered too."""
    if process_index_count()[1] == 1:
        return features, labels
    import torch

    from keystone_tpu_torch.parallel import multihost

    feats = multihost.all_gather_rows(torch.as_tensor(np.asarray(features, np.float32)))
    labs = multihost.all_gather_rows(torch.as_tensor(np.asarray(labels, np.int32)))
    return feats.cpu().numpy(), labs.cpu().numpy()
