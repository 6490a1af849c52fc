"""Tar/JPEG image ingestion — port of ``keystone_tpu/loaders/
image_loaders.py`` (the reference's ImageLoaderUtils.scala, VOCLoader.scala
and ImageNetLoader.scala).

Tars are streamed on the host with Python's tarfile and PIL (imported
where an image is decoded), decoded in parallel by threads (PIL's JPEG
decode releases the GIL). Every image is resized to ``target_size`` at
load, so a batch is one (N, S, S, 3) array.
"""

from __future__ import annotations

import concurrent.futures
import glob
import io
import os
import tarfile

import numpy as np

from keystone_tpu_torch.utils.images import LabeledImages

VOC_NUM_CLASSES = 20


def decode_image(data: bytes, target_size: int | None) -> np.ndarray:
    """JPEG/PNG bytes → (H, W, 3) float32 0-255 (grayscale triplicated to 3
    channels like the reference, ImageConversions.scala)."""
    from PIL import Image as PILImage

    img = PILImage.open(io.BytesIO(data))
    if img.mode != "RGB":
        img = img.convert("RGB")
    if target_size is not None:
        img = img.resize((target_size, target_size), PILImage.BILINEAR)
    return np.asarray(img, np.float32)


def _iter_tar_images(tar_path: str, *, strict: bool = False):
    """Yield ``(name, bytes)`` image entries of one tar, resiliently.

    Transient open errors retry under ``IO_POLICY`` (and the
    ``tar.read`` fault site injects them); an archive that stays
    unreadable is SKIPPED with one warning + an
    ``ingest_archives_skipped`` counter — one corrupt shard must not
    abort a multi-tar ingest (the reference got this from Spark task
    re-execution; tf.data treats ingest skip/retry the same way). A
    read error mid-archive (truncated tar) yields the readable prefix
    and skips the rest, counted separately. ``strict=True`` restores
    raise-on-error for callers that want the abort."""
    from keystone_tpu_torch.resilience import faults, retry

    def _open():
        faults.maybe_raise("tar.read", note=tar_path)
        return tarfile.open(tar_path)

    try:
        tf = retry.IO_POLICY.call(_open, label="tar.open")
    except (retry.RetryExhausted, OSError, tarfile.ReadError) as e:
        if strict:
            raise
        _count_archive_failure(tar_path, e, "unreadable")
        return
    with tf:
        try:
            for member in tf:
                if not member.isfile():
                    continue
                name = os.path.basename(member.name)
                if not name.lower().endswith((".jpg", ".jpeg", ".png")):
                    continue
                data = tf.extractfile(member).read()
                yield member.name, data
        except (OSError, EOFError, tarfile.ReadError) as e:
            if strict:
                raise
            _count_archive_failure(tar_path, e, "truncated")


def _count_archive_failure(tar_path: str, e: BaseException, reason: str) -> None:
    """One warning + counter + resilience event per skipped archive."""
    from keystone_tpu_torch.resilience.emit import decision

    _logger().warning("skipping %s tar %s: %s", reason, tar_path, e)
    decision(
        "archive_skipped",
        counter="ingest_archives_skipped",
        counter_labels={"reason": reason},
        path=tar_path,
        reason=reason,
        error=repr(e),
    )


def load_tar_images(
    paths: list[str],
    target_size: int | None = 256,
    workers: int = 8,
    decode_batch: int = 512,
    name_prefix: str | None = None,
) -> tuple[list[str], np.ndarray]:
    """All images from the given tar files → (names, (N, S, S, 3) array).

    ``name_prefix`` drops entries outside a path prefix *before* decode
    (the reference's ``VOCDataPath.namePrefix`` filter). Decoding streams
    in ``decode_batch``-sized groups so raw compressed bytes are dropped as
    soon as each group is decoded (peak host memory is pixels + one group
    of bytes, not the whole corpus's bytes).

    This eager entry point is STRICT about archives: transient open
    errors still retry, but a corrupt/unreadable tar raises rather than
    silently shrinking the materialized dataset (a small eager load is
    usually one archive — an empty result would fail confusingly far
    downstream). The skip-and-continue contract belongs to
    :func:`_iter_tar_images`' default, non-strict mode.
    """

    def try_decode(nd):
        # undecodable entries are skipped with a warning, like the
        # reference's ImageUtils.loadImage failure filter
        try:
            return decode_image(nd[1], target_size)
        except Exception as e:  # noqa: BLE001 — PIL raises various types
            _logger().warning("failed to decode %s: %s", nd[0], e)
            _count_decode_failure("image_loaders")
            return None

    names: list[str] = []
    imgs: list[np.ndarray] = []
    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        batch: list[tuple[str, bytes]] = []

        def flush():
            nonlocal batch
            decoded = list(ex.map(try_decode, batch))
            for (n, _), img in zip(batch, decoded):
                if img is not None:
                    names.append(n)
                    imgs.append(img)
            batch = []

        for p in paths:
            for item in _iter_tar_images(p, strict=True):
                if name_prefix is not None and not item[0].startswith(
                    name_prefix
                ):
                    continue
                batch.append(item)
                if len(batch) >= decode_batch:
                    flush()
        if batch:
            flush()
    return names, np.stack(imgs) if imgs else np.zeros((0, 0, 0, 3), np.float32)


def _count_decode_failure(loader: str) -> None:
    from keystone_tpu_torch.observe import metrics

    metrics.get_registry().counter(
        "ingest_decode_failures", loader=loader
    ).inc()


def _logger():
    from keystone_tpu_torch.core.logging import get_logger

    return get_logger("keystone_tpu_torch.loaders.image_loaders")


def _expand(path: str, suffix: str) -> list[str]:
    if os.path.isdir(path):
        return sorted(glob.glob(os.path.join(path, f"*{suffix}")))
    return sorted(glob.glob(path)) or [path]


def load_voc(
    tar_path: str,
    label_csv_path: str,
    *,
    target_size: int | None = 256,
    name_prefix: str | None = None,
) -> LabeledImages:
    """VOC2007 tar(s) + multi-label CSV → images with per-image label lists
    (reference VOCLoader.scala:41-63).

    Two CSV layouts are accepted: the VOC2007 annotation export the
    reference parses — header row then
    ``id,class,classname,traintesteval,filename`` with 1-indexed class and
    quoted paths (columns 1 and 4, VOCLoader.scala:50-53) — and the
    simplified ``filename,label_index`` (also 1-indexed). ``name_prefix``
    keeps only tar entries under a path prefix (the reference's
    ``VOCDataPath.namePrefix``, e.g. "VOCdevkit/VOC2007/JPEGImages/").

    ``labels`` is an (N, k) int array padded with −1 (ragged multi-labels),
    feeding ClassLabelIndicators' padded path.
    """
    label_map: dict[str, list[int]] = {}
    with open(label_csv_path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    reference_format = bool(lines) and lines[0].replace('"', "").lower().startswith("id,")
    for line in lines[1 if reference_format else 0 :]:
        if line.startswith("#"):
            continue
        parts = [p.strip().strip('"') for p in line.split(",")]
        if reference_format:
            fname, label = os.path.basename(parts[4]), int(parts[1]) - 1
        else:
            fname, label = parts[0], int(parts[1]) - 1
        label_map.setdefault(fname, []).append(label)

    names, images = load_tar_images(
        _expand(tar_path, ".tar"), target_size, name_prefix=name_prefix
    )
    labels_ragged = [
        sorted(set(label_map.get(os.path.basename(n), []))) for n in names
    ]
    k = max((len(l) for l in labels_ragged), default=1)
    labels = -np.ones((len(names), max(k, 1)), np.int32)
    for i, ls in enumerate(labels_ragged):
        labels[i, : len(ls)] = ls
    return LabeledImages(labels=labels, images=images)


def load_class_map(class_map_path: str) -> dict[str, int]:
    """Parse a "synset class_index" map file (the reference's
    ImageNetLoader)."""
    class_map: dict[str, int] = {}
    with open(class_map_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                class_map[parts[0]] = int(parts[1])
    return class_map


def make_synset_label_of(class_map: dict[str, int]):
    """name → class index: the synset prefix of the basename, else the
    parent directory's name; −1 when unmapped."""

    def label_of(name: str) -> int:
        base = os.path.basename(name)
        synset = base.split("_")[0]
        if synset in class_map:
            return class_map[synset]
        parent = os.path.basename(os.path.dirname(name))
        return class_map.get(parent, -1)

    return label_of


def load_imagenet(
    tar_path: str, class_map_path: str, *, target_size: int | None = 256
) -> LabeledImages:
    """ImageNet tar(s) + "synset class_index" map file → labeled images
    (the reference's ImageNetLoader: the label from the entry name's
    synset through the map). Images with no map entry are dropped with a
    warning: a −1 label would wrap to the last class in the indicators."""
    label_of = make_synset_label_of(load_class_map(class_map_path))
    names, images = load_tar_images(_expand(tar_path, ".tar"), target_size)
    labels = np.asarray([label_of(n) for n in names], np.int32)
    unmapped = labels < 0
    if unmapped.any():
        _logger().warning("dropping %d images with no class-map entry", int(unmapped.sum()))
        labels, images = labels[~unmapped], images[~unmapped]
    return LabeledImages(labels=labels, images=images)
