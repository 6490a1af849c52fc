"""CIFAR-10 binary loader — port of ``keystone_tpu/loaders/cifar.py``.

A record is 1 label byte and 3,072 pixel bytes: the 1,024-byte R, G and B
planes, each row-major. The records are parsed into an (N, 32, 32, 3)
float batch with values 0-255 by the native reader
(:func:`keystone_tpu_torch.native.native_load_cifar`), or, when the host
library cannot be had (logged), in one vectorized numpy pass.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from keystone_tpu_torch.utils.images import LabeledImages

NROW, NCOL, NCHAN = 32, 32, 3
RECORD = 1 + NROW * NCOL * NCHAN


def _read_numpy(f: str) -> tuple[np.ndarray, np.ndarray]:
    raw = np.fromfile(f, dtype=np.uint8)
    if raw.size % RECORD:
        raise ValueError(
            f"{f}: size {raw.size} is not a multiple of the "
            f"{RECORD}-byte CIFAR-10 record"
        )
    recs = raw.reshape(-1, RECORD)
    planes = recs[:, 1:].reshape(-1, NCHAN, NROW, NCOL)  # (N, C, H, W)
    return recs[:, 0].astype(np.int32), np.transpose(planes, (0, 2, 3, 1)).astype(np.float32)


def load_cifar(path: str, dtype=np.float32) -> LabeledImages:
    """Every record of a CIFAR-10 binary file, of the ``*.bin`` files of a
    directory, or of the files a glob matches, in sorted order."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.bin")))
    else:
        files = sorted(glob.glob(path)) or [path]
    from keystone_tpu_torch.native import native_load_cifar

    all_labels, all_images = [], []
    for f in files:
        native = native_load_cifar(f)
        if native is not None:
            labels, images = native
        else:
            labels, images = _read_numpy(f)
        all_labels.append(labels)
        all_images.append(images.astype(dtype, copy=False))
    return LabeledImages(labels=np.concatenate(all_labels), images=np.concatenate(all_images))
