"""CSV loading: rows of comma-separated numbers → one matrix; optional
first-column labels. Port of ``keystone_tpu/loaders/csv_loader.py``: the
native mmap/OpenMP parser (:func:`keystone_tpu_torch.native.
native_load_csv`) when the host library can be had, else ``np.loadtxt``
(logged)."""

from __future__ import annotations

import glob
import os

import numpy as np

from keystone_tpu_torch.loaders.labeled import LabeledData


def _paths(path: str) -> list[str]:
    """A file, a directory of part files, or a glob — like sc.textFile."""
    if os.path.isdir(path):
        found = sorted(
            p
            for p in glob.glob(os.path.join(path, "*"))
            if os.path.isfile(p) and not os.path.basename(p).startswith(("_", "."))
        )
    else:
        found = sorted(glob.glob(path)) or [path]
    if not found or not all(os.path.exists(p) for p in found):
        raise FileNotFoundError(path)
    return found


def load_csv(path: str, dtype=np.float32) -> np.ndarray:
    """All rows from file/dir/glob ``path`` as an (N, d) array."""
    from keystone_tpu_torch.native import native_load_csv

    parts = []
    for p in _paths(path):
        mat = native_load_csv(p)
        if mat is None:
            mat = np.loadtxt(p, delimiter=",", dtype=np.float32, ndmin=2)
        parts.append(mat.astype(dtype, copy=False))
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)


def load_labeled_csv(
    path: str, label_offset: int = 0, dtype=np.float32
) -> LabeledData:
    """First column = integer label (minus ``label_offset``), rest = features.

    MNIST csvs in the reference workload are 1-indexed → ``label_offset=1``
    (the reference subtracts 1 inline, MnistRandomFFT.scala ``x(0).toInt - 1``).
    """
    mat = load_csv(path, dtype=dtype)
    labels = mat[:, 0].astype(np.int32) - label_offset
    return LabeledData(labels=labels, data=np.ascontiguousarray(mat[:, 1:]))
