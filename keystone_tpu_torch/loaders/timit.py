"""TIMIT pre-featurized data — the port's numpy-only copy of
``keystone_tpu/loaders/timit.py``: feature CSVs of 440-wide rows and
sparse label files of "row# label" lines (both 1-indexed).

DELIBERATE FIX of a reference bug, kept from the JAX package: the
original pipeline reads the *train* labels from ``testLabelsLocation``;
here train labels come from the train label file.
"""

from __future__ import annotations

import numpy as np

from keystone_tpu_torch.loaders.csv_loader import load_csv
from keystone_tpu_torch.loaders.labeled import LabeledData

TIMIT_DIMENSION = 440
NUM_CLASSES = 147


def _parse_sparse_labels(path: str, n_rows: int) -> np.ndarray:
    labels = np.full(n_rows, -1, np.int32)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                row = int(parts[0]) - 1
                if 0 <= row < n_rows:
                    labels[row] = int(parts[1]) - 1
    if (labels < 0).any():
        missing = int((labels < 0).sum())
        raise ValueError(f"{missing} rows have no label in {path}")
    return labels


def load_timit_split(data_path: str, labels_path: str) -> LabeledData:
    data = load_csv(data_path)
    labels = _parse_sparse_labels(labels_path, data.shape[0])
    return LabeledData(labels=labels, data=data)


def load_timit(
    train_data: str, train_labels: str, test_data: str, test_labels: str
) -> tuple[LabeledData, LabeledData]:
    return (
        load_timit_split(train_data, train_labels),
        load_timit_split(test_data, test_labels),
    )
