"""Numeric test and metric helpers — the port's own copy of
``keystone_tpu/utils/stats.py`` (the reference's ``utils/Stats.scala``),
numpy on the host."""

from __future__ import annotations

import numpy as np


def about_eq(a, b, tol: float = 1e-8) -> bool:
    """Approximate equality for scalars and arrays (Stats.aboutEq)."""
    return bool(np.all(np.abs(np.asarray(a) - np.asarray(b)) <= tol))


def classification_error(predicted_topk, actual, k: int | None = None) -> float:
    """Top-k error: the fraction of rows whose actual label is NOT in the
    first k predicted columns (Stats.classificationError).

    ``predicted_topk``: (N, K) ranked predictions (TopKClassifier output)
    or (N,) argmax predictions.
    """
    predicted_topk = np.asarray(predicted_topk)
    actual = np.asarray(actual)
    if predicted_topk.ndim == 1:
        predicted_topk = predicted_topk[:, None]
    if k is not None:
        predicted_topk = predicted_topk[:, :k]
    hits = (predicted_topk == actual[:, None]).any(axis=1)
    return float(1.0 - hits.mean())


def get_err_percent(predicted_topk, actual, k: int | None = None) -> float:
    return 100.0 * classification_error(predicted_topk, actual, k)
