"""VOC-style mean average precision — port of
``keystone_tpu/evaluation/mean_ap.py`` (the reference's
``MeanAveragePrecisionEvaluator.scala``).

11-point interpolated AP per class over score-ranked examples, in numpy
on the host: the (N, K) scores and indicators fit on one host. Tensors
are brought to the host first.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class MeanAveragePrecisionEvaluator:
    """AP per class from multi-label indicators and class scores."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def evaluate(self, actuals, scores, n_valid: int | None = None) -> np.ndarray:
        """actuals: (N, K) ±1 (or 0/1) indicators; scores: (N, K) floats.
        Returns per-class AP (K,); its mean is the MAP headline."""
        actuals = _host(actuals)
        scores = _host(scores)
        if n_valid is not None:
            actuals, scores = actuals[:n_valid], scores[:n_valid]
        pos = actuals > 0
        aps = np.zeros(self.num_classes)
        for k in range(self.num_classes):
            aps[k] = self._average_precision(pos[:, k], scores[:, k])
        return aps

    __call__ = evaluate

    @staticmethod
    def _average_precision(is_pos: np.ndarray, score: np.ndarray) -> float:
        order = np.argsort(-score, kind="stable")
        hits = is_pos[order]
        n_pos = int(hits.sum())
        if n_pos == 0:
            return 0.0
        tp = np.cumsum(hits)
        precision = tp / np.arange(1, len(hits) + 1)
        recall = tp / n_pos
        # 11-point interpolation: max precision at recall >= t, t = 0, .1, ..., 1
        ap = 0.0
        for t in np.linspace(0.0, 1.0, 11):
            mask = recall >= t
            ap += precision[mask].max() if mask.any() else 0.0
        return float(ap / 11.0)
