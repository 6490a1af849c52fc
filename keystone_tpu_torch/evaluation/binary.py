"""Binary evaluation — port of ``keystone_tpu/evaluation/binary.py`` (the
reference's ``BinaryClassifierEvaluator.scala``): a contingency table and
its derived metrics, mergeable across batches."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class BinaryClassificationMetrics:
    tp: float
    fp: float
    tn: float
    fn: float

    def merge(self, other: "BinaryClassificationMetrics"):
        return BinaryClassificationMetrics(
            tp=self.tp + other.tp,
            fp=self.fp + other.fp,
            tn=self.tn + other.tn,
            fn=self.fn + other.fn,
        )

    __add__ = merge

    @property
    def total(self) -> float:
        return self.tp + self.fp + self.tn + self.fn

    @property
    def accuracy(self) -> float:
        return (self.tp + self.tn) / max(self.total, 1.0)

    @property
    def error(self) -> float:
        return 1.0 - self.accuracy

    @property
    def precision(self) -> float:
        d = self.tp + self.fp
        return self.tp / d if d else 1.0

    @property
    def recall(self) -> float:
        d = self.tp + self.fn
        return self.tp / d if d else 1.0

    @property
    def specificity(self) -> float:
        d = self.tn + self.fp
        return self.tn / d if d else 1.0

    def f_score(self, beta: float = 1.0) -> float:
        p, r = self.precision, self.recall
        b2 = beta * beta
        d = b2 * p + r
        return (1 + b2) * p * r / d if d else 0.0

    @property
    def f1(self) -> float:
        return self.f_score(1.0)


class BinaryClassifierEvaluator:
    """Evaluate boolean predictions against boolean actuals. The four
    counts are taken on the predictions' device (a tensor, or numpy on
    the CPU), one host read for the table."""

    @staticmethod
    def evaluate(predicted, actual, n_valid: int | None = None):
        predicted = torch.as_tensor(predicted).to(torch.bool)
        actual = torch.as_tensor(actual).to(device=predicted.device, dtype=torch.bool)
        if n_valid is not None:
            predicted, actual = predicted[:n_valid], actual[:n_valid]
        counts = torch.stack([
            (predicted & actual).sum(),
            (predicted & ~actual).sum(),
            (~predicted & ~actual).sum(),
            (~predicted & actual).sum(),
        ]).tolist()
        tp, fp, tn, fn = (float(c) for c in counts)
        return BinaryClassificationMetrics(tp=tp, fp=fp, tn=tn, fn=fn)

    __call__ = evaluate
