"""Multiclass evaluation — port of ``keystone_tpu/evaluation/multiclass.py``.

The confusion matrix is a one-hot scatter-add on the predictions' device;
the metrics and the report work on the host copy. Predictions given as a
:class:`~keystone_tpu_torch.parallel.multihost.GlobalRows` are a global
batch: each process counts its own rows and the counts are summed over
the process group, so every process reports the global error.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _confusion(predicted, actual, num_classes: int, n_valid=None) -> torch.Tensor:
    """(num_classes, num_classes) f32 counts, rows = actual, cols =
    predicted; rows past ``n_valid`` are not counted."""
    n = predicted.shape[0]
    valid = torch.ones((n,), dtype=torch.float32, device=predicted.device)
    if n_valid is not None:
        valid = (torch.arange(n, device=predicted.device) < n_valid).to(torch.float32)
    flat = actual * num_classes + predicted
    counts = torch.zeros(
        (num_classes * num_classes,), dtype=torch.float32, device=predicted.device
    ).index_add_(0, flat, valid)
    return counts.reshape(num_classes, num_classes)


@dataclasses.dataclass
class MulticlassMetrics:
    confusion: np.ndarray  # rows = actual class, cols = predicted class

    @property
    def num_classes(self) -> int:
        return self.confusion.shape[0]

    @property
    def total(self) -> float:
        return float(self.confusion.sum())

    @property
    def accuracy(self) -> float:
        return float(np.trace(self.confusion) / max(self.confusion.sum(), 1))

    @property
    def error(self) -> float:
        return 1.0 - self.accuracy

    def class_precision(self) -> np.ndarray:
        pred_totals = self.confusion.sum(axis=0)
        return np.divide(
            np.diag(self.confusion),
            pred_totals,
            out=np.zeros(self.num_classes),
            where=pred_totals > 0,
        )

    def class_recall(self) -> np.ndarray:
        actual_totals = self.confusion.sum(axis=1)
        return np.divide(
            np.diag(self.confusion),
            actual_totals,
            out=np.zeros(self.num_classes),
            where=actual_totals > 0,
        )

    def class_f1(self) -> np.ndarray:
        p, r = self.class_precision(), self.class_recall()
        denom = np.where(p + r > 0, p + r, 1.0)
        return np.where(p + r > 0, 2 * p * r / denom, 0.0)

    @property
    def macro_precision(self) -> float:
        return float(self.class_precision().mean())

    @property
    def macro_recall(self) -> float:
        return float(self.class_recall().mean())

    @property
    def macro_f1(self) -> float:
        return float(self.class_f1().mean())

    # Micro-averaged P/R/F all equal accuracy for single-label multiclass,
    # as in the reference's MulticlassMetrics.
    @property
    def micro_precision(self) -> float:
        return self.accuracy

    @property
    def micro_recall(self) -> float:
        return self.accuracy

    @property
    def micro_f1(self) -> float:
        return self.accuracy

    def summary(self, class_names: list[str] | None = None) -> str:
        names = class_names or [str(i) for i in range(self.num_classes)]
        lines = [
            "=" * 60,
            "Summary",
            "-" * 60,
            f"Correctly Classified Instances   : {int(np.trace(self.confusion))}"
            f"  ({100 * self.accuracy:.4f}%)",
            f"Incorrectly Classified Instances : "
            f"{int(self.total - np.trace(self.confusion))}"
            f"  ({100 * self.error:.4f}%)",
            f"Total Classified Instances       : {int(self.total)}",
            f"Macro Precision/Recall/F1        : {self.macro_precision:.4f} / "
            f"{self.macro_recall:.4f} / {self.macro_f1:.4f}",
            "-" * 60,
            "Confusion Matrix (rows=actual, cols=predicted)",
        ]
        width = max(6, max(len(n) for n in names) + 1)
        header = " " * width + "".join(f"{n:>{width}}" for n in names)
        lines.append(header)
        for i, row in enumerate(self.confusion.astype(int)):
            lines.append(
                f"{names[i]:>{width}}" + "".join(f"{v:>{width}}" for v in row)
            )
        lines.append("=" * 60)
        return "\n".join(lines)


class MulticlassClassifierEvaluator:
    """Evaluate predicted vs actual int labels → :class:`MulticlassMetrics`."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def evaluate(self, predicted, actual, n_valid: int | None = None):
        """``predicted`` may be a ``GlobalRows``: ``actual`` and ``n_valid``
        then index the global batch, as in the reference, and the
        confusion matrix is summed over the processes that hold its row
        blocks (each row once, whatever the mesh's model axis)."""
        from keystone_tpu_torch.parallel.multihost import GlobalRows, all_reduce_

        glob = isinstance(predicted, GlobalRows)
        if glob:
            lo, group = predicted.offset, predicted.group
            n_ok = predicted.n_global if n_valid is None else min(int(n_valid), predicted.n_global)
            predicted, n_valid = predicted.local, max(0, n_ok - lo)
            actual = actual[lo : lo + predicted.shape[0]]
        predicted = torch.as_tensor(predicted).to(torch.int64)
        actual = torch.as_tensor(actual).to(device=predicted.device, dtype=torch.int64)
        if glob and actual.shape[0] < predicted.shape[0]:
            # the global labels end before this block's pad rows
            actual = torch.cat([actual, actual.new_zeros(predicted.shape[0] - actual.shape[0])])
        conf = _confusion(predicted, actual, self.num_classes, n_valid)
        if glob:
            all_reduce_(conf, group=group)
        return MulticlassMetrics(confusion=conf.cpu().numpy().astype(np.float64))

    __call__ = evaluate
