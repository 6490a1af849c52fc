"""Evaluators."""

from keystone_tpu_torch.evaluation.binary import (
    BinaryClassificationMetrics,
    BinaryClassifierEvaluator,
)
from keystone_tpu_torch.evaluation.mean_ap import MeanAveragePrecisionEvaluator
from keystone_tpu_torch.evaluation.multiclass import (
    MulticlassClassifierEvaluator,
    MulticlassMetrics,
)
from keystone_tpu_torch.evaluation.perplexity import evaluate_perplexity

__all__ = [
    "BinaryClassificationMetrics",
    "BinaryClassifierEvaluator",
    "MeanAveragePrecisionEvaluator",
    "MulticlassClassifierEvaluator",
    "MulticlassMetrics",
    "evaluate_perplexity",
]
