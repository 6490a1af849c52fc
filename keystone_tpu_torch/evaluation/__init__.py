"""Evaluators."""

from keystone_tpu_torch.evaluation.multiclass import (
    MulticlassClassifierEvaluator,
    MulticlassMetrics,
)
from keystone_tpu_torch.evaluation.perplexity import evaluate_perplexity

__all__ = ["MulticlassClassifierEvaluator", "MulticlassMetrics", "evaluate_perplexity"]
