"""Multinomial naive Bayes — port of ``keystone_tpu/ops/naive_bayes.py``
(the reference's ``NaiveBayesModel.scala``, trained as Spark MLlib's
``NaiveBayes.train``: λ smoothing, 1.0 by default).

The fit is two contractions over the (N, D) count batch on its device: the
class counts and the per-class feature sums, ``onehotᵀ @ data``.
"""

from __future__ import annotations

import dataclasses

import torch

from keystone_tpu_torch.core.pipeline import LabelEstimator, Transformer


@dataclasses.dataclass(eq=False)
class NaiveBayesModel(Transformer):
    """Dense log-posteriors ``x @ log_θᵀ + log_π``."""

    log_pi: torch.Tensor  # (C,)
    log_theta: torch.Tensor  # (C, D)

    def __call__(self, batch):
        return batch @ self.log_theta.T + self.log_pi


@dataclasses.dataclass(eq=False)
class NaiveBayesEstimator(LabelEstimator):
    """Fit multinomial NB with λ smoothing on (N, D) non-negative counts
    and (N,) int labels; ``n_valid`` masks trailing pad rows out."""

    num_classes: int = 2
    lam: float = 1.0

    def fit(self, data, labels, n_valid: int | None = None) -> NaiveBayesModel:
        data = torch.as_tensor(data)
        labels = torch.as_tensor(labels, device=data.device)
        log_pi, log_theta = _nb_fit(data, labels, n_valid, self.num_classes, self.lam)
        return NaiveBayesModel(log_pi=log_pi, log_theta=log_theta)


def _nb_fit(data, labels, n_valid, num_classes: int, lam: float):
    n = data.shape[0]
    rows = torch.arange(n, device=data.device)
    mask = torch.ones(n, dtype=data.dtype, device=data.device) if n_valid is None else (
        (rows < n_valid).to(data.dtype)
    )
    # a comparison, not F.one_hot: an out-of-range label gives a zero row
    # (as jax.nn.one_hot does) where F.one_hot would raise
    classes = torch.arange(num_classes, device=data.device)
    onehot = (labels[:, None] == classes).to(data.dtype) * mask[:, None]
    class_counts = onehot.sum(dim=0)  # (C,)
    feature_sums = onehot.T @ data  # (C, D)
    total = class_counts.sum()
    log_pi = torch.log(class_counts + lam) - torch.log(total + lam * num_classes)
    log_theta = torch.log(feature_sums + lam) - torch.log(
        feature_sums.sum(dim=1, keepdim=True) + lam * data.shape[1]
    )
    return log_pi, log_theta
