"""Sparse featurization, made dense — port of ``keystone_tpu/ops/sparse.py``
(the reference's ``CommonSparseFeatures``, ``AllSparseFeatures`` and
``SparseFeatureVectorizer``). Host code, copied.

The reference emits sparse vectors and caps the vocabulary (top-N
features); the vectorizer here writes a dense (N, num_features) float32
numpy array, which the entry point moves to the device.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np

from keystone_tpu_torch.core.pipeline import Estimator, Transformer


@dataclasses.dataclass(eq=False)
class SparseFeatureVectorizer(Transformer):
    """{feature: value} dicts (or (feature, value) pair lists) → dense
    (N, |feature_space|) array; unseen features dropped."""

    feature_space: dict = dataclasses.field(default_factory=dict)

    def __call__(self, batch):
        out = np.zeros((len(batch), len(self.feature_space)), np.float32)
        space = self.feature_space
        for i, doc in enumerate(batch):
            items = doc.items() if isinstance(doc, dict) else doc
            for feat, val in items:
                j = space.get(feat)
                if j is not None:
                    out[i, j] = val
        return out


class CommonSparseFeatures(Estimator):
    """Keep the top-``num_features`` features by occurrence count
    (reference CommonSparseFeatures: each (feature, value) pair counts one
    occurrence; ties broken deterministically by feature repr)."""

    def __init__(self, num_features: int):
        self.num_features = num_features

    def fit(self, data) -> SparseFeatureVectorizer:
        counts: Counter = Counter()
        for doc in data:
            items = doc.keys() if isinstance(doc, dict) else (f for f, _ in doc)
            counts.update(items)
        top = sorted(counts.items(), key=lambda kv: (-kv[1], repr(kv[0])))
        space = {f: i for i, (f, _) in enumerate(top[: self.num_features])}
        return SparseFeatureVectorizer(feature_space=space)


class AllSparseFeatures(Estimator):
    """Keep every observed feature (reference AllSparseFeatures)."""

    def fit(self, data) -> SparseFeatureVectorizer:
        space: dict = {}
        for doc in data:
            items = doc.keys() if isinstance(doc, dict) else (f for f, _ in doc)
            for feat in items:
                if feat not in space:
                    space[feat] = len(space)
        return SparseFeatureVectorizer(feature_space=space)
