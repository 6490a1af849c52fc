"""Utility nodes — port of ``keystone_tpu/ops/util.py``: label
indicators, the argmax and top-k classifiers, casts, matrix flattening
and the feature splitter and concatenation."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from keystone_tpu_torch.core.pipeline import FunctionNode, Transformer


@dataclasses.dataclass(eq=False)
class ClassLabelIndicators(Transformer):
    """Int label(s) → ±1 indicator vectors.

    Accepts an (N,) int batch (one label per item), an (N, k) batch of
    multi-labels padded with negative entries, or a ragged list of label
    lists; output is (N, num_classes) f32 with +1 at label positions and
    −1 elsewhere, on the input tensor's device (the CPU for numpy and
    lists).
    """

    num_classes: int = 2

    def __call__(self, batch):
        if isinstance(batch, (list, tuple)):  # ragged multi-label
            out = -np.ones((len(batch), self.num_classes), np.float32)
            for i, labels in enumerate(batch):
                out[i, np.asarray(labels, np.int64)] = 1.0
            return torch.from_numpy(out)
        batch = torch.as_tensor(batch).to(torch.int64)
        n = batch.shape[0]
        onehot = torch.zeros(
            (n, self.num_classes), dtype=torch.float32, device=batch.device
        )
        if batch.ndim == 1:
            onehot[torch.arange(n, device=batch.device), batch] = 1.0
        else:  # (N, k) padded multi-label, negative entries = padding
            valid = (batch >= 0).to(torch.float32)
            clipped = batch.clamp(0, self.num_classes - 1)
            onehot.scatter_reduce_(1, clipped, valid, reduce="amax")
        return 2.0 * onehot - 1.0


@dataclasses.dataclass(eq=False)
class MaxClassifier(Transformer):
    """Argmax over the feature axis (first index wins a tie)."""

    def __call__(self, batch):
        return torch.argmax(batch, dim=-1)


@dataclasses.dataclass(eq=False)
class TopKClassifier(Transformer):
    """Top-k indices, highest score first."""

    k: int = 5

    def __call__(self, batch):
        return torch.topk(batch, self.k, dim=-1).indices


@dataclasses.dataclass(eq=False)
class Cast(Transformer):
    """Dtype conversion by name (``"float32"``, ``"bfloat16"``, ...)."""

    dtype: str = "float32"

    def __call__(self, batch):
        return torch.as_tensor(batch).to(getattr(torch, self.dtype))


def FloatToDouble() -> Cast:
    """Reference-parity alias: the solvers work in float32, so this casts
    to float32, as the reference's does."""
    return Cast(dtype="float32")


@dataclasses.dataclass(eq=False)
class MatrixVectorizer(Transformer):
    """Flatten per-item matrices (N, a, b) to (N, a·b), column-major like
    the reference's ``toDenseVector``."""

    def __call__(self, batch):
        return batch.transpose(1, 2).reshape(batch.shape[0], -1)


@dataclasses.dataclass(eq=False)
class VectorSplitter(FunctionNode):
    """Split (N, D) features into column blocks of ``block_size`` (the
    last may be narrower) — the block solvers' feature blocking."""

    block_size: int = 4096
    num_features: int | None = None

    def __call__(self, data) -> list:
        d = self.num_features or data.shape[-1]
        return [
            data[..., start : min(start + self.block_size, d)]
            for start in range(0, d, self.block_size)
        ]


@dataclasses.dataclass(eq=False)
class ZipVectors(FunctionNode):
    """Concatenate a list of (N, d_i) feature families along the feature
    axis."""

    def __call__(self, datasets) -> torch.Tensor:
        return torch.cat(list(datasets), dim=-1)
