"""Image batches — port of the parts of ``keystone_tpu/utils/images.py``
the pixel workloads use.

A batch of images is one (N, H, W, C) float tensor (or numpy array on the
host); the reference's per-layout image classes have no counterpart.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# MATLAB rgb2gray weights: 0.2989 R + 0.5870 G + 0.1140 B
GRAY_WEIGHTS = (0.2989, 0.5870, 0.1140)


@dataclasses.dataclass
class LabeledImages:
    """(labels, images): ``images`` (N, H, W, C) float, ``labels`` (N,)
    ints or multi-labels."""

    labels: np.ndarray
    images: np.ndarray

    def __len__(self) -> int:
        return self.images.shape[0]


def rgb_to_gray(images) -> torch.Tensor:
    """(N, H, W, 3) → (N, H, W, 1) by :data:`GRAY_WEIGHTS`, in the images'
    dtype and on their device. The sum is the JAX package's
    ``tensordot`` as XLA computes it: the first product rounded, then two
    fused multiply-adds, each taken in float64 (where the product of two
    float32 values is exact) and rounded once, so the result equals the
    reference's bit for bit."""
    dt = images.dtype
    w = torch.tensor(GRAY_WEIGHTS, dtype=dt, device=images.device).to(torch.float64)
    x = images.to(torch.float64)
    acc = (x[..., 0] * w[0]).to(dt)
    for c in (1, 2):
        acc = (x[..., c] * w[c] + acc.to(torch.float64)).to(dt)
    return acc[..., None]
