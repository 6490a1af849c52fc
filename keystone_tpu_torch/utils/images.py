"""Image batches and image math — port of ``keystone_tpu/utils/images.py``.

A batch of images is one (N, H, W, C) float tensor (or numpy array on the
host); the reference's per-layout image classes have no counterpart.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

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


def conv2d_separable(images, kernel_x, kernel_y) -> torch.Tensor:
    """Separable 2-D convolution, zero-padded to the same size, per
    channel: ``kernel_x`` (kx,) along W, then ``kernel_y`` (ky,) along H,
    on (N, H, W, C) images. Each pass is one cuDNN cross-correlation with
    the reversed kernel (a true convolution), padded ``(k-1)//2`` before
    and ``k//2`` after, so an even kernel keeps the size too. Full f32
    whatever precision flags the process holds: both passes run in the
    full-f32 scope (TF32 off on cuDNN, IEEE on oneDNN)."""
    from keystone_tpu_torch.ops.linear import _matmul_precision

    kx = torch.as_tensor(kernel_x, dtype=images.dtype, device=images.device).flip(0)
    ky = torch.as_tensor(kernel_y, dtype=images.dtype, device=images.device).flip(0)
    n, h, w, c = images.shape
    x = images.permute(0, 3, 1, 2).reshape(n * c, 1, h, w)
    with _matmul_precision("highest"):
        x = F.conv2d(F.pad(x, _pad(kx)), kx.reshape(1, 1, 1, -1))  # along W
        x = F.conv2d(F.pad(x, (0, 0) + _pad(ky)), ky.reshape(1, 1, -1, 1))  # along H
    return x.reshape(n, c, h, w).permute(0, 2, 3, 1)


def _pad(k) -> tuple[int, int]:
    return ((k.shape[0] - 1) // 2, k.shape[0] // 2)
