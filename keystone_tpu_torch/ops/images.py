"""Image nodes — port of the pixel nodes of ``keystone_tpu/ops/images.py``.

Every node takes an (N, H, W, C) float batch. Patches flatten as
(dy, dx, c), channel fastest: the reference's patch index
``c + x·C + y·C·k``.
"""

from __future__ import annotations

import dataclasses

import torch

from keystone_tpu_torch.core.pipeline import Transformer
from keystone_tpu_torch.utils.images import rgb_to_gray


@dataclasses.dataclass(eq=False)
class GrayScaler(Transformer):
    """MATLAB rgb2gray weights: (N, H, W, 3) → (N, H, W, 1)."""

    def __call__(self, batch):
        return rgb_to_gray(batch)


@dataclasses.dataclass(eq=False)
class PixelScaler(Transformer):
    """Byte pixels to [0, 1]."""

    def __call__(self, batch):
        return batch / 255.0


@dataclasses.dataclass(eq=False)
class ImageVectorizer(Transformer):
    """(N, H, W, C) → (N, H·W·C), channel fastest."""

    def __call__(self, batch):
        return batch.reshape(batch.shape[0], -1)


def extract_patches(batch, patch_size: int, stride: int = 1) -> torch.Tensor:
    """Every ``patch_size``² window at ``stride``: (N, oh, ow, k²·C) with
    (dy, dx, c) flattening, channel fastest. Strided slices and one
    concatenation: data movement only, exact."""
    n, h, w, c = batch.shape
    k = patch_size
    oh = (h - k) // stride + 1
    ow = (w - k) // stride + 1
    slabs = [
        batch[:, dy : dy + (oh - 1) * stride + 1 : stride,
              dx : dx + (ow - 1) * stride + 1 : stride, :]
        for dy in range(k)
        for dx in range(k)
    ]  # k² slabs of (N, oh, ow, C), in (dy, dx) order
    return torch.cat(slabs, dim=-1).reshape(n, oh, ow, k * k * c)


@dataclasses.dataclass(eq=False)
class LabelExtractor(Transformer):
    """The labels of a :class:`~keystone_tpu_torch.utils.images.LabeledImages`."""

    def __call__(self, batch):
        return batch.labels


@dataclasses.dataclass(eq=False)
class ImageExtractor(Transformer):
    """The images of a :class:`~keystone_tpu_torch.utils.images.LabeledImages`."""

    def __call__(self, batch):
        return batch.images


# the multi-label variants are the same projections
MultiLabelExtractor = LabelExtractor
MultiLabeledImageExtractor = ImageExtractor
