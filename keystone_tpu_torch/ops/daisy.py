"""DAISY dense descriptors — port of ``keystone_tpu/ops/daisy.py`` (the
reference's ``DaisyExtractor.scala``, after Tola et al.).

- gradients by separable [1, 0, −1] / [1, 2, 1] convolutions;
- H rectified orientation maps ``max(0, cosθ·ix + sinθ·iy)``;
- Q cumulatively blurred layers with the reference's unnormalized
  gaussian kernels (:func:`_daisy_kernels`, a numpy build kept bit for
  bit);
- per keypoint: the center histogram from layer 0 and T ring histograms
  a layer at radius R(1+l)/Q, each L2-normalized (zeroed below 1e-8);
- layout: center block first, then ring histograms angle-major;
  keypoint-major output (N, num_keypoints, H·(T·Q+1)).

The convolutions are the port's separable ones (cuDNN on the card, full
f32), the rest elementwise work and ``index_select`` gathers.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from keystone_tpu_torch.core.pipeline import Transformer
from keystone_tpu_torch.utils.images import conv2d_separable

FEATURE_THRESHOLD = 1e-8
CONV_THRESHOLD = 1e-6


def _daisy_kernels(q: int, r: int) -> list[np.ndarray]:
    """The reference's per-layer gaussian kernels (unnormalized weights)."""
    sigma_sq = [(r * n / (2.0 * q)) ** 2 for n in range(q + 1)]
    diffs = [b - a for a, b in zip(sigma_sq, sigma_sq[1:])]
    kernels = []
    for delta in diffs:
        t = int(
            math.ceil(
                math.sqrt(
                    -2 * delta * math.log(CONV_THRESHOLD)
                    - delta * math.log(2 * math.pi * delta)
                )
            )
        )
        ns = np.arange(-t, t + 1, dtype=np.float64)
        k = np.exp(-(ns**2) / (2 * delta)) / math.sqrt(2 * math.pi * delta)
        kernels.append(k.astype(np.float32))
    return kernels


@dataclasses.dataclass(eq=False)
class DaisyExtractor(Transformer):
    """(N, H, W) or (N, H, W, 1) grayscale → (N, num_kp, H·(T·Q+1))."""

    daisy_t: int = 8
    daisy_q: int = 3
    daisy_r: int = 7
    daisy_h: int = 8
    pixel_border: int = 16
    stride: int = 4

    @property
    def feature_size(self) -> int:
        return self.daisy_h * (self.daisy_t * self.daisy_q + 1)

    def __call__(self, batch):
        if batch.ndim == 4:
            batch = batch[..., 0]
        return _daisy(batch, self.daisy_t, self.daisy_q, self.daisy_r, self.daisy_h,
                      self.pixel_border, self.stride)


def _blur(m, kernel):
    return conv2d_separable(m[..., None], kernel, kernel)[..., 0]


def _daisy(img, t: int, q: int, r: int, h_bins: int, border: int, stride: int):
    n, height, width = img.shape
    dev = img.device
    x4 = img[..., None]
    f1 = np.asarray([1.0, 0.0, -1.0], np.float32)
    f2 = np.asarray([1.0, 2.0, 1.0], np.float32)
    # the reference: ix = conv2D(in, filter1, filter2); iy = conv2D(in, f2, f1)
    ix = conv2d_separable(x4, f1, f2)[..., 0]
    iy = conv2d_separable(x4, f2, f1)[..., 0]

    kernels = _daisy_kernels(q, r)
    # orientation maps → the blurred layer stack
    maps0 = []
    for a in range(h_bins):
        theta = 2 * math.pi * a / h_bins
        maps0.append(torch.clamp_min(math.cos(theta) * ix + math.sin(theta) * iy, 0.0))
    prev = [_blur(m, kernels[0]) for m in maps0]
    layers = [prev]
    for layer in range(1, q):
        prev = [_blur(m, kernels[layer]) for m in prev]
        layers.append(prev)
    stack = torch.stack([torch.stack(layer, dim=-1) for layer in layers])  # (Q, N, H, W, H_bins)

    kp_rows = np.arange(border, height - border, stride)
    kp_cols = np.arange(border, width - border, stride)

    def at(plane, rows, cols):
        rows = torch.as_tensor(rows, device=dev)
        cols = torch.as_tensor(cols, device=dev)
        return plane.index_select(1, rows).index_select(2, cols)

    def normalize(hist):
        norm = torch.linalg.vector_norm(hist, dim=-1, keepdim=True)
        return torch.where(
            norm > FEATURE_THRESHOLD, hist / torch.clamp_min(norm, 1e-30), 0.0
        )

    # center histogram: layer 0 at the keypoint
    feats = [normalize(at(stack[0], kp_rows, kp_cols))]  # (N, kr, kc, H_bins)
    # ring histograms, angle-major: ring angle 2π(a−1)/T, offsets
    # (round(rad·sinθ), round(rad·cosθ)) clamped into the image
    for a in range(t):
        theta = 2 * math.pi * (a - 1) / t
        for layer in range(q):
            rad = r * (1.0 + layer) / q
            dr = int(round(rad * math.sin(theta)))
            dc = int(round(rad * math.cos(theta)))
            rows = np.clip(kp_rows + dr, 0, height - 1)
            cols = np.clip(kp_cols + dc, 0, width - 1)
            feats.append(normalize(at(stack[layer], rows, cols)))
    out = torch.cat(feats, dim=-1)  # (N, kr, kc, H·(T·Q+1))
    return out.reshape(n, len(kp_rows) * len(kp_cols), -1)
