"""Dense multi-scale SIFT with vl_dsift's flat-window semantics — port of
``keystone_tpu/ops/sift.py``.

The same algorithm, stage by stage, on the batch's device:

- scales: bin sizes ``bin + 2·s``; per scale the ORIGINAL image is
  gaussian-smoothed with ``sigma = bin_s / magnif`` (magnif 6), kernel
  radius ``ceil(4σ)``, edge padding;
- gradients by central differences, one-sided (not halved) at borders;
- soft angular binning of the magnitude into 8 orientation planes;
- bilinear spatial binning as a unit-integral triangular convolution of
  each plane (edge padding), point-sampled at bin corners ``frame +
  bin_index · bin_s``, with the flat-window per-bin weights ``w(i)·w(j)
  ·bin_s²``;
- keypoint grid: ``off = (1 + 2·num_scales) − 3·s`` clamped to 0, frames
  up to ``dim − 3·bin_s − 1``, step ``step + s·scale_step``;
- descriptors L2-normalized, clamped at 0.2, renormalized; descriptors
  whose pre-normalization norm < 0.005 zeroed;
- quantized ``min(trunc(512·v), 255)``.

Layout: descriptor entries ordered (row-bin, col-bin, orientation) with
orientation angle ``atan2(−gx, gy)``, keypoints column-outer / row-inner,
scales concatenated. The smoothing and the triangular binning are the
port's separable convolutions (cuDNN on the card, full f32); the rest is
elementwise work and two gathers.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from keystone_tpu_torch.core.pipeline import Transformer
from keystone_tpu_torch.utils.images import conv2d_separable

NUM_ORIENTATIONS = 8
NUM_SPATIAL_BINS = 4
DESC_DIM = NUM_ORIENTATIONS * NUM_SPATIAL_BINS * NUM_SPATIAL_BINS  # 128
CONTRAST_THRESHOLD = 0.005
WINDOW_SIZE = 1.5  # vl window size
MAGNIF = 6.0


def gaussian_kernel(sigma: float) -> np.ndarray:
    radius = max(int(math.ceil(4.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / max(sigma, 1e-8)) ** 2)
    return (k / k.sum()).astype(np.float32)


def triangular_kernel(bin_size: int) -> np.ndarray:
    """vl_imconvcoltri: a unit-INTEGRAL triangle over (−bin, bin)."""
    u = np.arange(-bin_size + 1, bin_size, dtype=np.float32)
    return (bin_size - np.abs(u)) / (bin_size * bin_size)


def bin_window_mean(bin_size: int, bin_index: int) -> float:
    """_vl_dsift_get_bin_window_mean: the mean of the flat-window gaussian
    (sigma = bin_size · windowSize) over one bin's triangle support."""
    delta = bin_size * (bin_index - 0.5 * (NUM_SPATIAL_BINS - 1))
    sigma = bin_size * WINDOW_SIZE
    x = np.arange(-bin_size + 1, bin_size, dtype=np.float64)
    z = (x - delta) / sigma
    return float(np.mean(np.exp(-0.5 * z * z)))


def _conv_edge_padded(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Separable convolution with edge replication, on (N, H, W) or (N, H,
    W, C): replicate-pad by the kernel's radius, convolve, crop."""
    r = (len(k) - 1) // 2
    x = img[..., None] if img.ndim == 3 else img
    padded = F.pad(x.permute(0, 3, 1, 2), (r, r, r, r), mode="replicate").permute(0, 2, 3, 1)
    out = conv2d_separable(padded, k, k)
    if r:
        out = out[:, r:-r, r:-r]
    return out[..., 0] if img.ndim == 3 else out


def _gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """vl_dsift gradients of (N, H, W): central differences, one-sided at
    the borders. Returns (d/d(row), d/d(col))."""
    gr = torch.cat(
        [
            img[:, 1:2, :] - img[:, 0:1, :],
            0.5 * (img[:, 2:, :] - img[:, :-2, :]),
            img[:, -1:, :] - img[:, -2:-1, :],
        ],
        dim=1,
    )
    gc = torch.cat(
        [
            img[:, :, 1:2] - img[:, :, 0:1],
            0.5 * (img[:, :, 2:] - img[:, :, :-2]),
            img[:, :, -1:] - img[:, :, -2:-1],
        ],
        dim=2,
    )
    return gr, gc


def _orientation_planes(img: torch.Tensor) -> torch.Tensor:
    """(N, H, W) → (N, H, W, 8) soft-binned gradient magnitude planes, the
    angle ``θ = atan2(−gx, gy)`` (gx the column derivative, gy the row
    derivative). The wrap is ``jnp.mod``'s: fmod, then + 8 where the
    remainder is negative. The one-hots are comparisons with ``arange``,
    so a bin index out of range gives a zero row."""
    gy, gx = _gradients(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    angle = torch.atan2(-gx, gy)
    t = angle * (NUM_ORIENTATIONS / (2 * math.pi))
    t = torch.fmod(t, NUM_ORIENTATIONS)
    t = torch.where(t < 0, t + NUM_ORIENTATIONS, t)
    lo = torch.floor(t)
    frac = t - lo
    lo = lo.to(torch.int64) % NUM_ORIENTATIONS
    hi = (lo + 1) % NUM_ORIENTATIONS
    bins = torch.arange(NUM_ORIENTATIONS, device=img.device)
    onehot_lo = (lo[..., None] == bins).to(img.dtype)
    onehot_hi = (hi[..., None] == bins).to(img.dtype)
    return onehot_lo * (mag * (1 - frac))[..., None] + onehot_hi * (mag * frac)[..., None]


def _scale_descriptors(img: torch.Tensor, bin_size: int, step: int, offset: int) -> torch.Tensor:
    """Flat-window descriptors for one scale of (N, H, W) smoothed images:
    (N, num_kp, 128) unnormalized histograms in (row-bin, col-bin,
    orientation) order, keypoints column-outer / row-inner."""
    n, h, w = img.shape
    acc = _conv_edge_padded(_orientation_planes(img), triangular_kernel(bin_size))
    frame_size = (NUM_SPATIAL_BINS - 1) * bin_size + 1
    rs = np.arange(offset, h - frame_size + 1, step)
    cs = np.arange(offset, w - frame_size + 1, step)
    if len(rs) == 0 or len(cs) == 0:
        return img.new_zeros((n, 0, DESC_DIM))
    bin_off = np.arange(NUM_SPATIAL_BINS) * bin_size
    row_idx = torch.as_tensor((rs[:, None] + bin_off[None, :]).reshape(-1), device=img.device)
    col_idx = torch.as_tensor((cs[:, None] + bin_off[None, :]).reshape(-1), device=img.device)
    g = acc.index_select(1, row_idx).index_select(2, col_idx)
    # (N, kr, 4, kc, 4, 8) → keypoints column-outer: (N, kc, kr, 4, 4, 8)
    g = g.reshape(n, len(rs), NUM_SPATIAL_BINS, len(cs), NUM_SPATIAL_BINS, NUM_ORIENTATIONS)
    g = g.permute(0, 3, 1, 2, 4, 5)
    # flat-window bin weights w(i)·w(j)·bin² (the triangle is unit-integral;
    # SIFT wants unit height, so ×bin per axis), in float32 as numpy takes them
    wmean = np.array(
        [bin_window_mean(bin_size, i) for i in range(NUM_SPATIAL_BINS)], np.float32
    ) * bin_size
    weights = torch.as_tensor(wmean[:, None, None] * wmean[None, :, None], device=img.device)
    return (g * weights.to(g.dtype)).reshape(n, len(rs) * len(cs), DESC_DIM)


def _finalize(desc: torch.Tensor) -> torch.Tensor:
    """L2 → clamp 0.2 → re-L2 → quantize ``min(trunc(512v), 255)``; zero
    the descriptors whose pre-normalization norm < 0.005."""
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    d = desc / torch.clamp_min(norm, 1e-10)
    d = torch.clamp_max(d, 0.2)
    d = d / torch.clamp_min(torch.linalg.vector_norm(d, dim=-1, keepdim=True), 1e-10)
    d = torch.clamp_max(torch.floor(512.0 * d), 255.0)
    return torch.where(norm >= CONTRAST_THRESHOLD, d, torch.zeros_like(d))


def _sift_multiscale(img: torch.Tensor, step: int, bin_size: int, num_scales: int,
                     scale_step: int) -> torch.Tensor:
    outs = []
    for s in range(num_scales):
        bin_s = bin_size + 2 * s
        smoothed = _conv_edge_padded(img, gaussian_kernel(bin_s / MAGNIF))
        offset = max((1 + 2 * num_scales) - 3 * s, 0)
        outs.append(_finalize(_scale_descriptors(smoothed, bin_s, step + s * scale_step, offset)))
    return torch.cat(outs, dim=1).transpose(1, 2)  # (N, 128, M)


@dataclasses.dataclass(eq=False)
class SIFTExtractor(Transformer):
    """Multi-scale dense SIFT (the VOC pipeline uses step 3, bin 4, 5
    scales, scale_step 0).

    Input: (N, H, W) or (N, H, W, 1) grayscale in [0, 1], float32, on any
    device. Output: (N, 128, M) quantized descriptors on that device,
    scales concatenated in order. ``backend``: ``device``, or ``native``:
    the host C++ kernel (``native/dsift.cpp``, the same algorithm and
    layout) on a host copy of the batch, its result placed back on the
    batch's device; a library that cannot be built raises."""

    step: int = 3
    bin_size: int = 4
    num_scales: int = 5
    scale_step: int = 0
    backend: str = "device"

    def __call__(self, batch):
        if self.backend not in ("device", "native"):
            raise ValueError(f"SIFTExtractor backend={self.backend!r}; expected device|native")
        batch = torch.as_tensor(batch)
        if batch.ndim == 4:
            batch = batch[..., 0]
        if self.backend == "native":
            from keystone_tpu_torch.native import native_dsift

            out = native_dsift(
                batch.detach().cpu().numpy(),
                step=self.step,
                bin_size=self.bin_size,
                num_scales=self.num_scales,
                scale_step=self.scale_step,
            )
            return torch.from_numpy(out).to(batch.device)
        return _sift_multiscale(
            batch.to(torch.float32), self.step, self.bin_size, self.num_scales, self.scale_step
        )
