"""Symmetric int8 quantization — port of
``keystone_tpu/ops/quantization.py``.

Weight-only int8 for serving: a decode step re-reads every weight, so the
weight bytes set its time. Symmetric per-output-channel scales keep the
product exact up to rounding, applied to the activation-sized result
(``(y @ q) · scale``). :mod:`keystone_tpu_torch.ops.int8_matmul` (kernel
K4) streams the codes as int8; :func:`mm` here is the plain product.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class QTensor:
    """Symmetric int8 tensor: ``q · scale`` reconstructs the original.
    ``scale`` is broadcast-shaped against the reconstruction — (1, out)
    for (in, out) matmul weights, (V, 1) for row-quantized embeddings."""

    q: torch.Tensor  # int8, original shape
    scale: torch.Tensor  # f32, broadcastable to q's shape

    @property
    def shape(self):
        return self.q.shape

    @property
    def device(self) -> torch.device:
        return self.q.device

    def dequantize(self) -> torch.Tensor:
        return self.q.to(torch.float32) * self.scale


def symmetric_int8(w, reduce_dims, amax=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The one symmetric-int8 recipe: amax/127 scales (floored at 1e-12),
    round half to even, clip to ±127. ``reduce_dims`` are the axes the
    scale pools over (kept as size-1 axes); ``amax``, when given, is that
    pooled max |w|, taken where ``w`` is one shard of the pooled axes.
    Returns (int8 codes, f32 scale)."""
    w = torch.as_tensor(w, dtype=torch.float32)
    if amax is None:
        amax = torch.amax(w.abs(), dim=tuple(reduce_dims), keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int8(w, *, channel_axis: int = -1) -> QTensor:
    """Per-channel symmetric quantization: the scale pools over every axis
    except ``channel_axis``. -1 suits (in, out) weights; 0 suits (V, d)
    embeddings (per row, so both the gather and the tied-logit transpose
    see a per-output scale)."""
    w = torch.as_tensor(w)
    channel_axis = channel_axis % w.ndim
    reduce_dims = tuple(a for a in range(w.ndim) if a != channel_axis)
    q, scale = symmetric_int8(w, reduce_dims)
    return QTensor(q=q, scale=scale)


def mm(y: torch.Tensor, w, dt: torch.dtype) -> torch.Tensor:
    """``y @ w`` where ``w`` is a plain tensor or a :class:`QTensor` with
    per-output-channel (1, out) scales. The int8 path rounds twice, as the
    JAX package's does: the product in ``dt``, then the f32 scale, then
    the cast back to ``dt``."""
    if isinstance(w, QTensor):
        return ((y @ w.q.to(dt)) * w.scale).to(dt)
    return y @ w.to(dt)


def quantization_error(w) -> float:
    """Max abs reconstruction error of quantizing ``w`` (diagnostics)."""
    w = np.asarray(w, np.float32)
    qt = quantize_int8(torch.from_numpy(w))
    return float(np.max(np.abs(qt.dequantize().numpy() - w)))
