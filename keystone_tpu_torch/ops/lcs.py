"""Local Color Statistics — port of ``keystone_tpu/ops/lcs.py`` (the
reference's ``LCSExtractor.scala``).

Per keypoint of a regular grid: a 4×4 neighborhood of sub-patches, each
described by the mean and standard deviation of every color channel, so
96-dim descriptors (4·4·3·2) for RGB. The mean and std maps come from one
separable box filter over the batch (cuDNN on the card, full f32), the
std as ``sqrt(max(E[x²] − m², 0))`` in the reference's order of
operations; the descriptors are then two ``index_select`` gathers (a
keypoint grid closer to the edge than the neighborhood reaches wraps
negative indices and reads NaN past the end, as ``jnp.take`` does).

Layout: feature-major (N, C·4·4·2, num_keypoints); features ordered
(channel, nx, ny, {mean, std}), keypoints row-major over the grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from keystone_tpu_torch.core.pipeline import Transformer
from keystone_tpu_torch.utils.images import conv2d_separable


@dataclasses.dataclass(eq=False)
class LCSExtractor(Transformer):
    """(N, H, W, C) → (N, C·4·4·2, num_keypoints). The reference's
    ImageNet defaults: stride 4, stride start 16, sub-patch size 6."""

    stride: int = 4
    stride_start: int = 16
    sub_patch_size: int = 6

    def __call__(self, batch):
        return _lcs(batch, self.stride, self.stride_start, self.sub_patch_size)


def _take_index(idx: np.ndarray, size: int, device):
    """The reference's ``jnp.take`` indices along an axis of ``size``:
    negative ones wrap and out-of-range ones read NaN (its fill mode).
    Returns the clamped index tensor and the mask of valid positions
    (None when all are valid)."""
    idx = np.where((idx < 0) & (idx >= -size), idx + size, idx)
    ok = (idx >= 0) & (idx < size)
    index = torch.as_tensor(np.clip(idx, 0, size - 1), device=device)
    return index, None if ok.all() else torch.as_tensor(ok, device=device)


def _lcs(batch, stride: int, stride_start: int, sps: int):
    n, h, w, c = batch.shape
    box = np.full(sps, 1.0 / sps, np.float32)
    means = conv2d_separable(batch, box, box)
    sq = conv2d_separable(batch * batch, box, box)
    stds = torch.sqrt(torch.clamp_min(sq - means * means, 0.0))

    # keypoint grid: stride_start until dim − stride_start by stride;
    # neighborhood offsets −2·sps + sps/2 − 1 .. sps + sps/2 − 1 by sps
    kp_rows = np.arange(stride_start, h - stride_start, stride)
    kp_cols = np.arange(stride_start, w - stride_start, stride)
    offs = np.arange(-2 * sps + sps // 2 - 1, sps + sps // 2, sps)
    row_idx, row_ok = _take_index((kp_rows[:, None] + offs[None, :]).reshape(-1), h, batch.device)
    col_idx, col_ok = _take_index((kp_cols[:, None] + offs[None, :]).reshape(-1), w, batch.device)

    def gather(img):
        g = img.index_select(1, row_idx).index_select(2, col_idx)
        if row_ok is not None:
            g[:, ~row_ok] = float("nan")
        if col_ok is not None:
            g[:, :, ~col_ok] = float("nan")
        return g.reshape(n, len(kp_rows), len(offs), len(kp_cols), len(offs), c)

    both = torch.stack([gather(means), gather(stds)], dim=-1)  # (N, kr, nx, kc, ny, C, 2)
    # → features ordered (C, nx, ny, stat); keypoints row-major over (kr, kc)
    both = both.permute(0, 1, 3, 5, 2, 4, 6)
    n_kp = len(kp_rows) * len(kp_cols)
    feats = both.reshape(n, n_kp, c * len(offs) * len(offs) * 2)
    return feats.permute(0, 2, 1)
