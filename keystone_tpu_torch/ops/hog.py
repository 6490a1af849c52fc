"""HOG descriptors, the Felzenszwalb (FHOG) 31-dim variant — port of
``keystone_tpu/ops/hog.py`` (the reference's ``HogExtractor.scala``).

Per pixel the channel with the largest gradient magnitude wins (first
channel on ties, as both argmaxes take it); its orientation is snapped
to 18 signed bins; each pixel goes bilinearly into 2×2 cells; block
energies from the 9 contrast-insensitive sums give a 4-way
normalization clamped at 0.2; features are 18 sensitive + 9
insensitive + 4 texture-energy terms (factor 0.2357). The one-hots are
``arange`` comparisons, the cell sums products in full f32.

Output: (N, cells_h, cells_w, 31).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from keystone_tpu_torch.core.pipeline import Transformer
from keystone_tpu_torch.ops.linear import _matmul_precision

NUM_SIGNED = 18
NUM_UNSIGNED = 9
EPS = 1e-4
TEXTURE_SCALE = 0.2357


@dataclasses.dataclass(eq=False)
class HogExtractor(Transformer):
    """(N, H, W, C) → (N, cells_h, cells_w, 31)."""

    cell_size: int = 8

    def __call__(self, batch):
        with _matmul_precision("highest"):
            return _hog(batch, self.cell_size)


def _one_hot(idx: torch.Tensor, size: int, dtype) -> torch.Tensor:
    return (idx[..., None] == torch.arange(size, device=idx.device)).to(dtype)


def _hog(batch, cell: int):
    n, h, w, c = batch.shape
    dev, dt = batch.device, batch.dtype
    # gradients: interior central differences, zero at the borders
    gy = F.pad(batch[:, 2:] - batch[:, :-2], (0, 0, 0, 0, 1, 1))
    gx = F.pad(batch[:, :, 2:] - batch[:, :, :-2], (0, 0, 1, 1))
    mag2 = gx * gx + gy * gy  # (N, H, W, C)
    best = torch.argmax(mag2, dim=-1, keepdim=True)
    gx1 = torch.gather(gx, -1, best)[..., 0]
    gy1 = torch.gather(gy, -1, best)[..., 0]
    mag = torch.sqrt(torch.gather(mag2, -1, best)[..., 0])

    # snap to 18 signed orientations: argmax_k |ux_k·gx + uy_k·gy| over 9
    # unsigned directions, the sign picks the half
    ks = np.arange(NUM_UNSIGNED)
    ux = torch.as_tensor(np.cos(ks * math.pi / NUM_UNSIGNED).astype(np.float32), device=dev)
    uy = torch.as_tensor(np.sin(ks * math.pi / NUM_UNSIGNED).astype(np.float32), device=dev)
    dots = gx1[..., None] * ux + gy1[..., None] * uy  # (N, H, W, 9)
    best_k = torch.argmax(torch.abs(dots), dim=-1)  # (N, H, W)
    sign_neg = torch.gather(dots, -1, best_k[..., None])[..., 0] < 0
    ori = best_k + NUM_UNSIGNED * sign_neg.to(torch.int64)  # 0..17

    cells_h, cells_w = h // cell, w // cell
    # bilinear interpolation of each pixel into the 2×2 neighboring cells
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / cell - 0.5
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / cell - 0.5
    y0 = torch.floor(ys).to(torch.int64)
    x0 = torch.floor(xs).to(torch.int64)
    wy1 = ys - y0
    wx1 = xs - x0

    weighted = _one_hot(ori, NUM_SIGNED, dt) * mag[..., None]  # (N, H, W, 18)

    def cell_reduce(img, idx, weights, size, axis):
        """Scatter-add rows or columns into cells with ``weights``: the
        pixel axis contracted with a (pixels, cells) matrix."""
        seg = _one_hot(torch.clamp(idx, 0, size - 1), size, img.dtype) * weights[:, None]
        return torch.tensordot(img, seg, dims=([axis], [0]))

    rows = cell_reduce(weighted, y0, 1 - wy1, cells_h, 1) + cell_reduce(
        weighted, y0 + 1, wy1, cells_h, 1
    )  # (N, W, 18, cells_h)
    rows = torch.movedim(rows, -1, 1)  # (N, cells_h, W, 18)
    hist = cell_reduce(rows, x0, 1 - wx1, cells_w, 2) + cell_reduce(
        rows, x0 + 1, wx1, cells_w, 2
    )  # (N, cells_h, 18, cells_w)
    hist = torch.movedim(hist, -1, 2)  # (N, cells_h, cells_w, 18)

    # block energies from the contrast-insensitive sums; out-of-range
    # neighbor cells clamp into the grid (edge replication)
    insens = hist[..., :NUM_UNSIGNED] + hist[..., NUM_UNSIGNED:]
    energy = torch.sum(insens * insens, dim=-1)  # (N, ch, cw)
    e = F.pad(energy[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    blocks = [
        e[:, :-2, :-2] + e[:, :-2, 1:-1] + e[:, 1:-1, :-2] + e[:, 1:-1, 1:-1],
        e[:, :-2, 1:-1] + e[:, :-2, 2:] + e[:, 1:-1, 1:-1] + e[:, 1:-1, 2:],
        e[:, 1:-1, :-2] + e[:, 1:-1, 1:-1] + e[:, 2:, :-2] + e[:, 2:, 1:-1],
        e[:, 1:-1, 1:-1] + e[:, 1:-1, 2:] + e[:, 2:, 1:-1] + e[:, 2:, 2:],
    ]
    norms = [torch.rsqrt(b + EPS) for b in blocks]

    def norm_clip(v):
        return [torch.clamp_max(v * nrm[..., None], 0.2) for nrm in norms]

    sens_parts = norm_clip(hist)
    insens_parts = norm_clip(insens)
    f_sens = 0.5 * sum(sens_parts)
    f_insens = 0.5 * sum(insens_parts)
    f_texture = TEXTURE_SCALE * torch.stack([p.sum(dim=-1) for p in sens_parts], dim=-1)
    return torch.cat([f_sens, f_insens, f_texture], dim=-1)
