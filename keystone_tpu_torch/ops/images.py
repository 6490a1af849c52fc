"""Image nodes — port of ``keystone_tpu/ops/images.py``.

Every node takes an (N, H, W, C) float batch. Patches flatten as
(dy, dx, c), channel fastest: the reference's patch index
``c + x·C + y·C·k``, so filters and whiteners carry across unchanged.

The convolution nodes hold no hand-written kernel: the JAX package
retired its Pallas im2col and fused conv kernels (``ops/images.py``
there, the ``Convolver`` and ``FusedConvRectifyPool`` docstrings), and
its Convolver is one XLA convolution with the patch normalization
folded around it. Here that is one cuDNN convolution (TF32 off unless
``precision`` asks for less) with the same algebra; the box sums and
the pools are f32 adds (``avg_pool2d`` with ``divisor_override=1``,
``max_pool2d``), never a convolution.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from keystone_tpu_torch.core.pipeline import FunctionNode, Pipeline, Transformer
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
class Windower(FunctionNode):
    """Every ``stride``-spaced ``window_size``² window of every image:
    (N, H, W, C) → (N·n_windows, w, w, C)."""

    stride: int = 1
    window_size: int = 6

    def __call__(self, batch):
        n, _, _, c = batch.shape
        w = self.window_size
        p = extract_patches(batch, w, self.stride)
        return p.reshape(n * p.shape[1] * p.shape[2], w, w, c)


def normalize_patch_rows(mat, var_constant: float = 10.0) -> torch.Tensor:
    """Centre each row and divide by ``sqrt(var + var_constant)``, the
    variance over ``d − 1``."""
    d = mat.shape[-1]
    mean = mat.mean(dim=-1, keepdim=True)
    var = ((mat - mean) ** 2).sum(dim=-1, keepdim=True) / max(d - 1, 1)
    return (mat - mean) / torch.sqrt(var + var_constant)


def _box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """Sums over every k×k window of (N, H, W), "VALID": f32 adds."""
    return F.avg_pool2d(x[:, None], k, stride=1, divisor_override=1)[:, 0]


def conv_convolver(
    batch,
    filters,
    *,
    patch_size: int,
    normalize_patches: bool,
    var_constant: float,
    whitener_means=None,
    precision=None,
) -> torch.Tensor:
    """The Convolver as one dense convolution plus box-sum algebra.

    With a patch's mean mu and sigma = sqrt(var + vc), normalization is
    affine in the patch:

        ((p − mu)/sigma − m)·F_f = (p·F_f − mu·ΣF_f)/sigma − m·F_f

    so the im2col schedule factors into one cuDNN convolution (``p·F_f``)
    and per-patch scalars from two box sums of the channel sum and sum of
    squares: no (N, oh, ow, k²C) patch tensor exists. The convolution
    runs over the NHWC batch viewed as NCHW (``channels_last``) with the
    (F, k²C) filter rows as (F, C, k, k); (N, oh, ow, F) float32 out.
    Eager PyTorch fuses nothing, so the algebra is two passes over the
    map: ``addcmul_`` in place, then ``addcdiv`` (or ``div_``)."""
    from keystone_tpu_torch.ops.linear import _matmul_precision

    k = patch_size
    f = filters.shape[0]
    c = batch.shape[-1]
    d = k * k * c
    batch = batch.to(torch.float32)
    filters = filters.to(torch.float32)
    wts = filters.reshape(f, k, k, c).permute(0, 3, 1, 2)  # (F, C, k, k)
    with _matmul_precision(precision):
        out = F.conv2d(batch.permute(0, 3, 1, 2), wts).permute(0, 2, 3, 1)
        shift = None
        if whitener_means is not None:
            shift = -(filters @ whitener_means.to(torch.float32))  # (F,)
        if normalize_patches:
            s1 = _box_sum(batch.sum(dim=-1), k)  # (N, oh, ow) patch sums
            s2 = _box_sum((batch * batch).sum(dim=-1), k)
            mu = s1 / d
            # a one-pass variance can round below 0 on a flat patch, which
            # would give NaN at var_constant 0
            var = torch.clamp_min(s2 - s1 * mu, 0.0) / max(d - 1, 1)
            sigma = torch.sqrt(var + var_constant)[..., None]
            out.addcmul_(mu[..., None], filters.sum(dim=1), value=-1.0)  # − mu·ΣF_f
            if shift is None:
                return out.div_(sigma)
            return torch.addcdiv(shift, out, sigma)
        if shift is not None:
            out.add_(shift)
    return out


@dataclasses.dataclass(eq=False)
class Convolver(Transformer):
    """Filter-bank convolution with optional patch normalization
    (``normalize_patch_rows`` with ``var_constant``) and whitener means.

    ``filters`` (F, patch_size²·C), rows in (dy, dx, c) layout. ``impl``:

    - ``auto`` / ``conv``: :func:`conv_convolver`;
    - ``xla``: im2col — patches, normalize, subtract the means, one
      product (the reference's schedule, the parity baseline).

    ``precision`` None or ``highest`` is full f32; a name that asks for
    less lets cuDNN and cuBLAS take TF32."""

    filters: torch.Tensor
    whitener_means: torch.Tensor | None = None
    patch_size: int = 6
    normalize_patches: bool = True
    var_constant: float = 10.0
    impl: str = "auto"
    precision: str | None = None

    def __call__(self, batch):
        from keystone_tpu_torch.ops.linear import _matmul_precision

        if self.impl not in ("auto", "conv", "xla"):
            raise ValueError(f"Convolver impl={self.impl!r}; expected auto|conv|xla")
        batch = batch.to(torch.float32)
        if self.impl in ("auto", "conv"):
            return conv_convolver(
                batch,
                self.filters,
                patch_size=self.patch_size,
                normalize_patches=self.normalize_patches,
                var_constant=self.var_constant,
                whitener_means=self.whitener_means,
                precision=self.precision,
            )
        p = extract_patches(batch, self.patch_size)  # (N, oh, ow, k²C)
        if self.normalize_patches:
            p = normalize_patch_rows(p, self.var_constant)
        if self.whitener_means is not None:
            p = p - self.whitener_means
        with _matmul_precision(self.precision):
            return p @ self.filters.to(p.dtype).T


@dataclasses.dataclass(eq=False)
class SymmetricRectifier(Transformer):
    """x → [max(max_val, x − α), max(max_val, −x − α)] on the channel
    axis: C → 2C channels."""

    max_val: float = 0.0
    alpha: float = 0.0

    def __call__(self, batch):
        pos = torch.clamp_min(batch - self.alpha, self.max_val)
        neg = torch.clamp_min(-batch - self.alpha, self.max_val)
        return torch.cat([pos, neg], dim=-1)


@dataclasses.dataclass(eq=False)
class Pooler(Transformer):
    """Strided pooling with the reference's window geometry: windows start
    at 0, ``stride`` apart, ``num_pools = ceil((dim − pool_size//2) /
    stride)``, the edge windows truncated.

    ``pixel_fn`` (a callable on tensors), then a pad on the right only
    (zeros, −inf for max) to ``(num_pools − 1)·stride + pool_size``, then
    a "VALID" pool: ``avg_pool2d`` with ``divisor_override=1`` for the
    sum, ``max_pool2d`` for the max. The mean divides the sum by
    ``pool_size²`` even at a truncated edge (the reference's quirk)."""

    stride: int = 13
    pool_size: int = 14
    pixel_fn: Callable | None = None
    pool_fn: str = "sum"  # sum | max | mean

    def __call__(self, batch):
        if self.pixel_fn is not None:
            batch = self.pixel_fn(batch)
        _, h, w, _ = batch.shape
        pad_h = (self._num_pools(h) - 1) * self.stride + self.pool_size - h
        pad_w = (self._num_pools(w) - 1) * self.stride + self.pool_size - w
        x = batch.permute(0, 3, 1, 2)  # NCHW view of the NHWC batch
        if pad_h > 0 or pad_w > 0:
            x = F.pad(
                x,
                (0, max(pad_w, 0), 0, max(pad_h, 0)),
                value=float("-inf") if self.pool_fn == "max" else 0.0,
            )
        if self.pool_fn == "max":
            out = F.max_pool2d(x, self.pool_size, self.stride)
        else:
            out = F.avg_pool2d(x, self.pool_size, self.stride, divisor_override=1)
        if self.pool_fn == "mean":
            out = out / float(self.pool_size * self.pool_size)
        return out.permute(0, 2, 3, 1)

    def _num_pools(self, dim: int) -> int:
        return -(-(dim - self.pool_size // 2) // self.stride)


@dataclasses.dataclass(eq=False)
class FusedConvRectifyPool(Transformer):
    """``Convolver >> SymmetricRectifier >> Pooler`` as one node, the
    union of their parameters (:func:`keystone_tpu_torch.core.fusion.optimize`
    makes it). ``impl``:

    - ``auto``: :func:`conv_convolver`, then each rectifier half pooled
      before the channel concat, so the (N, oh, ow, 2F) map never exists
      (pooling is per channel, so this is exact for sum, mean and max);
    - ``unfused``: the literal three-node chain.

    Output (N, ph, pw, 2F), channels ``[pos | neg]``."""

    filters: torch.Tensor
    whitener_means: torch.Tensor | None = None
    patch_size: int = 6
    normalize_patches: bool = True
    var_constant: float = 10.0
    alpha: float = 0.0
    max_val: float = 0.0
    pool_stride: int = 13
    pool_size: int = 14
    pool_fn: str = "sum"
    impl: str = "auto"  # auto | unfused

    def _pooler(self) -> Pooler:
        return Pooler(stride=self.pool_stride, pool_size=self.pool_size, pool_fn=self.pool_fn)

    def _unfused(self) -> Pipeline:
        return Pipeline.of(
            Convolver(
                filters=self.filters,
                whitener_means=self.whitener_means,
                patch_size=self.patch_size,
                normalize_patches=self.normalize_patches,
                var_constant=self.var_constant,
            ),
            SymmetricRectifier(max_val=self.max_val, alpha=self.alpha),
            self._pooler(),
        )

    def __call__(self, batch):
        if self.impl not in ("auto", "unfused"):
            raise ValueError(
                f"FusedConvRectifyPool impl={self.impl!r}; expected auto|unfused"
            )
        if self.impl == "unfused":
            return self._unfused()(batch)
        conv = conv_convolver(
            batch,
            self.filters,
            patch_size=self.patch_size,
            normalize_patches=self.normalize_patches,
            var_constant=self.var_constant,
            whitener_means=self.whitener_means,
        )
        pool = self._pooler()
        pos = pool((conv - self.alpha).clamp_min_(self.max_val))
        neg = pool(torch.sub(-self.alpha, conv).clamp_min_(self.max_val))
        return torch.cat([pos, neg], dim=-1)


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
