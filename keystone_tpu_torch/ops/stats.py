"""Statistical feature nodes — port of ``keystone_tpu/ops/stats.py``'s
scaler, random-FFT, cosine random-feature, row-normalization, Hellinger,
sampling and term-frequency nodes. The tensor nodes map ``(N, d)`` float
batches on the batch's own device; padded rows are masked out of a fit
with ``n_valid``."""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from keystone_tpu_torch.core.pipeline import Estimator, Transformer
from keystone_tpu_torch.core.runtime import resolve_device

# Matlab eps — the reference's variance/norm floor (utils/Stats.scala).
EPS = 2.2e-16


@dataclasses.dataclass(eq=False)
class StandardScalerModel(Transformer):
    """Subtract the mean, and divide by ``std`` unless it is None (fitted
    with ``normalize_std_dev=False``: the solvers' centering)."""

    mean: torch.Tensor
    std: torch.Tensor | None = None

    def __call__(self, batch):
        out = batch - self.mean
        if self.std is not None:
            out = out / self.std
        return out


@dataclasses.dataclass(eq=False)
class StandardScaler(Estimator):
    """Per-feature mean and unbiased std in one pass over the batch;
    ``n_valid`` masks trailing pad rows out of the moments. A std below
    ``eps`` becomes 1."""

    normalize_std_dev: bool = True
    eps: float = EPS

    def fit(self, data, n_valid: int | None = None) -> StandardScalerModel:
        mean, var = _masked_moments(data, n_valid)
        if not self.normalize_std_dev:
            return StandardScalerModel(mean=mean, std=None)
        n = data.shape[0] if n_valid is None else n_valid
        # unbiased (sample) std, matching the reference's summarizer
        std = torch.sqrt(var * (n / max(n - 1, 1)))
        std = torch.where(std < self.eps, torch.ones_like(std), std)
        return StandardScalerModel(mean=mean, std=std)


def _masked_moments(data, n_valid: int | None):
    """Population mean and variance over the first ``n_valid`` rows."""
    if n_valid is None or n_valid == data.shape[0]:
        return data.mean(dim=0), data.var(dim=0, unbiased=False)
    mask = (torch.arange(data.shape[0], device=data.device) < n_valid)[:, None].to(data.dtype)
    mean = (data * mask).sum(dim=0) / n_valid
    var = (mask * (data - mean) ** 2).sum(dim=0) / n_valid
    return mean, var


@dataclasses.dataclass(eq=False)
class RandomSignNode(Transformer):
    """Elementwise multiply by a fixed ±1 mask."""

    signs: torch.Tensor

    def __call__(self, batch):
        return batch * self.signs

    @staticmethod
    def create(
        num_features: int,
        generator: torch.Generator,
        device: torch.device | str | None = None,
    ) -> "RandomSignNode":
        """Rademacher signs drawn on the host from ``generator`` (the same
        signs whatever the device), then placed on ``device``: the card
        unless the caller asks for the CPU."""
        bits = torch.randint(0, 2, (num_features,), generator=generator)
        signs = (2 * bits - 1).to(torch.float32)
        return RandomSignNode(signs=signs.to(resolve_device(device)))


@functools.lru_cache(maxsize=32)
def _cos_matrix_host(d: int, n: int) -> np.ndarray:
    """Cached HOST (d, n/2) half-spectrum cosine matrix for PaddedFFT's
    matmul backend: real part of the rfft of the zero-padded row — pad
    columns drop out of the sum, so only the d live rows exist."""
    k = np.arange(n // 2)[None, :]
    nn = np.arange(d)[:, None]
    return np.cos(2.0 * np.pi * k * nn / n)


@functools.lru_cache(maxsize=8)
def _cos_matrix(d: int, n: int, dtype: torch.dtype, device: str) -> torch.Tensor:
    """The cosine matrix as a tensor on ``device`` (a small bounded cache:
    one 784×512 matrix per dtype and device in practice)."""
    return torch.as_tensor(_cos_matrix_host(d, n), dtype=dtype, device=device)


def next_pow2(d: int) -> int:
    return 1 << max(int(np.ceil(np.log2(d))), 0) if d > 1 else 1


@dataclasses.dataclass(eq=False)
class PaddedFFT(Transformer):
    """Zero-pad each row to the next power of two, FFT, return the real
    part of the first half. Output dim for input dim d:
    ``next_pow2(d) // 2``. Two backends:

    - ``fft``: ``Re(rfft)[:n/2]`` via ``torch.fft.rfft``;
    - ``matmul``: the same values as one cosine-matrix gemm;
    - ``auto`` (default): ``matmul`` for a CUDA tensor, ``fft`` for a CPU
      tensor.
    """

    impl: str = "auto"

    def resolve_impl(self, batch: torch.Tensor) -> str:
        if self.impl not in ("auto", "fft", "matmul"):
            raise ValueError(
                f"PaddedFFT impl={self.impl!r}; expected auto|fft|matmul"
            )
        if self.impl == "auto":
            return "matmul" if batch.is_cuda else "fft"
        return self.impl

    def __call__(self, batch):
        d = batch.shape[-1]
        n = next_pow2(d)
        if self.resolve_impl(batch) == "matmul":
            return batch @ _cos_matrix(d, n, batch.dtype, str(batch.device))
        padded = torch.nn.functional.pad(batch, (0, n - d))
        return torch.fft.rfft(padded, dim=-1).real[..., : n // 2]


@dataclasses.dataclass(eq=False)
class LinearRectifier(Transformer):
    """``max(max_val, x - alpha)``."""

    max_val: float = 0.0
    alpha: float = 0.0

    def __call__(self, batch):
        return torch.clamp_min(batch - self.alpha, self.max_val)


@dataclasses.dataclass(eq=False)
class CosineRandomFeatures(Transformer):
    """Random Fourier features ``cos(x Wᵀ + b)``: W (num_features,
    input_dim), b (num_features,). Gaussian W approximates an RBF kernel,
    Cauchy W a Laplacian one."""

    w: torch.Tensor
    b: torch.Tensor

    def __call__(self, batch):
        return torch.cos(batch @ self.w.T + self.b)

    @staticmethod
    def create(
        input_dim: int,
        num_features: int,
        generator: torch.Generator,
        gamma: float = 1.0,
        distribution: str = "gaussian",
        device: torch.device | str | None = None,
    ) -> "CosineRandomFeatures":
        """W (times ``gamma``) and b ~ U[0, 2π) drawn on the host from
        ``generator`` (the same draws whatever the device), then placed on
        ``device``: the card unless the caller asks for the CPU."""
        shape = (num_features, input_dim)
        if distribution == "gaussian":
            w = torch.randn(shape, generator=generator)
        elif distribution == "cauchy":
            w = torch.empty(shape).cauchy_(generator=generator)
        else:
            raise ValueError(f"unknown distribution {distribution!r}")
        b = torch.rand((num_features,), generator=generator) * (2 * np.pi)
        device = resolve_device(device)
        return CosineRandomFeatures(w=(gamma * w).to(device), b=b.to(device))


@dataclasses.dataclass(eq=False)
class NormalizeRows(Transformer):
    """Row L2 normalization with an ``eps`` floor on the norm."""

    eps: float = EPS

    def __call__(self, batch):
        norms = torch.linalg.vector_norm(batch, dim=-1, keepdim=True)
        return batch / torch.clamp_min(norms, self.eps)


@dataclasses.dataclass(eq=False)
class SignedHellingerMapper(Transformer):
    """``sign(x) * sqrt(|x|)``."""

    def __call__(self, batch):
        return torch.sign(batch) * torch.sqrt(torch.abs(batch))


def _draw(total: int, num: int, seed: int) -> np.ndarray:
    """``num`` distinct sorted indices below ``total``: numpy's
    ``default_rng(seed).choice`` without replacement, the JAX package's
    draw, so the same seed picks the same rows."""
    return np.sort(np.random.default_rng(seed).choice(total, num, replace=False))


@dataclasses.dataclass(eq=False)
class Sampler:
    """Up to ``size`` rows of a batch, in their order: a host-level helper
    that feeds fits on a sample (PCA, GMM, ZCA)."""

    size: int = 1000
    seed: int = 42

    def __call__(self, batch):
        n = batch.shape[0]
        if n <= self.size:
            return batch
        return batch[torch.as_tensor(_draw(n, self.size, self.seed), device=batch.device)]


def sample_columns(desc, num: int, seed: int) -> torch.Tensor:
    """Up to ``num`` descriptor columns as (num, d) rows.

    ``desc``: an (N, d, m) batch of feature-major descriptor matrices, or
    a list of (d, n_i) matrices (ragged). The rows are those of the
    flattened (N·m, d) column list, drawn by :func:`_draw`; for a batch
    they are gathered as ``desc[i // m, :, i % m]`` without building the
    transposed copy, which at the VOC workload's shape is 15 GB."""
    if isinstance(desc, (list, tuple)):
        flat = torch.cat([torch.as_tensor(m).T for m in desc], dim=0)  # (Σn_i, d)
        if flat.shape[0] <= num:
            return flat
        return flat[torch.as_tensor(_draw(flat.shape[0], num, seed), device=flat.device)]
    n, d, m = desc.shape
    if n * m <= num:
        return desc.transpose(1, 2).reshape(n * m, d)
    idx = torch.as_tensor(_draw(n * m, num, seed), device=desc.device)
    return desc[idx // m, :, idx % m]


@dataclasses.dataclass(eq=False)
class ColumnSampler:
    """``num_cols`` columns sampled across descriptor matrices: an (N, d,
    m) batch or a list of (d, n_i) matrices in, a (num_cols, d) row batch
    for a PCA or GMM fit out."""

    num_cols: int = 100000
    seed: int = 42

    def __call__(self, mats):
        return sample_columns(mats, self.num_cols, self.seed)


@dataclasses.dataclass(eq=False)
class TermFrequency(Transformer):
    """Per-document term counts re-weighted by ``fn``: a batch of token
    sequences → a batch of {token: weight} dicts (host code)."""

    fn: Callable[[float], float] = lambda x: x

    def __call__(self, batch):
        out = []
        for doc in batch:
            counts: dict = {}
            for tok in doc:
                counts[tok] = counts.get(tok, 0) + 1
            out.append({t: self.fn(c) for t, c in counts.items()})
        return out
