"""Statistical feature nodes — the random-FFT featurizer's nodes from
``keystone_tpu/ops/stats.py``. All nodes map ``(N, d)`` float batches on
the batch's own device."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from keystone_tpu_torch.core.pipeline import Transformer
from keystone_tpu_torch.core.runtime import resolve_device


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
