"""Dense linear-algebra estimators: PCA, ZCA whitening, LDA — port of
``keystone_tpu/ops/linalg.py``.

Small replicated computations on the samples' device: the SVD and the
symmetric eigenproblem go to ``torch.linalg`` (cuSOLVER on the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from keystone_tpu_torch.core.pipeline import Estimator, LabelEstimator, Transformer
from keystone_tpu_torch.ops.linear import LinearMapper


@dataclasses.dataclass(eq=False)
class PCATransformer(Transformer):
    """(N, d) @ pca_mat (d, dims) → (N, dims)."""

    pca_mat: torch.Tensor

    def __call__(self, batch):
        return batch @ self.pca_mat


@dataclasses.dataclass(eq=False)
class BatchPCATransformer(Transformer):
    """Feature-major descriptor matrices: (N, d, m) → (N, dims, m)."""

    pca_mat: torch.Tensor

    def __call__(self, batch):
        return torch.einsum("dk,ndm->nkm", self.pca_mat.to(batch.dtype), batch)


# rows × columns of the largest matrix handed to one cuSOLVER ``gesvd`` call:
# 1e6 × 128 ran (chip_smoke.py phase 30), 1e7 × 128 was refused in the
# call's workspace query (CUSOLVER_STATUS_INVALID_VALUE, phase 32, NVIDIA
# H100 80GB HBM3, 700 W)
_GESVD_MAX_ELEMENTS = 1 << 27


def _stacked_r(a: torch.Tensor, block_rows: int) -> torch.Tensor:
    """A matrix with ``a``'s singular values and right singular vectors
    and at most ``block_rows`` rows: the R factors of row blocks' QRs,
    stacked, and again until few enough rows are left (TSQR: AᵀA = RᵀR
    for the stack of the blocks' Rs). ``block_rows`` ≥ 2·columns, so that
    each round halves the rows at least."""
    if block_rows < 2 * a.shape[1]:
        raise ValueError(f"block_rows {block_rows} < 2 × {a.shape[1]} columns")
    while a.shape[0] > block_rows:
        a = torch.cat([torch.linalg.qr(a[i : i + block_rows], mode="r").R
                       for i in range(0, a.shape[0], block_rows)])
    return a


def _svd_s_vt(a: torch.Tensor):
    """The singular values and right singular vectors (``s``, ``vt``) of
    ``torch.linalg.svd(a, full_matrices=False)``. On the card through
    cuSOLVER's ``gesvd`` (QR iteration, LAPACK's algorithm), not torch's
    default Jacobi driver, whose looser stop left the random-patch filters
    built on the card 2.2e-5 of max|filters| from the CPU's where
    ``gesvd`` leaves 4.7e-6 (``chip_smoke.py`` phase 27 on an NVIDIA H100
    80GB HBM3 at 700 W). ``gesvd`` wants rows ≥ columns: a wide matrix
    goes through its transpose; a tall one past ``_GESVD_MAX_ELEMENTS``
    through :func:`_stacked_r` first, as LAPACK's ``gesvd`` itself takes a
    QR first for a tall matrix."""
    if not a.is_cuda:
        _, s, vt = torch.linalg.svd(a, full_matrices=False)
        return s, vt
    if a.shape[0] < a.shape[1]:
        u, s, _ = torch.linalg.svd(a.T, full_matrices=False, driver="gesvd")
        return s, u.T
    a = _stacked_r(a, max(_GESVD_MAX_ELEMENTS // a.shape[1], 2 * a.shape[1]))
    _, s, vt = torch.linalg.svd(a, full_matrices=False, driver="gesvd")
    return s, vt


def compute_pca(data, dims: int) -> torch.Tensor:
    """The first ``dims`` principal directions (d, dims) from the SVD of
    the centred sample, each column's sign fixed by the MATLAB rule: its
    largest-magnitude entry positive."""
    data = torch.as_tensor(data)
    centered = data - data.mean(dim=0)
    _, vt = _svd_s_vt(centered)
    pca = vt.T
    col_max = pca.max(dim=0).values
    col_abs_max = pca.abs().max(dim=0).values
    signs = torch.where(col_max == col_abs_max, 1.0, -1.0).to(pca.dtype)
    return (pca * signs)[:, :dims]


@dataclasses.dataclass(eq=False)
class PCAEstimator(Estimator):
    """PCA fitted on (N, d) rows (column-sampled descriptors flattened
    first)."""

    dims: int = 64

    def fit(self, data) -> PCATransformer:
        return PCATransformer(pca_mat=compute_pca(data, self.dims))

    def fit_batch(self, data) -> BatchPCATransformer:
        return BatchPCATransformer(pca_mat=compute_pca(data, self.dims))


@dataclasses.dataclass(eq=False)
class ZCAWhitener(Transformer):
    """(x − means) @ whitener."""

    whitener: torch.Tensor  # (d, d)
    means: torch.Tensor  # (d,)

    def __call__(self, batch):
        return (batch - self.means) @ self.whitener


@dataclasses.dataclass(eq=False)
class ZCAWhitenerEstimator(Estimator):
    """``W = V diag((s²/(n−1) + eps)^-½) Vᵀ`` from the thin SVD of the
    centred sample (:func:`_svd_s_vt`). W does not depend on the singular
    vectors' signs."""

    eps: float = 0.1

    def fit(self, data) -> ZCAWhitener:
        data = torch.as_tensor(data)
        means = data.mean(dim=0)
        n = data.shape[0]
        s, vt = _svd_s_vt(data - means)
        scale = torch.rsqrt(s * s / (n - 1.0) + self.eps)
        return ZCAWhitener(whitener=(vt.T * scale) @ vt, means=means)


@dataclasses.dataclass(eq=False)
class LinearDiscriminantAnalysis(LabelEstimator):
    """Multi-class LDA as the symmetric generalized eigenproblem: S_W
    Cholesky-whitened (with a 1e-6·tr(S_W)/d ridge), then ``eigh`` of
    L⁻¹ S_B L⁻ᵀ; the ``num_dimensions`` leading directions mapped back
    through L⁻ᵀ. The columns' signs are whatever ``eigh`` returns."""

    num_dimensions: int = 2

    def fit(self, data, labels) -> LinearMapper:
        x = torch.as_tensor(data)
        y = np.asarray(labels)
        d = x.shape[1]
        mean_all = x.mean(dim=0)
        s_w = torch.zeros((d, d), dtype=x.dtype, device=x.device)
        s_b = torch.zeros_like(s_w)
        for c in np.unique(y):
            xc = x[torch.as_tensor(np.flatnonzero(y == c), device=x.device)]
            mu = xc.mean(dim=0)
            dev = xc - mu
            s_w = s_w + dev.T @ dev
            dm = (mu - mean_all)[:, None]
            s_b = s_b + xc.shape[0] * (dm @ dm.T)
        eye = torch.eye(d, dtype=x.dtype, device=x.device)
        s_w = s_w + 1e-6 * torch.trace(s_w) / d * eye
        li = torch.linalg.solve_triangular(torch.linalg.cholesky(s_w), eye, upper=False)
        vals, vecs = torch.linalg.eigh(li @ s_b @ li.T)
        order = torch.argsort(-vals)[: self.num_dimensions]
        return LinearMapper(x=li.T @ vecs[:, order])
