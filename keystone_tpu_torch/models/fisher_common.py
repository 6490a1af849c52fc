"""The descriptor → Fisher-vector branch — port of
``keystone_tpu/models/fisher_common.py``: PCA and a GMM fitted on sampled
descriptor columns (or loaded from CSV artifacts), then Fisher vector →
vectorize → L2 → signed sqrt → L2 over batches of (N, d, m) descriptors.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from keystone_tpu_torch.core.batching import apply_in_chunks
from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.core.runtime import resolve_device, synchronize
from keystone_tpu_torch.ops.gmm import FisherVector, GaussianMixtureModel, GaussianMixtureModelEstimator
from keystone_tpu_torch.ops.linalg import BatchPCATransformer, compute_pca
from keystone_tpu_torch.ops.stats import NormalizeRows, SignedHellingerMapper, sample_columns
from keystone_tpu_torch.ops.util import MatrixVectorizer

logger = get_logger("keystone_tpu_torch.models.fisher_common")


class FisherBranch:
    """Fit (or load) PCA and a GMM on one descriptor family and featurize
    batches of (N, d, m) descriptors into normalized Fisher vectors, on
    ``device`` (the card unless the caller asks for the CPU). ``times``
    holds the seconds the last fit spent in the PCA (sample, fit and
    projection) and in the GMM (sample and EM)."""

    def __init__(
        self,
        desc_dim: int,
        vocab_size: int,
        num_pca_samples: int,
        num_gmm_samples: int,
        seed: int,
        pca_file: str = "",
        gmm_files: tuple[str, str, str] = ("", "", ""),
        device: torch.device | str | None = None,
    ):
        self.desc_dim = desc_dim
        self.vocab_size = vocab_size
        self.num_pca_samples = num_pca_samples
        self.num_gmm_samples = num_gmm_samples
        self.seed = seed
        self.pca_file = pca_file
        self.gmm_files = gmm_files
        self.device = resolve_device(device)
        self.pca: BatchPCATransformer | None = None
        self.post = None
        self.times: dict[str, float] = {}

    def _fit_pca(self, sample_fn) -> None:
        """Artifact-aware PCA fit; ``sample_fn()`` supplies (n, d) rows."""
        if self.pca_file and os.path.exists(self.pca_file):
            pca_mat = torch.tensor(np.loadtxt(self.pca_file, delimiter=",", ndmin=2),
                                   dtype=torch.float32, device=self.device)
            logger.info("loaded PCA from %s", self.pca_file)
        else:
            pca_mat = compute_pca(sample_fn(), self.desc_dim)
            if self.pca_file:
                np.savetxt(self.pca_file, pca_mat.cpu().numpy(), delimiter=",")
        self.pca = BatchPCATransformer(pca_mat=pca_mat)

    def _fit_gmm_and_post(self, proj_sample_fn) -> None:
        """Artifact-aware GMM fit and the five-stage Fisher chain;
        ``proj_sample_fn()`` supplies (n, desc_dim) projected rows."""
        if all(self.gmm_files) and all(os.path.exists(f) for f in self.gmm_files):
            gmm = GaussianMixtureModel.load_csv(*self.gmm_files, device=self.device)
            logger.info("loaded GMM from %s", self.gmm_files[0])
        else:
            gmm = GaussianMixtureModelEstimator(k=self.vocab_size).fit(proj_sample_fn())
            if all(self.gmm_files):
                gmm.save_csv(*self.gmm_files)
        self.post = (
            FisherVector(gmm=gmm)
            >> MatrixVectorizer()
            >> NormalizeRows()
            >> SignedHellingerMapper()
            >> NormalizeRows()
        )

    def _clock(self, key: str, t0: float) -> float:
        synchronize(self.device)
        t = time.perf_counter()
        self.times[key] = t - t0
        return t

    def fit(self, train_desc, chunk_size: int, n_valid: int | None = None):
        """Fit PCA and the GMM (artifact-aware) and return the projected
        train descriptors (reused to featurize the training set).

        ``n_valid``: the count of real rows when the batch was zero-padded:
        pad images' all-zero descriptors are kept out of the PCA and GMM
        samples (they would seed a spurious zero cluster)."""
        t0 = time.perf_counter()
        fit_desc = train_desc if n_valid is None else train_desc[:n_valid]
        self._fit_pca(lambda: sample_columns(fit_desc, self.num_pca_samples, self.seed))
        projected = apply_in_chunks(self.pca, train_desc, chunk_size, self.device)
        t0 = self._clock("pca_s", t0)
        proj_fit = projected if n_valid is None else projected[:n_valid]
        self._fit_gmm_and_post(
            lambda: sample_columns(proj_fit, self.num_gmm_samples, self.seed + 1)
        )
        self._clock("gmm_s", t0)
        return projected

    def fit_from_samples(self, sample_cols) -> None:
        """Fit PCA and the GMM from a bounded (n, d) descriptor-column
        sample (the streaming path's reservoir) instead of from
        materialized descriptors."""
        sample_cols = torch.as_tensor(sample_cols, dtype=torch.float32, device=self.device)
        self._fit_pca(lambda: sample_cols[: self.num_pca_samples])
        self._fit_gmm_and_post(lambda: (sample_cols @ self.pca.pca_mat)[: self.num_gmm_samples])

    def featurize_projected(self, projected, chunk_size: int):
        return apply_in_chunks(self.post, projected, chunk_size, self.device)

    def featurize(self, desc, chunk_size: int):
        projected = apply_in_chunks(self.pca, desc, chunk_size, self.device)
        return self.featurize_projected(projected, chunk_size)
