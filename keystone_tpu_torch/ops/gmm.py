"""Gaussian mixture models and Fisher vectors — port of
``keystone_tpu/ops/gmm.py``: a diagonal-covariance GMM fit by EM, and the
improved Fisher vector of descriptor sets.

``means`` and ``variances`` are (dim, k), ``weights`` (k,); the three CSV
files match the JAX package's (and the reference's) artifact format. The
E step expands the Gaussian exponent into products over the points
beside their squares, and the M step takes both moments in one product;
these, and the Fisher vector's, run in full float32 (TF32 off,
:func:`keystone_tpu_torch.ops.linear._matmul_precision`), since 100 EM
iterations amplify a 1e-3 change in the log posteriors. The EM loop
starts from given ``(mu0, var0, w0)``; :func:`gmm_init` makes them from a
seeded ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from keystone_tpu_torch.core.pipeline import Estimator, Transformer
from keystone_tpu_torch.core.runtime import resolve_device
from keystone_tpu_torch.ops.linear import _matmul_precision

VAR_FLOOR = 1e-5


def _with_squares(x: torch.Tensor) -> torch.Tensor:
    """(N, d) points → (N, 2d): each point beside its squares."""
    return torch.cat([x, x * x], dim=1)


def _log_resp(xcat, means, variances, weights) -> torch.Tensor:
    """(N, 2d) points beside their squares → (N, k) log posteriors. The
    exponent ``−(x−mu)²/2var`` expands into ``x·mu/var − x²·0.5/var`` plus
    a constant per component, so with the normalizer and the log weight
    it is one (N, 2d)·(2d, k) product whose epilogue adds the (k,)
    constants: no pass over the (N, k) matrix before the logsumexp."""
    mu = means.T  # (k, d)
    var = variances.T
    log_norm = -0.5 * torch.sum(torch.log((2 * math.pi) * var), dim=1)  # (k,)
    m2 = torch.sum(mu * mu / (2 * var), dim=1)
    const = log_norm - m2 + torch.log(weights)
    w = torch.cat([(mu / var).T, (-0.5 / var).T], dim=0)  # (2d, k)
    log_p = torch.addmm(const, xcat, w)
    return log_p.sub_(torch.logsumexp(log_p, dim=1, keepdim=True))


@dataclasses.dataclass(eq=False)
class GaussianMixtureModel(Transformer):
    """Diagonal-covariance GMM parameters and soft assignment."""

    means: torch.Tensor  # (dim, k)
    variances: torch.Tensor  # (dim, k)
    weights: torch.Tensor  # (k,)

    @property
    def k(self) -> int:
        return self.means.shape[1]

    @property
    def dim(self) -> int:
        return self.means.shape[0]

    def log_responsibilities(self, x) -> torch.Tensor:
        """(N, d) points → (N, k) log posteriors."""
        with _matmul_precision("highest"):
            return _log_resp(_with_squares(x), self.means, self.variances, self.weights)

    def __call__(self, batch):
        """Soft cluster assignments (N, k)."""
        return torch.exp(self.log_responsibilities(batch))

    def save_csv(self, mean_file: str, vars_file: str, weights_file: str) -> None:
        np.savetxt(mean_file, self.means.cpu().numpy(), delimiter=",")
        np.savetxt(vars_file, self.variances.cpu().numpy(), delimiter=",")
        np.savetxt(weights_file, self.weights.cpu().numpy()[None], delimiter=",")

    @staticmethod
    def load_csv(mean_file: str, vars_file: str, weights_file: str, *,
                 device: torch.device | str | None = None) -> "GaussianMixtureModel":
        """The artifact load, onto ``device`` (the card unless the caller
        asks for the CPU)."""
        device = resolve_device(device)

        def load(path, **kw):
            return torch.tensor(np.loadtxt(path, delimiter=",", **kw), dtype=torch.float32,
                                device=device)

        return GaussianMixtureModel(
            means=load(mean_file, ndmin=2),
            variances=load(vars_file, ndmin=2),
            weights=load(weights_file).reshape(-1),
        )


def gmm_init(x: torch.Tensor, k: int, seed: int, var_floor: float):
    """EM's start: k distinct samples as the means, the global variance
    (floored) for every component, uniform weights.

    The k indices come from ``torch.randperm`` on a CPU
    ``torch.Generator`` seeded with ``seed``. That draw is NOT the JAX
    package's (``jax.random.choice``, which torch cannot reproduce): the
    same seed picks other samples. To run the two packages from one
    start, hand the JAX package's ``gmm_init`` output to :func:`gmm_em`."""
    n = x.shape[0]
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randperm(n, generator=gen)[:k].to(x.device)
    mu0 = x[idx].T  # (d, k)
    global_var = torch.clamp_min(torch.var(x, dim=0, unbiased=False), var_floor)
    var0 = global_var[:, None].repeat(1, k)
    w0 = torch.full((k,), 1.0 / k, dtype=x.dtype, device=x.device)
    return mu0, var0, w0


def gmm_em(x: torch.Tensor, mu0, var0, w0, max_iter: int, var_floor: float = VAR_FLOOR):
    """``max_iter`` EM steps on (N, d) samples from ``(mu0, var0, w0)``;
    returns ``(means, variances, weights)`` on the samples' device. An
    iteration is two products over the points beside their squares: the E
    step's (:func:`_log_resp`) and the M step's, which takes both moments
    at once."""
    n, d = x.shape
    xcat = _with_squares(x)
    mu, var, w = mu0, var0, w0
    with _matmul_precision("highest"):
        for _ in range(max_iter):
            gamma = _log_resp(xcat, mu, var, w).exp_()  # (N, k)
            nk = torch.sum(gamma, dim=0) + 1e-10
            moments = (xcat.T @ gamma) / nk  # (2d, k): E[x] and E[x²]
            del gamma
            mu = moments[:d]
            var = torch.clamp_min(moments[d:] - mu * mu, var_floor)
            w = nk / n
    return mu, var, w


@dataclasses.dataclass(eq=False)
class GaussianMixtureModelEstimator(Estimator):
    """Fit a diagonal GMM with EM from :func:`gmm_init`'s start, on the
    samples' device. ``backend``: ``device``, or ``native``: the host C++
    EM (:mod:`keystone_tpu_torch.native.enceval`) on a host copy of the
    samples from the same start, the model placed on their device."""

    k: int = 16
    max_iter: int = 100
    seed: int = 42
    var_floor: float = VAR_FLOOR
    backend: str = "device"

    def fit(self, samples) -> GaussianMixtureModel:
        if self.backend not in ("device", "native"):
            raise ValueError(
                f"GaussianMixtureModelEstimator backend={self.backend!r}; expected device|native")
        x = torch.as_tensor(samples).to(torch.float32)
        if self.backend == "native":
            from keystone_tpu_torch.native import enceval

            out = enceval.gmm_em(x.cpu(), self.k, self.max_iter, self.seed, self.var_floor)
            means, variances, weights = (torch.from_numpy(a).to(x.device) for a in out)
            return GaussianMixtureModel(means=means, variances=variances, weights=weights)
        init = gmm_init(x, self.k, self.seed, self.var_floor)
        means, variances, weights = gmm_em(x, *init, self.max_iter, self.var_floor)
        return GaussianMixtureModel(means=means, variances=variances, weights=weights)


@dataclasses.dataclass(eq=False)
class FisherVector(Transformer):
    """Improved Fisher vector of each descriptor set with respect to a GMM
    (alpha 1, no internal power or L2 normalization: the pipeline applies
    signed-sqrt and L2 as separate nodes).

    Input: (N, d, m) feature-major descriptor matrices. Output: (N, d, 2k),
    columns 0..k-1 the mean gradients, k..2k-1 the variance gradients.
    ``backend``: ``device``, or ``native``: the host C++ encoder on host
    copies, the result placed on the batch's device."""

    gmm: GaussianMixtureModel
    backend: str = "device"

    def __call__(self, batch):
        if self.backend == "native":
            from keystone_tpu_torch.native import enceval

            batch = torch.as_tensor(batch)
            g = self.gmm
            out = enceval.fisher_vectors(batch, g.means, g.variances, g.weights)
            return torch.from_numpy(out).to(batch.device)
        if self.backend != "device":
            raise ValueError(f"FisherVector backend={self.backend!r}; expected device|native")
        return fisher_vectors(batch, self.gmm)


def fisher_vectors(batch: torch.Tensor, gmm: GaussianMixtureModel) -> torch.Tensor:
    """(N, d, m) descriptor sets → (N, d, 2k) Fisher vectors: the
    responsibilities of every descriptor, then the zeroth, first and
    second moments per component, the last two as one batched product."""
    n_imgs, d, m = batch.shape
    xcat = _with_squares(batch.transpose(1, 2).reshape(n_imgs * m, d))  # (Nm, 2d)
    with _matmul_precision("highest"):
        gamma = _log_resp(xcat, gmm.means, gmm.variances, gmm.weights).exp_()
        gamma = gamma.reshape(n_imgs, m, -1)
        s0 = torch.sum(gamma, dim=1)  # (N, k)
        s12 = torch.bmm(gamma.transpose(1, 2), xcat.reshape(n_imgs, m, 2 * d))  # (N, k, 2d)
    del gamma, xcat
    s1, s2 = s12[..., :d], s12[..., d:]
    mu = gmm.means.T  # (k, d)
    sigma = torch.sqrt(gmm.variances.T)
    w = gmm.weights
    # mean gradient: (1/(m sqrt(w_k))) Σ_i gamma (x − mu)/sigma
    fv_mu = (s1 - s0[..., None] * mu) / sigma
    fv_mu = fv_mu / (m * torch.sqrt(w)[:, None])
    # variance gradient: (1/(m sqrt(2 w_k))) Σ_i gamma ((x − mu)²/sigma² − 1)
    quad = s2 - 2 * s1 * mu + s0[..., None] * (mu * mu)
    fv_sig = quad / (sigma * sigma) - s0[..., None]
    fv_sig = fv_sig / (m * torch.sqrt(2 * w)[:, None])
    return torch.cat([fv_mu, fv_sig], dim=1).transpose(1, 2)  # (N, d, 2k)
