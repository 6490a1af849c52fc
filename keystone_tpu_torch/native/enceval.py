"""Host GMM EM and Fisher vectors — port of
``keystone_tpu/native/enceval.py``.

The JAX package registers ``native/enceval_ffi.cpp``'s loops as XLA CPU
custom calls; PyTorch has no such door, so the port builds its own C ABI
copy of them, ``keystone_tpu_torch/csrc/enceval_host.cpp``, with ``g++``
at first use (:class:`keystone_tpu_torch.native.HostLibrary`) and calls it
through ctypes. Same equations and layouts as :mod:`keystone_tpu_torch.
ops.gmm`, in double precision on the host. A build or load failure
raises: the native path is only taken when a caller names it.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from keystone_tpu_torch.core.kernels import CSRC_DIR
from keystone_tpu_torch.native import HostLibrary


def _bind(lib: ctypes.CDLL) -> None:
    f32p, i64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
    lib.keystone_gmm_em.argtypes = [
        f32p, i64, i64, i64, f32p, f32p, f32p, i64, ctypes.c_float, f32p, f32p, f32p,
    ]
    lib.keystone_gmm_em.restype = ctypes.c_int
    lib.keystone_fisher.argtypes = [f32p, i64, i64, i64, i64, f32p, f32p, f32p, f32p]
    lib.keystone_fisher.restype = ctypes.c_int


ENCEVAL_LIB = HostLibrary(
    "keystone_enceval_host", [os.path.join(CSRC_DIR, "enceval_host.cpp")], _bind
)


def available() -> bool:
    """True when the shim builds and loads here."""
    return ENCEVAL_LIB.get() is not None


def _f32(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a, np.float32))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def gmm_em(
    x,
    k: int,
    max_iter: int = 100,
    seed: int = 42,
    var_floor: float = 1e-5,
    *,
    init: tuple | None = None,
):
    """Fit a diagonal GMM on (n, d) host samples with the native EM;
    returns numpy ``(means (d, k), variances (d, k), weights (k,))``.

    The start is ``init = (mu0, var0, w0)`` when given (a test hands it
    the JAX package's start), else the port's :func:`keystone_tpu_torch.
    ops.gmm.gmm_init` with ``seed``, as the device EM starts."""
    import torch

    from keystone_tpu_torch.ops.gmm import gmm_init

    lib = ENCEVAL_LIB.require()
    x = _f32(x)
    n, d = x.shape
    if init is None:
        init = gmm_init(torch.from_numpy(x), k, seed, var_floor)
    mu0, var0, w0 = (_f32(a) for a in init)
    if mu0.shape != (d, k) or var0.shape != (d, k) or w0.shape != (k,):
        raise ValueError(
            f"gmm_em start shapes {mu0.shape}, {var0.shape}, {w0.shape}; "
            f"expected ({d}, {k}), ({d}, {k}), ({k},)"
        )
    mu, var, w = np.empty((d, k), np.float32), np.empty((d, k), np.float32), np.empty(k, np.float32)
    rc = lib.keystone_gmm_em(
        _ptr(x), n, d, k, _ptr(mu0), _ptr(var0), _ptr(w0), int(max_iter),
        float(var_floor), _ptr(mu), _ptr(var), _ptr(w),
    )
    if rc != 0:
        raise RuntimeError(f"keystone_gmm_em failed (rc={rc}) for x {x.shape}, k {k}")
    return mu, var, w


def fisher_vectors(batch, means, variances, weights) -> np.ndarray:
    """Fisher vectors of (N, d, m) descriptor sets, natively: (N, d, 2k),
    the mean gradients in columns 0..k-1, the variance gradients in
    k..2k-1 (``ops.gmm.FisherVector``'s layout)."""
    lib = ENCEVAL_LIB.require()
    batch = _f32(batch)
    n, d, m = batch.shape
    means, variances, weights = _f32(means), _f32(variances), _f32(weights)
    k = int(weights.shape[0])
    if means.shape != (d, k) or variances.shape != (d, k):
        raise ValueError(
            f"fisher: gmm shapes {means.shape}, {variances.shape} do not match "
            f"descriptor dim {d} and {k} weights"
        )
    out = np.empty((n, d, 2 * k), np.float32)
    rc = lib.keystone_fisher(
        _ptr(batch), n, d, m, k, _ptr(means), _ptr(variances), _ptr(weights), _ptr(out)
    )
    if rc != 0:
        raise RuntimeError(f"keystone_fisher failed (rc={rc}) for batch {batch.shape}")
    return out
