"""Quantized Gram operators for the streaming normal-equations fit.

Port of ``keystone_tpu/ops/gram.py``. The fit's hottest contraction is the
chunk Gram ``AᵀA`` (:func:`keystone_tpu_torch.ops.linear.normal_eq_update`).
The int8 operator quantizes each column symmetrically, contracts the codes
``qᵀq`` on the card's int8 tensor cores (kernel K1, ``csrc/int8_gram.cu``),
and applies the per-column scales as a rank-1 outer product on the (D, D)
result. The planner picks it (``plan/fused_fit.py``) when the probe's
quantization error clears ``KEYSTONE_GRAM_INT8_MAX_ERR`` and the device's
int8 rate beats fp32, or when ``KEYSTONE_GRAM_OP=int8`` asks for it.

:func:`int8_gram` is K1's wrapper: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes :func:`int8_gram_plain`, the kernel's plain
PyTorch version.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from keystone_tpu_torch.core.kernels import Kernel, check_launch, launch_on
from keystone_tpu_torch.ops.quantization import symmetric_int8

ENV_GRAM_OP = "KEYSTONE_GRAM_OP"
ENV_INT8_MAX_ERR = "KEYSTONE_GRAM_INT8_MAX_ERR"
_DEFAULT_INT8_MAX_ERR = 0.03

# rows per exact int32 partial: 512·127² < 2²⁴, so each partial is also
# exact in f32 and only the sum of partials rounds
K_TILE = 512

INT8_GRAM = Kernel("int8_gram", "int8_gram.cu")


def gram_op_request() -> str:
    """The requested Gram operator: ``KEYSTONE_GRAM_OP`` env knob,
    normalized to ``auto`` | ``fp32`` | ``int8`` (unknown → auto)."""
    raw = os.environ.get(ENV_GRAM_OP, "").strip().lower()
    return raw if raw in ("fp32", "int8") else "auto"


def int8_error_threshold() -> float:
    """Max quantization error the planner accepts before falling back to
    fp32 (``KEYSTONE_GRAM_INT8_MAX_ERR``)."""
    raw = os.environ.get(ENV_INT8_MAX_ERR, "").strip()
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return _DEFAULT_INT8_MAX_ERR


def ata_fp32(a: torch.Tensor) -> torch.Tensor:
    """The exact default Gram operator: ``aᵀa`` in f32."""
    a = a.to(torch.float32)
    return a.T @ a


def _quantize_cols(a):
    """Per-COLUMN symmetric int8 (scales pool over rows): the Gram's
    (i, j) entry reconstructs as ``s_i s_j · (qᵀq)_{ij}``. Zero pad rows
    quantize to zero codes and contribute nothing."""
    return symmetric_int8(a, reduce_dims=(0,))  # scale (1, D)


def int8_gram_plain(q: torch.Tensor) -> torch.Tensor:
    """K1's plain version: ``qᵀq`` as f32, each 512-row tile's product
    computed exactly (int32 on the CPU; float64 on CUDA, exact for these
    integers) and the tiles summed in f32 in row order — the kernel's
    arithmetic, so the two agree bit for bit."""
    n, d = q.shape
    exact = torch.int32 if q.device.type == "cpu" else torch.float64
    out = torch.zeros((d, d), dtype=torch.float32, device=q.device)
    for start in range(0, n, K_TILE):
        tile = q[start : start + K_TILE].to(exact)
        out += (tile.T @ tile).to(torch.float32)
    return out


def int8_gram(q: torch.Tensor) -> torch.Tensor:
    """``qᵀq`` (f32, (D, D)) of int8 codes ``q`` (N, D): K1 on a CUDA
    tensor, the plain version on a CPU tensor."""
    if not isinstance(q, torch.Tensor) or q.dtype != torch.int8 or q.ndim != 2:
        raise TypeError("int8_gram takes a 2-D int8 tensor")
    if q.device.type == "cpu":
        return int8_gram_plain(q)
    if q.device.type != "cuda":
        raise ValueError(f"int8_gram: unsupported device {q.device}")
    if not q.is_contiguous():
        raise ValueError("int8_gram takes a contiguous tensor")
    n, d = q.shape
    out = torch.empty((d, d), dtype=torch.float32, device=q.device)
    if d == 0:
        return out
    fn = INT8_GRAM.function(
        "keystone_int8_gram",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_void_p],
    )
    code = launch_on(q.device, lambda s: fn(q.data_ptr(), out.data_ptr(), n, d, s))
    check_launch(INT8_GRAM, code)
    INT8_GRAM.launches += 1
    return out


def ata_int8(a: torch.Tensor) -> torch.Tensor:
    """The planner-selectable int8 Gram operator: per-column int8 codes
    contracted by :func:`int8_gram`, then the rank-1 scale outer product
    (applied outside the kernel, as in ``ata_int8_pallas``)."""
    q, scale = _quantize_cols(a)
    qtq = int8_gram(q.contiguous())
    return qtq * (scale[0][:, None] * scale[0][None, :])


def gram_quantization_error(a) -> float:
    """Worst per-column quantization error of int8 codes on a probe
    slice, relative to the column's TYPICAL magnitude:
    ``max_col (amax_col/127) / (√12 · median|col|_nonzero)`` — the RMS
    rounding noise of a column's codes over the scale of the mass that
    carries the normal equations' signal. Host-side; probe-sized inputs
    only."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.abs(np.asarray(a, np.float32))
    if a.size == 0:
        return 0.0
    amax = a.max(axis=0)
    step_rms = amax / 127.0 / np.sqrt(12.0)
    worst = 0.0
    for j in range(a.shape[1]):
        col = a[:, j]
        nz = col[col > 0]
        if nz.size == 0:
            continue
        worst = max(worst, float(step_rms[j] / np.median(nz)))
    return worst
