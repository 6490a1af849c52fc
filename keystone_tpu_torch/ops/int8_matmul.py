"""Fused int8-dequant matmul for the LM decode path — port of
``keystone_tpu/ops/int8_matmul.py``.

:func:`mm_fused` is kernel K4's wrapper (``csrc/int8_matmul.cu``): the
int8 codes stream from device memory as int8 and are widened in registers,
the per-output-channel f32 scale is applied once to the f32 sum, and the
result is rounded once to y's dtype. A CUDA tensor launches the kernel (or
raises); a CPU tensor takes :func:`mm_fused_plain`, the kernel's plain
PyTorch version. Above 256 rows the JAX package's shape rule holds:
``mm_fused`` returns :func:`quantization.mm`, which is not a launch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from keystone_tpu_torch.core.kernels import Kernel, check_launch, launch_on
from keystone_tpu_torch.ops.quantization import QTensor, mm

INT8_MATMUL = Kernel("int8_matmul", "int8_matmul.cu")

# Largest M the kernel takes; past it mm_fused routes to quantization.mm
# (the JAX package's rule, where the whole M extent rides in one tile).
_MAX_M = 256

# kernel layout (csrc/int8_matmul.cu): 128 output columns and 8 rows per
# block, 32 k-lanes, at most 512 k-rows per block
_COLS, _ROWS, _LANES, _MAX_CHUNK = 128, 8, 32, 512
# blocks to aim for: two per SM of an H100
_TARGET_BLOCKS = 264

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(y: torch.Tensor, w: QTensor) -> None:
    if tuple(w.scale.shape) != (1, w.q.shape[1]):
        raise ValueError(
            f"mm_fused needs (1, N) per-output-channel scales; got "
            f"{tuple(w.scale.shape)} for q {tuple(w.q.shape)}"
        )
    if y.shape[-1] != w.q.shape[0]:
        raise ValueError(
            f"contraction mismatch: {tuple(y.shape)} @ {tuple(w.q.shape)}"
        )


def mm_fused_plain(y: torch.Tensor, w: QTensor) -> torch.Tensor:
    """K4's plain version: f32 products of the widened codes, f32 sum,
    the scale once, one rounding to y's dtype."""
    _check(y, w)
    k = y.shape[-1]
    out = (y.reshape(-1, k).to(torch.float32) @ w.q.to(torch.float32)) * w.scale
    return out.to(y.dtype).reshape(*y.shape[:-1], w.q.shape[1])


def split_k(m: int, k: int, n: int) -> tuple[int, int]:
    """(splits, chunk) of the contraction: enough blocks to fill the card,
    at most 512 k-rows a block, chunks a whole number of k-lanes."""
    tiles = math.ceil(n / _COLS) * math.ceil(m / _ROWS)
    want = max(1, min(math.ceil(_TARGET_BLOCKS / tiles), math.ceil(k / _LANES)))
    chunk = math.ceil(math.ceil(k / want) / _LANES) * _LANES
    chunk = min(chunk, _MAX_CHUNK)
    return math.ceil(k / chunk), chunk


def mm_fused(y: torch.Tensor, w: QTensor) -> torch.Tensor:
    """``y @ w.q · w.scale``: y (..., K) f32 or bf16, w.q (K, N) int8,
    w.scale (1, N) f32 → (..., N) in y's dtype. K4 on a CUDA tensor, the
    plain version on a CPU tensor."""
    _check(y, w)
    k, n = w.q.shape
    lead = y.shape[:-1]
    m = math.prod(lead)
    if m > _MAX_M:
        return mm(y, w, y.dtype)
    if y.device.type == "cpu":
        return mm_fused_plain(y, w)
    if y.device.type != "cuda":
        raise ValueError(f"mm_fused: unsupported device {y.device}")
    if y.dtype not in _DTYPES:
        raise TypeError(f"mm_fused takes float32 or bfloat16 y, got {y.dtype}")
    if w.q.dtype != torch.int8 or w.scale.dtype != torch.float32:
        raise TypeError("mm_fused takes int8 codes and float32 scales")
    if w.q.device != y.device or w.scale.device != y.device:
        raise ValueError("mm_fused: y, codes and scales must be on one device")
    if not (y.is_contiguous() and w.q.is_contiguous() and w.scale.is_contiguous()):
        raise ValueError("mm_fused takes contiguous tensors")
    out = torch.empty((*lead, n), dtype=y.dtype, device=y.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    splits, chunk = split_k(m, k, n)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=y.device)
    fn = INT8_MATMUL.function(
        "keystone_int8_matmul", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    code = launch_on(y.device, lambda s: fn(
        y.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(), ws.data_ptr(),
        out.data_ptr(), m, k, n, splits, chunk, _DTYPES[y.dtype], s,
    ))
    check_launch(INT8_MATMUL, code)
    INT8_MATMUL.launches += 1
    return out
