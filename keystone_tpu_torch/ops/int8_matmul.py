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
import functools
import math
from typing import NamedTuple

import torch

from keystone_tpu_torch.core.kernels import (
    Kernel,
    check_launch,
    counting,
    launch_on,
    note_ops,
    uncounted,
)
from keystone_tpu_torch.ops.quantization import QTensor, mm

INT8_MATMUL = Kernel("int8_matmul", "int8_matmul.cu")

# Largest M the kernel takes; past it mm_fused routes to quantization.mm
# (the JAX package's rule, where the whole M extent rides in one tile).
_MAX_M = 256

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


# kernel layout (csrc/int8_matmul.cu): slabs of 16 code rows × 128
# columns, 8 warps a block, each with 2 slabs of y in flight in slots of
# rows 24 (bf16) or 20 (f32) elements apart
_COLS, _SLAB, _WARPS, _DEPTH = 128, 16, 8, 2
_INBOX_BYTES = (16 * _COLS // 4 + 16) * 16
# blocks in a cluster: 8 is the size every Hopper card schedules
MAX_SPLITS = 8


class K4Plan(NamedTuple):
    """How one K4 launch cuts its work (the kernel's ``Plan``, checked
    there): ``rows`` of y a block (16 or 8 in bf16, 4 in f32) and
    ``groups`` of them along grid y; one cluster of ``splits`` blocks per
    column tile of 128 outputs (``col_tiles`` of them along grid x), block
    s taking the s-th equal run of the tile's ``slabs`` 16-row code slabs;
    ``smem`` bytes of shared memory a block."""

    rows: int
    groups: int
    col_tiles: int
    slabs: int
    splits: int
    smem: int


def k4_plan(m: int, k: int, n: int, bf16: bool, sms: int, clusters=None) -> K4Plan:
    """K4's work split for (m, k) @ (k, n) on a card with ``sms``
    multiprocessors: the most blocks per column tile (at most
    ``MAX_SPLITS``, at most one per slab) that keep all the blocks within
    three quarters of the SMs, for which the card runs every tile's cluster
    at once. Clusters are placed whole inside a GPC (a group of 16–18 SMs
    on an H100), so a grid that asks for every SM leaves some of its
    clusters waiting or doubled up on an SM: on an H100, (8 × 1,024) @
    (1,024 × 4,096) ran faster as 96 blocks in clusters of 3 than as 128
    in clusters of 4. ``clusters(rows, splits)`` says how many clusters of ``splits`` blocks
    the card runs at once (the kernel's occupancy query; by default one
    block per SM)."""
    rows = (8 if m <= 8 else 16) if bf16 else 4
    col_tiles, slabs = -(-n // _COLS), -(-k // _SLAB)
    clusters = clusters or (lambda rows, splits: sms // splits)
    splits = max(1, min(MAX_SPLITS, slabs, 3 * sms // 4 // col_tiles))
    while splits > 1 and clusters(rows, splits) < col_tiles:
        splits -= 1
    slots = _WARPS * _DEPTH * rows * (24 * 2 if bf16 else 20 * 4)
    smem = _WARPS * rows * (_COLS + 4) * 4 + _INBOX_BYTES + slots
    return K4Plan(rows, -(-m // rows), col_tiles, slabs, splits, smem)


_PLANS: dict = {}  # (device, m, k, n, dtype) → the plan as C ints
_CLUSTERS: dict = {}  # (device, dtype, rows, splits) → clusters at once


@functools.cache
def _launcher():
    """K4's C entry point, looked up once: the decode path calls it
    thousands of times a generate."""
    return INT8_MATMUL.function(
        "keystone_int8_matmul",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2,
    )


def _clusters_on(index: int, dtype: int):
    """The kernel's occupancy query for ``k4_plan``, cached per device."""
    def clusters(rows: int, splits: int) -> int:
        key = (index, dtype, rows, splits)
        if key not in _CLUSTERS:
            fn = INT8_MATMUL.function(
                "keystone_int8_matmul_clusters", [ctypes.c_int] * 3 + [ctypes.c_void_p])
            out = ctypes.c_int()
            with torch.cuda.device(index):
                check_launch(INT8_MATMUL, fn(dtype, rows, splits, ctypes.byref(out)))
            _CLUSTERS[key] = out.value
        return _CLUSTERS[key]
    return clusters


def _plan_on(index: int, m: int, k: int, n: int, dtype: int):
    key = (index, m, k, n, dtype)
    plan = _PLANS.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        p = k4_plan(m, k, n, dtype == 1, sms, _clusters_on(index, dtype))
        plan = _PLANS[key] = (ctypes.c_int * 6)(*p)
    return plan


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
    if counting():
        note_ops(2.0 * m * k * n)
    if y.device.type == "cpu":
        with uncounted():
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
    fn = _launcher()
    dtype = _DTYPES[y.dtype]
    index = y.device.index if y.device.index is not None else torch.cuda.current_device()
    plan = _plan_on(index, m, k, n, dtype)
    code = launch_on(y.device, lambda s: fn(
        y.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(), out.data_ptr(),
        m, k, n, dtype, plan, s,
    ))
    check_launch(INT8_MATMUL, code)
    INT8_MATMUL.launches += 1
    return out
