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

from keystone_tpu_torch.core.kernels import Kernel, check_launch, counting, launch_on, note_ops, uncounted
from keystone_tpu_torch.ops.quantization import symmetric_int8

ENV_GRAM_OP = "KEYSTONE_GRAM_OP"
ENV_INT8_MAX_ERR = "KEYSTONE_GRAM_INT8_MAX_ERR"
_DEFAULT_INT8_MAX_ERR = 0.03

# rows per exact int32 segment: with |code| ≤ 127 a segment's sums stay
# below 131,072·127² < 2³¹; each segment is rounded once to f32 and the
# segments are added in f32 in row order. A fit chunk is one segment, so
# the result is ata_int8_xla's qᵀq (contracted in int32, rounded once).
SEGMENT_ROWS = 131072

# K1's output tiles: 128 rows (i) × 256 columns (j), and how many column
# panels a band of its tile order spans
TILE_I, TILE_J, TILE_BAND = 128, 256, 8

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
    """K1's plain version: ``qᵀq`` as f32, each segment of
    :data:`SEGMENT_ROWS` rows contracted exactly (int64 on the CPU; float64
    on CUDA, exact below 2⁵³), rounded once to f32, and the segments summed
    in f32 in row order — the kernel's arithmetic, so the two agree bit for
    bit."""
    n, d = q.shape
    exact = torch.int64 if q.device.type == "cpu" else torch.float64
    out = torch.zeros((d, d), dtype=torch.float32, device=q.device)
    for start in range(0, n, SEGMENT_ROWS):
        seg = q[start : start + SEGMENT_ROWS].to(exact)
        out += (seg.T @ seg).to(torch.float32)
    return out


def gram_tiles(d: int) -> np.ndarray:
    """The (I, J) output tiles K1 computes for a (d, d) Gram, in its order:
    the 128 × 256 tiles that hold an entry with i ≤ j (tile (I, J) does when
    128·I ≤ 256·J + 255), in bands of :data:`TILE_BAND` column panels, rows
    ascending within a band. Blocks that run at once then share a few
    panels of qᵀ in L2. Shape (tiles, 2), int32."""
    n_i, n_j = -(-d // TILE_I), -(-d // TILE_J)
    out = []
    for j0 in range(0, n_j, TILE_BAND):
        j1 = min(n_j, j0 + TILE_BAND)
        for i in range(min(n_i, 2 * j1)):
            out.extend((i, j) for j in range(max(j0, i // 2), j1))
    return np.asarray(out, dtype=np.int32).reshape(-1, 2)


_TILES: dict = {}


def _tiles_on(device, d: int) -> torch.Tensor:
    """:func:`gram_tiles` of ``d`` on ``device``, made once per pair."""
    key = (device.index, d)
    tiles = _TILES.get(key)
    if tiles is None:
        tiles = torch.from_numpy(gram_tiles(d)).to(device)
        _TILES[key] = tiles
    return tiles


def int8_gram(q: torch.Tensor) -> torch.Tensor:
    """``qᵀq`` (f32, (D, D)) of int8 codes ``q`` (N, D): K1 on a CUDA
    tensor, the plain version on a CPU tensor."""
    if not isinstance(q, torch.Tensor) or q.dtype != torch.int8 or q.ndim != 2:
        raise TypeError("int8_gram takes a 2-D int8 tensor")
    if counting():  # the cost profile's count: N·D·(D+1)
        note_ops(float(q.shape[0]) * q.shape[1] * (q.shape[1] + 1))
    if q.device.type == "cpu":
        with uncounted():
            return int8_gram_plain(q)
    if q.device.type != "cuda":
        raise ValueError(f"int8_gram: unsupported device {q.device}")
    if not q.is_contiguous():
        raise ValueError("int8_gram takes a contiguous tensor")
    n, d = q.shape
    out = torch.empty((d, d), dtype=torch.float32, device=q.device)
    if d == 0:
        return out
    # qᵀ with 16-byte rows (TMA's pitch), zeros past row n: the kernel's scratch
    pitch = max(16, -(-n // 16) * 16)
    qt = torch.empty((d, pitch), dtype=torch.int8, device=q.device)
    tiles = _tiles_on(q.device, d)
    fn = INT8_GRAM.function(
        "keystone_int8_gram",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_longlong] * 3
        + [ctypes.c_void_p],
    )
    code = launch_on(q.device, lambda s: fn(
        q.data_ptr(), qt.data_ptr(), out.data_ptr(), tiles.data_ptr(),
        tiles.shape[0], n, d, pitch, s,
    ))
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
    only.

    Every column at once: ``|a|`` sorted once per column puts its zeros
    first, so each column's nonzeros are a run whose two middle entries
    give the median — their float32 mean for an even count, as
    ``np.median`` takes it, so the value is the per-column loop's exactly.
    All-zero columns (and NaN ratios, which the loop's ``max`` never
    keeps) are skipped."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.abs(np.asarray(a, np.float32))
    if a.size == 0:
        return 0.0
    amax = a.max(axis=0)
    step_rms = amax / 127.0 / np.sqrt(12.0)
    cols = np.sort(np.ascontiguousarray(a.T), axis=1)  # (D, N), NaNs last
    zeros = np.count_nonzero(cols == 0, axis=1)
    nonzero = np.count_nonzero(cols > 0, axis=1)
    live = nonzero > 0
    idx = np.arange(cols.shape[0])[live]
    lo = zeros[live] + (nonzero[live] - 1) // 2
    hi = zeros[live] + nonzero[live] // 2
    mid_lo, mid_hi = cols[idx, lo], cols[idx, hi]
    median = np.where(lo == hi, mid_lo, (mid_lo + mid_hi) / np.float32(2))
    ratio = step_rms[live] / median
    ratio = ratio[~np.isnan(ratio)]
    return float(max(0.0, ratio.max())) if ratio.size else 0.0
