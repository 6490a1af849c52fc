"""Fixed-size chunked application — port of the parts of
``keystone_tpu/core/batching.py`` the planned executor uses."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from keystone_tpu_torch.core.staging import run_staged, to_device


def pad_labels(labels: np.ndarray, rows: int) -> np.ndarray:
    """(N,) int labels zero-padded to ``rows``: the labels of a batch whose
    rows a mesh or a chunk padded."""
    y = np.zeros(rows, np.int32)
    y[: len(labels)] = labels
    return y


def pad_to_chunk(chunk, chunk_size: int) -> tuple:
    """Zero-pad ``chunk`` (tensor or numpy array) along axis 0 to exactly
    ``chunk_size`` rows. Returns ``(padded, valid)`` where ``valid`` is the
    real row count."""
    valid = chunk.shape[0]
    if valid == chunk_size:
        return chunk, valid
    if isinstance(chunk, np.ndarray):
        pad = [(0, chunk_size - valid)] + [(0, 0)] * (chunk.ndim - 1)
        return np.pad(chunk, pad), valid
    padded = chunk.new_zeros((chunk_size,) + tuple(chunk.shape[1:]))
    padded[:valid] = chunk
    return padded, valid


def apply_in_chunks(
    fn: Callable,
    data,
    chunk_size: int,
    device: torch.device,
    *,
    stage_depth: int | None = None,
):
    """Apply ``fn`` to ``data`` in fixed-size chunks along axis 0 on
    ``device``. The last chunk is zero-padded to ``chunk_size`` and its
    padding rows are dropped from the result. Chunks are staged
    host→device ahead of use (:mod:`keystone_tpu_torch.core.staging`)."""
    n = data.shape[0]
    if n <= chunk_size:
        return fn(to_device(data, device))

    def chunks():
        for start in range(0, n, chunk_size):
            yield pad_to_chunk(data[start : start + chunk_size], chunk_size)

    outs = list(run_staged(chunks(), fn, device, stage_depth=stage_depth))
    return torch.cat(outs, dim=0)
