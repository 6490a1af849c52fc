"""Host→device chunk staging: the one engine behind every chunked pass.

Port of ``keystone_tpu/core/staging.py``. On a CUDA device, each host
chunk is copied into a pinned host buffer and sent to the card on a
dedicated copy stream, ``depth`` chunks ahead of the consumer; the compute
stream waits on the copy's event before using the chunk, so chunk k+1's
transfer overlaps chunk k's compute. On the CPU everything runs inline.

- :func:`stage_chunks` — ``(host_chunk, valid_rows)`` pairs in, ``(staged,
  valid_rows)`` pairs out, in order. A chunk is a tensor, a numpy array or
  a tuple of them (every leaf's leading axis is rows).
- :func:`run_staged` — apply a function to each staged chunk and yield
  its output with the pad rows sliced off.
- :func:`fold_staged` — the accumulate form: a carried state folded over
  the staged stream (the streaming normal-equations fit).

Nothing here synchronizes the host with the card: PyTorch's caching
allocators keep a pinned buffer until its copy has finished, and the
staged tensor is recorded on the compute stream so its memory is not
reused while queued work still reads it.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

ENV_STAGE_DEPTH = "KEYSTONE_STAGE_DEPTH"
_DEFAULT_DEPTH = 2


def default_stage_depth() -> int:
    """Staged-chunk depth: ``KEYSTONE_STAGE_DEPTH`` override, else 2
    (double buffering). ``0`` stages synchronously."""
    raw = os.environ.get(ENV_STAGE_DEPTH, "").strip()
    if raw:
        try:
            return max(int(raw), 0)
        except ValueError:
            pass
    return _DEFAULT_DEPTH


ENV_TUNE = "KEYSTONE_TUNE"


def tune_active():
    """The active autotuner (:mod:`keystone_tpu_torch.plan.tune`), or None —
    without importing the plan package on untuned processes: the import
    only happens when ``KEYSTONE_TUNE`` is set or a tuner was installed
    programmatically (the module is in ``sys.modules``). The one gate
    every tuner-fed path shares (staging, the ingest frontier, the LM
    train loop)."""
    import sys

    mod = sys.modules.get("keystone_tpu_torch.plan.tune")
    if mod is None:
        if not os.environ.get(ENV_TUNE, "").strip():
            return None
        from keystone_tpu_torch.plan import tune as mod
    return mod.active()


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every array leaf of a tensor / tuple / list tree."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def as_tensor(x: Any) -> torch.Tensor:
    """A numpy array (shared, not copied) or tensor as a tensor."""
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


def to_device(tree: Any, device: torch.device) -> Any:
    """Synchronous placement of a chunk tree on ``device``."""
    return tree_map(lambda a: as_tensor(a).to(device), tree)


def stage_chunks(
    chunks: Iterable[tuple[Any, int]],
    device: torch.device,
    *,
    depth: int | None = None,
) -> Iterator[tuple[Any, int]]:
    """Stage ``(host_chunk, valid_rows)`` pairs onto ``device`` ahead of
    consumption; yields ``(staged_chunk, valid_rows)`` in order.

    A chunk already on ``device`` passes through untouched. With a CUDA
    device and ``depth > 0`` (``KEYSTONE_STAGE_DEPTH`` overrides the
    default 2) up to ``depth`` chunks are in flight on the copy stream.
    """
    depth = default_stage_depth() if depth is None else max(int(depth), 0)
    tuner = tune_active()  # once per stream
    if device.type != "cuda" or depth == 0:
        for chunk, valid in chunks:
            t0 = time.perf_counter()
            staged = to_device(chunk, device)
            if tuner is not None:
                # the placement's host wall feeds the wait_host
                # attribution the autotuner acts on
                tuner.observe(bucket="wait_host", wall_s=time.perf_counter() - t0)
            yield staged, valid
        return

    copy_stream = torch.cuda.Stream(device)
    compute_stream = torch.cuda.current_stream(device)
    source = iter(chunks)
    in_flight: deque = deque()

    def place(host: Any) -> torch.Tensor:
        t = as_tensor(host)
        if t.device == device:
            return t
        if t.device.type == "cpu" and not t.is_pinned():
            pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            pinned.copy_(t)
            t = pinned
        with torch.cuda.stream(copy_stream):
            return t.to(device, non_blocking=True)

    def issue() -> bool:
        try:
            chunk, valid = next(source)
        except StopIteration:
            return False
        t0 = time.perf_counter()
        staged = tree_map(place, chunk)
        if tuner is not None:
            # the host side of the transfer: pinning and issuing the copy
            tuner.observe(bucket="wait_host", wall_s=time.perf_counter() - t0)
        done = torch.cuda.Event()
        done.record(copy_stream)
        in_flight.append((staged, valid, done))
        return True

    for _ in range(depth):
        if not issue():
            break
    while in_flight:
        staged, valid, done = in_flight.popleft()
        issue()
        compute_stream.wait_event(done)
        tree_map(lambda a: a.record_stream(compute_stream), staged)
        yield staged, valid


def run_staged(
    chunks: Iterable[tuple[Any, int]],
    fn: Callable,
    device: torch.device,
    *,
    stage_depth: int | None = None,
) -> Iterator[Any]:
    """Run ``fn`` over a staged chunk stream; yield each output (every
    leaf row-indexed) with its pad rows sliced off.

    Under the autotuner each output is waited for, and the wait and the
    chunk's rows feed its wait_device attribution and goodput (the
    untuned stream never waits)."""
    tuner = tune_active()
    for staged, valid in stage_chunks(chunks, device, depth=stage_depth):
        out = tree_map(lambda a: a[:valid], fn(staged))
        if tuner is not None:
            t0 = time.perf_counter()
            _wait(device)
            tuner.observe(bucket="wait_device", wall_s=time.perf_counter() - t0, rows=valid)
        yield out


def fold_staged(
    chunks: Iterable[tuple[Any, int]],
    fn: Callable,
    init: Any,
    device: torch.device,
    *,
    stage_depth: int | None = None,
) -> Any:
    """Fold a staged chunk stream through a carried state:
    ``state = fn(state, staged_chunk, valid_rows)`` per chunk. Under the
    autotuner each chunk's rows feed its goodput, and the wait for the
    final state its wait_device attribution."""
    tuner = tune_active()
    state = init
    for staged, valid in stage_chunks(chunks, device, depth=stage_depth):
        state = fn(state, staged, valid)
        if tuner is not None:
            tuner.observe(rows=valid)
    if tuner is not None:
        t0 = time.perf_counter()
        _wait(device)
        tuner.observe(bucket="wait_device", wall_s=time.perf_counter() - t0)
    return state


def _wait(device: torch.device) -> None:
    """Wait for ``device``'s queued work (the CPU has none)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
