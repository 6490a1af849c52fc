"""Streaming image ingestion — port of ``keystone_tpu/loaders/
streaming.py``.

The reference streams tar archives per executor, one Spark partition a
tar file, images decoded and featurized without ever materializing the
corpus on one machine (``ImageLoaderUtils.scala:177-216``). Here:

- :func:`iter_tar_image_batches` — incremental tar decode yielding
  fixed-size host batches; ``process_index``/``process_count`` shard the
  tar FILES round-robin over processes;
- :func:`ingest_frontier` — the bounded decode pool that runs ahead of
  the consumer, yielding in input order;
- :class:`ColumnReservoir` — a bounded uniform sample of descriptor
  columns across a stream, drawn in the JAX package's numpy order;
- :func:`prefetch_batches` — a batch producer on a background thread;
- :func:`featurize_stream` — each host batch through a featurizer on the
  device, padded to one static chunk shape, keeping only the features on
  the host.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Iterable, Iterator

import numpy as np

from keystone_tpu_torch.loaders.image_loaders import (
    _count_decode_failure,
    _expand,
    _iter_tar_images,
    decode_image,
)

ENV_INGEST_WORKERS = "KEYSTONE_INGEST_WORKERS"
# the frontier's thread-pool ceiling; the live worker count (≤ this)
# bounds how many decodes are in flight
_INGEST_POOL_MAX = 16


def default_ingest_workers() -> int:
    """Decode parallelism when no autotuner drives it:
    ``KEYSTONE_INGEST_WORKERS``, else 8."""
    raw = os.environ.get(ENV_INGEST_WORKERS, "").strip()
    if raw:
        try:
            return max(int(raw), 1)
        except ValueError:
            pass
    return 8


def _live_workers() -> int:
    """The frontier's worker count: the autotuner's ``ingest_workers``
    knob when one is active, else the env/static default."""
    from keystone_tpu_torch.core.staging import tune_active

    tuner = tune_active()
    if tuner is not None:
        v = tuner.value("ingest_workers")
        if v:
            return int(v)
    return default_ingest_workers()


def ingest_frontier(
    items: Iterable,
    fn: Callable,
    *,
    workers: int | Callable[[], int] | None = None,
    pool: int = _INGEST_POOL_MAX,
    span_name: str | None = "ingest.wait_host",
) -> Iterator[Any]:
    """Map ``fn`` over ``items`` with a bounded multi-worker pool running
    AHEAD of the consumer, yielding results in input order (equal to
    ``(fn(i) for i in items)``; exceptions re-raised at the consumer in
    order).

    Up to the current worker count of calls are in flight (``workers``:
    an int, a callable polled at each refill, or None for the live
    autotuner knob / ``KEYSTONE_INGEST_WORKERS``). The time the consumer
    blocks on the next result is the wait_host stall: it feeds an active
    autotuner and, when a span log is active and the wait is not
    trivial, one ``ingest.wait_host`` span."""
    import concurrent.futures
    import time
    from collections import deque

    from keystone_tpu_torch.core.staging import tune_active
    from keystone_tpu_torch.observe import spans as _spans

    if workers is None:
        workers_fn: Callable[[], int] = _live_workers
    elif callable(workers):
        workers_fn = workers
    else:
        fixed = max(int(workers), 1)

        def workers_fn() -> int:
            return fixed

    tuner = tune_active()
    span_log = _spans.active_span_log() if span_name else None
    parent_ctx = _spans.current() if span_log is not None else None

    def gen() -> Iterator[Any]:
        ex = concurrent.futures.ThreadPoolExecutor(max_workers=max(pool, 1))
        it = iter(items)
        pending: deque = deque()
        exhausted = False

        def refill() -> None:
            # the knob is polled here, so a retuned worker count takes
            # effect at the next refill
            nonlocal exhausted
            target = max(1, min(int(workers_fn()), pool))
            while not exhausted and len(pending) < target:
                try:
                    item = next(it)
                except StopIteration:
                    exhausted = True
                    return
                pending.append(ex.submit(fn, item))

        try:
            refill()
            while pending:
                fut = pending.popleft()
                t0 = time.perf_counter()
                result = fut.result()  # re-raises fn's exception in order
                waited = time.perf_counter() - t0
                if tuner is not None:
                    tuner.observe(bucket="wait_host", wall_s=waited, rows=1)
                if span_log is not None and waited > 1e-3:
                    span_log.record_span(
                        span_name, wall_s=waited, bucket="wait_host", parent=parent_ctx
                    )
                refill()
                yield result
        finally:
            for fut in pending:
                fut.cancel()
            ex.shutdown(wait=False)

    return gen()


def iter_tar_image_batches(
    paths: list[str] | str,
    *,
    batch_size: int = 512,
    target_size: int | None = 256,
    workers: int | None = None,
    name_prefix: str | None = None,
    process_index: int = 0,
    process_count: int = 1,
    label_of: Callable[[str], int] | None = None,
) -> Iterator[tuple[list[str], np.ndarray, np.ndarray | None]]:
    """Yield ``(names, images (B, S, S, 3), labels | None)`` batches.

    Only ``batch_size`` compressed entries and their decoded pixels are
    alive at once. ``label_of`` maps an entry name to an int label;
    entries mapping to a negative label are skipped (the eager loaders'
    unmapped-image drop). A dead archive is skipped with one warning and
    an ``ingest_archives_skipped`` count; an undecodable image counts
    under ``ingest_decode_failures``. Decode runs through
    :func:`ingest_frontier`; batch boundaries fall every ``batch_size``
    tar ENTRIES, decode failures then dropped."""
    if isinstance(paths, str):
        paths = _expand(paths, ".tar")
    paths = list(paths)[process_index::process_count]

    def entries() -> Iterator[tuple[str, bytes, int]]:
        for p in paths:
            for name, data in _iter_tar_images(p):
                if name_prefix is not None and not name.startswith(name_prefix):
                    continue
                lab = label_of(name) if label_of else 0
                if label_of and lab < 0:
                    continue
                yield (name, data, lab)

    def decode_one(entry):
        name, data, lab = entry
        try:
            return name, decode_image(data, target_size), lab
        except Exception as e:  # noqa: BLE001 — PIL raises various types
            _logger().warning("failed to decode %s: %s", name, e)
            _count_decode_failure("streaming")
            return name, None, lab

    names: list[str] = []
    imgs: list[np.ndarray] = []
    labels: list[int] = []
    seen = 0

    def assemble():
        out = (list(names), np.stack(imgs), np.asarray(labels, np.int32) if label_of else None)
        names.clear()
        imgs.clear()
        labels.clear()
        return out

    decoded = ingest_frontier(entries(), decode_one, workers=workers, span_name=None)
    try:
        for name, img, lab in decoded:
            seen += 1
            if img is not None:
                names.append(name)
                imgs.append(img)
                labels.append(lab)
            if seen >= batch_size:
                seen = 0
                if imgs:
                    yield assemble()
        if imgs:
            yield assemble()
    finally:
        decoded.close()


class ColumnReservoir:
    """Uniform reservoir sample of up to ``capacity`` rows of a stream.

    Acceptance is drawn a batch at a time (within-batch collisions make
    it approximately uniform, which is all the PCA and GMM sampling
    needs). The draws follow the JAX package's numpy order, so both
    packages keep the same rows for the same seed and stream."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = int(capacity)
        self.rng = np.random.default_rng(seed)
        self.buf: np.ndarray | None = None
        self.seen = 0
        self.filled = 0

    def add(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows)
        if rows.ndim != 2 or len(rows) == 0:
            return
        if self.buf is None:
            self.buf = np.empty((self.capacity, rows.shape[1]), rows.dtype)
        take = min(self.capacity - self.filled, len(rows))
        if take > 0:
            self.buf[self.filled : self.filled + take] = rows[:take]
            self.filled += take
            self.seen += take
            rows = rows[take:]
        if len(rows) == 0:
            return
        idx = self.rng.integers(0, self.seen + np.arange(1, len(rows) + 1))
        keep = idx < self.capacity
        self.buf[idx[keep]] = rows[keep]
        self.seen += len(rows)

    def sample(self) -> np.ndarray:
        if self.buf is None:
            return np.zeros((0, 0), np.float32)
        return self.buf[: self.filled]


def prefetch_batches(batches: Iterable, depth: int = 2) -> Iterator:
    """Run a batch producer on a background thread with a bounded queue
    (``depth`` batches in flight), so host decode of batch k+1 overlaps
    the device's work on batch k. Producer exceptions re-raise at the
    consumer; closing the generator retires the producer."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    end = object()
    stop = threading.Event()  # the consumer is gone: unblock the producer

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not put(b):
                    return
            put(end)
        except BaseException as e:  # noqa: BLE001 — re-raised at the consumer
            put(e)

    threading.Thread(target=worker, daemon=True).start()

    def gen():
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    return gen()


def featurize_stream(
    batches: Iterable[np.ndarray],
    fn: Callable,
    *,
    chunk_size: int,
    device=None,
    mesh=None,
    prefetch: int = 2,
    stage_depth: int | None = None,
) -> np.ndarray:
    """Apply a featurizer to a stream of host batches on ``device`` (the
    card unless the caller asks for the CPU; with a ``mesh``, its data
    device, as :func:`~keystone_tpu_torch.parallel.mesh.shard_batch`
    places a batch).

    Every chunk is zero-padded to one static row count (``chunk_size``,
    rounded up to a multiple of the mesh's data axis) and its pad rows
    are dropped from the output. Chunks go through the staging engine
    (:func:`keystone_tpu_torch.core.staging.run_staged`): chunk k+1's
    copy overlaps chunk k's compute. ``prefetch`` bounds the outputs
    left on the device before they are copied to the host (0 copies
    each at once). Only the features are kept, on the host."""
    from collections import deque

    from keystone_tpu_torch.core.batching import pad_to_chunk
    from keystone_tpu_torch.core.runtime import resolve_device
    from keystone_tpu_torch.core.staging import run_staged

    target = chunk_size
    if mesh is not None:
        from keystone_tpu_torch.parallel.mesh import data_sharding, shard_chunk_size

        target = shard_chunk_size(chunk_size, mesh)
        device = data_sharding(mesh)
    device = resolve_device(device)

    def chunks():
        # step by the (mesh-rounded) target: fewer, fuller chunks
        for batch in batches:
            for start in range(0, len(batch), target):
                yield pad_to_chunk(np.asarray(batch[start : start + target]), target)

    outs: list[np.ndarray] = []
    on_device: deque = deque()
    for out in run_staged(chunks(), fn, device, stage_depth=stage_depth):
        on_device.append(out)
        while len(on_device) > prefetch:
            outs.append(on_device.popleft().cpu().numpy())
    outs.extend(o.cpu().numpy() for o in on_device)
    if not outs:
        return np.zeros((0, 0), np.float32)
    return np.concatenate(outs, axis=0)


def _logger():
    from keystone_tpu_torch.core.logging import get_logger

    return get_logger("keystone_tpu_torch.loaders.streaming")
