"""Serving export: a fitted pipeline made ready for serving, before
traffic — port of ``keystone_tpu/serve/export.py``.

A server must not pay the first call's set-up on its first request, nor
the host's cost of issuing every operator of the apply on every request.
The exported form fixes both:

- the fitted pipeline runs through the planner's operator-selection
  pass (``plan/``), so the served program is the optimized one,
- on the card the apply is captured **ahead of time** as one CUDA graph
  per batch *bucket* — the counterpart of the JAX package's AOT
  executables: a static (bucket, ...) input buffer, the apply recorded
  once, replayed per request. Requests pad to the nearest bucket, so
  every request size maps to an existing graph. On the CPU the apply
  runs eagerly.

A capture may run while the server serves: a hot swap captures the
candidate's buckets while the batcher's thread replays the incumbent's
graphs and copies results to the host, and the shadow scores on a thread
of its own. In CUDA's default ``global`` capture mode a synchronizing or
allocating call from any other thread during the capture fails the
capture ("operation not permitted when stream is capturing") or the
other thread's call. So each bucket is captured in ``thread_local`` mode,
which forbids those calls only to the capturing thread, into a memory
pool of the candidate's own: the incumbent keeps serving, unstalled,
until the commit. Other threads must not touch the capturing stream, so
the capture runs on a stream from PyTorch's high-priority stream pool:
the serving path takes its side streams (the staging engine's copy
stream, a warm-up's stream) from the default-priority pool, and a
round-robin pool stream shared with a capture turns another thread's
copies and events into the capture's ("operation not permitted on an
event last recorded in a capturing stream"). A retired model's graphs
are dropped by :meth:`ExportedApply.release` on the swapper's thread
once its batcher has drained, so two models' graphs are resident only
across a swap.

``export_pipeline`` takes a fitted pipeline object or a ``save_fitted``
/ ``save_pipeline`` checkpoint path.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.core.pipeline import Pipeline, Transformer
from keystone_tpu_torch.core.runtime import resolve_device
from keystone_tpu_torch.core.staging import tree_map
from keystone_tpu_torch.observe import metrics as _metrics
from keystone_tpu_torch.serve.queue import buckets_from_env

logger = get_logger("keystone_tpu_torch.serve.export")


def side_stream_warmup(fn, device: torch.device) -> None:
    """Run ``fn`` once eagerly on a side stream, as PyTorch asks before a
    capture: it builds and caches what later calls reuse (the kernels'
    launch plans, library handles, cached constant tensors), so nothing
    cached is made inside a graph's private memory."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)


class ExportedApply:
    """A fitted pipeline made ready to serve over fixed batch buckets.

    ``__call__`` pads a (n, ...) batch up to the smallest bucket, replays
    that bucket's graph (on the CPU: runs the apply), and trims back to n
    rows; a batch larger than the biggest bucket streams through it in
    bucket-size chunks. A replay the graph refuses falls back to an eager
    call on the same device (counted — the serving panel shows
    ``serve_aot_fallback`` if it ever happens in steady state).
    """

    def __init__(
        self,
        pipe: Transformer,
        sample,
        *,
        buckets: Sequence[int] | None = None,
        optimize: bool = True,
        compile_now: bool = True,
        device: torch.device | str | None = None,
    ):
        sample = np.asarray(sample)
        if sample.ndim < 1 or sample.shape[0] < 1:
            raise ValueError(
                f"sample shape {sample.shape}: need a (n, ...) batch probe"
            )
        self.row_shape = tuple(sample.shape[1:])
        self.dtype = sample.dtype
        self.buckets = tuple(sorted(buckets or buckets_from_env()))
        if not self.buckets or any(b <= 0 for b in self.buckets):
            raise ValueError(f"buckets={self.buckets}: need positive sizes")
        self.device = resolve_device(device)
        self.plan = None
        if optimize:
            # the KeystoneML operator-selection pass: the plan's rewrite
            # rules choose the physical operators the server will run
            from keystone_tpu_torch import plan as plan_mod

            self.plan = plan_mod.plan_pipeline(pipe, sample=sample, device=self.device)
            pipe = self.plan.pipeline()
        self.pipe = pipe
        # bucket → (graph, static input, static output); one memory pool
        # for all of them (each graph's output stays referenced here, so
        # no capture reuses another's output)
        self._graphs: dict[int, tuple] = {}
        self._pool = None
        self._replay_lock = threading.Lock()
        self.cold_start_s = 0.0
        if compile_now:
            self.compile()

    def compile(self) -> float:
        """Capture one graph per bucket on the card (idempotent; nothing
        to capture on the CPU). Returns the wall seconds it took. A
        capture that fails raises."""
        t0 = time.perf_counter()
        reg = _metrics.get_registry()
        if self.device.type == "cuda":
            for b in self.buckets:
                if b in self._graphs:
                    continue
                self._graphs[b] = self._capture(b)
                reg.counter("serve_aot_compiled", kind="pipeline").inc()
        self.cold_start_s = time.perf_counter() - t0
        logger.info(
            "exported apply: %d bucket graph(s) %s in %.2fs on %s",
            len(self._graphs),
            list(self.buckets),
            self.cold_start_s,
            self.device,
        )
        return self.cold_start_s

    @torch.inference_mode()
    def _capture(self, b: int) -> tuple:
        dtype = torch.from_numpy(np.zeros(0, self.dtype)).dtype
        static = torch.zeros((b, *self.row_shape), dtype=dtype, device=self.device)
        side_stream_warmup(lambda: self.pipe(static), self.device)
        graph = torch.cuda.CUDAGraph()
        capture_stream = torch.cuda.Stream(self.device, priority=-1)
        with torch.cuda.graph(graph, pool=self._pool, stream=capture_stream,
                              capture_error_mode="thread_local"):
            out = self.pipe(static)
        self._pool = graph.pool()
        return graph, static, out

    def release(self) -> None:
        """Drop the bucket graphs, their outputs and their memory pool now,
        on the calling thread: a model retired by a swap, once its batcher
        has drained (not whenever the garbage collector reaches it)."""
        with self._replay_lock:
            self._graphs.clear()
            self._pool = None

    # ------------------------------------------------------------- apply

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    @torch.inference_mode()
    def _run_bucket(self, batch: torch.Tensor) -> Any:
        """Run one exactly-bucket-sized batch (host or device rows)
        through its graph (fallback: the eager apply on the same
        device). The result is the caller's own copy: the next replay
        overwrites the graph's output."""
        b = batch.shape[0]
        entry = self._graphs.get(b)
        if entry is not None:
            graph, static, out = entry
            try:
                with self._replay_lock:
                    static.copy_(batch)
                    graph.replay()
                    return tree_map(torch.clone, out)
            except RuntimeError as e:
                # a refused replay (a row the static buffer can't take)
                # must degrade, not 500
                _metrics.get_registry().counter("serve_aot_fallback").inc()
                logger.warning(
                    "bucket %d graph refused the batch (%r); eager fallback", b, e
                )
        return self.pipe(batch.to(self.device))

    def __call__(self, rows) -> Any:
        """(n, ...) rows → row-indexed outputs on the device, any n >= 1."""
        rows = np.asarray(rows)
        if rows.shape[1:] != self.row_shape:
            raise ValueError(
                f"request row shape {rows.shape[1:]} != exported "
                f"{self.row_shape}"
            )
        rows = rows.astype(self.dtype, copy=False)
        n = rows.shape[0]
        cap = self.buckets[-1]
        if n > cap:
            # oversized batch: stream exactly-cap-sized chunks through
            # the largest bucket via the plan executor's staged drain
            # (transfer of chunk k+1 overlaps dispatch k)
            from keystone_tpu_torch.plan.executor import serve_stream

            return serve_stream(self._run_bucket, rows, cap, self.device)
        bucket = self._bucket_for(n)
        padded = rows
        if n < bucket:
            padded = np.concatenate(
                [rows, np.zeros((bucket - n, *self.row_shape), self.dtype)],
                axis=0,
            )
        out = self._run_bucket(torch.from_numpy(padded))
        if n == bucket:
            return out
        return tree_map(lambda a: a[:n], out)


def export_pipeline(
    pipe_or_path: Transformer | str,
    sample,
    *,
    buckets: Sequence[int] | None = None,
    optimize: bool = True,
    device: torch.device | str | None = None,
) -> ExportedApply:
    """Export a fitted pipeline (an object, or a ``save_fitted`` /
    ``save_pipeline`` checkpoint path) as a serving apply on ``device``
    (the card unless the caller asks for the CPU)."""
    if isinstance(pipe_or_path, str):
        from keystone_tpu_torch.core.serialization import load_pipeline

        pipe_or_path = load_pipeline(pipe_or_path, device=resolve_device(device))
    if not isinstance(pipe_or_path, Transformer):
        pipe_or_path = Pipeline.of(pipe_or_path)
    return ExportedApply(
        pipe_or_path, sample, buckets=buckets, optimize=optimize, device=device
    )


def export_lm(
    model,
    *,
    slots: int = 8,
    s_max: int = 512,
    quantize: bool = False,
    int8_kv: bool = False,
    warm: bool = True,
    **loop_kw: Any,
):
    """Export an LM for continuous-batching serve: optional weight-only
    int8 (through K4 on the card) and int8 KV cache — the
    decode-bandwidth levers — a
    :class:`~keystone_tpu_torch.serve.decode_loop.DecodeLoop` slot pool,
    and, with ``warm=True``, every program made ready up front (on the
    card: captured as CUDA graphs)."""
    from keystone_tpu_torch.serve.decode_loop import DecodeLoop

    if quantize:
        from keystone_tpu_torch.models.lm.decode import quantize_for_decode

        model = quantize_for_decode(model)
        if model.device.type == "cuda":
            model = model.replace(int8_kernel="kernel")
    loop = DecodeLoop(
        model,
        slots=slots,
        s_max=s_max,
        kv_dtype="int8" if int8_kv else None,
        **loop_kw,
    )
    if warm:
        loop.warm()
    return loop
