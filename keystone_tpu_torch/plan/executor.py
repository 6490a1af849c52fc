"""Plan-aware executor — port of ``keystone_tpu/plan/executor.py``'s apply
pass (:func:`run_plan`) and fused streaming fit (:func:`fit_stream`).

- :func:`run_plan` runs the planned chain on the plan's device, in chunks
  through the staging engine when the plan chose a chunk size and the
  chain maps rows to rows;
- :func:`fit_stream` drives staged (data, labels) chunks through the fused
  sink's ``featurize → fit_stats_update`` step, with the int8 Gram (K1)
  when the planner chose it, and returns the accumulated state;
- :func:`serve_stream` drains a served batch larger than the biggest
  bucket through the bucket's program in staged chunks;
- :func:`shared_prefix_nodes` and :func:`apply_shared`: the per-chunk
  form of prefix sharing, one prefix apply feeding several branches.

The spans and telemetry rows of the JAX executor's apply and fit passes
are not wired yet; ``plan.decisions`` keep the record. :func:`fit_stream`
counts the reference's ``plan_fused_fit*`` counters, :func:`serve_stream`
records the reference's.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from keystone_tpu_torch.core.batching import apply_in_chunks, pad_to_chunk
from keystone_tpu_torch.core.pipeline import (
    FnTransformer,
    FunctionNode,
    Pipeline,
)
from keystone_tpu_torch.core.staging import fold_staged, to_device
from keystone_tpu_torch.observe import metrics as _metrics
from keystone_tpu_torch.observe import spans as _spans
from keystone_tpu_torch.observe import telemetry as _telemetry
from keystone_tpu_torch.plan.ir import Plan


def _chunkable_node(node: Any) -> bool:
    """Transformers are row-wise by contract; FunctionNode lifts are the
    escape hatch for whole-dataset ops and must never be chunked."""
    if isinstance(node, FnTransformer) and isinstance(node.fn, FunctionNode):
        return False
    return not isinstance(node, FunctionNode)


def _row_indexed_output(pipe: Pipeline, data: Any, device: torch.device) -> bool:
    """True when the chain maps a batch to a row-indexed TENSOR — the
    shape chunked application can pad, trim and concatenate (a featurizer
    bank's list of blocks is not). Checked on a 1-row probe."""
    out = pipe(to_device(data[:1], device))
    return isinstance(out, torch.Tensor) and out.ndim >= 1 and out.shape[0] == 1


def run_plan(plan: Plan, data: Any) -> Any:
    """Execute a plan on ``data`` (host or device rows) on the plan's
    device, chunked when the plan chose a chunk size."""
    pipe = plan.pipeline()
    ops = pipe.nodes
    chunked = (
        plan.chunk_size is not None
        and isinstance(data, (np.ndarray, torch.Tensor))
        and all(_chunkable_node(op) for op in ops)
        and _row_indexed_output(pipe, data, plan.device)
    )
    if not chunked:
        return pipe(to_device(data, plan.device))
    return apply_in_chunks(
        pipe, data, plan.chunk_size, plan.device, stage_depth=plan.stage_depth
    )


def _prefix_nodes(chain) -> list[Any]:
    prefix = chain.prefix
    if isinstance(prefix, Pipeline):
        return list(prefix.nodes)
    return [prefix]


def shared_prefix_nodes(chains: Sequence[Any]) -> list[Any]:
    """The longest common (by object identity) leading node run across
    the chains' prefixes."""
    node_lists = [_prefix_nodes(c) for c in chains]
    shared: list[Any] = []
    for nodes in zip(*node_lists):
        if all(n is nodes[0] for n in nodes):
            shared.append(nodes[0])
        else:
            break
    return shared


def apply_shared(
    prefix_fn: Callable,
    branch_fns: Sequence[Callable],
    data,
    *,
    chunk_size: int,
    device=None,
    mesh: Any = None,
    stage_depth: int | None = None,
) -> list:
    """Chunked shared-prefix apply: for each fixed-size chunk run
    ``prefix_fn`` ONCE and feed its output to every branch (e.g.
    pixel-scaled images feeding both the SIFT and the LCS branch), so the
    shared intermediate never materializes corpus-wide. Returns one
    concatenated output per branch, on the device. Chunks go through the
    staging engine on ``device`` (the card unless the caller asks for
    the CPU; with a ``mesh``, its data device, the chunk rounded up to
    its data axis). Each call with more than one branch counts
    ``plan_shared_prefix_applies``."""
    from keystone_tpu_torch.core.runtime import resolve_device
    from keystone_tpu_torch.core.staging import run_staged

    target = chunk_size
    if mesh is not None:
        from keystone_tpu_torch.parallel.mesh import data_sharding, shard_chunk_size

        target = shard_chunk_size(chunk_size, mesh)
        device = data_sharding(mesh)
    device = resolve_device(device)

    def chunks():
        for start in range(0, data.shape[0], target):
            yield pad_to_chunk(data[start : start + target], target)

    def all_branches(chunk):
        shared = prefix_fn(chunk)
        return tuple(fn(shared) for fn in branch_fns)

    per_chunk = list(run_staged(chunks(), all_branches, device, stage_depth=stage_depth))
    if len(branch_fns) > 1:
        # the unit is one chunked apply that shared a prefix; the
        # corpus-level passes-saved count belongs to the caller
        _metrics.get_registry().counter("plan_shared_prefix_applies").inc()
    return [torch.cat([chunk[j] for chunk in per_chunk], dim=0) for j in range(len(branch_fns))]


def fit_stream(plan: Plan, data: Any, labels: Any, *, n_valid=None, init_state=None):
    """Execute a fused streaming-fit plan: staged (data, labels) chunks go
    through the sink's ``featurize → fit_stats_update`` step on the
    staging engine (chunk k+1's transfer overlaps chunk k's accumulate);
    returns the accumulated state for ``fit_stats_finalize``. Pad rows
    (the ragged tail) are masked out of the statistics via each chunk's
    ``n_valid``.

    ``init_state`` seeds the fold with previously accumulated statistics
    instead of a zero state — the online-learning verb
    (:mod:`keystone_tpu_torch.learn`): a refit folds only the new chunks,
    so rows already inside the state are never featurized again (the
    ``plan_fused_fit_rows`` counter advances by exactly the new rows)."""
    from keystone_tpu_torch.ops.linear import _matmul_precision
    from keystone_tpu_torch.plan.fused_fit import StreamingFitSink

    if (
        plan.fit is None
        or not plan.fit.fused
        or len(plan.prefix) != 1
        or not isinstance(plan.prefix[-1].op, StreamingFitSink)
    ):
        raise ValueError("fit_stream needs a fully fused streaming-fit plan")
    sink = plan.prefix[-1].op
    est = sink.est
    prefix_pipe = Pipeline(nodes=tuple(sink.prefix))
    gram_fn = None
    if sink.gram == "int8":
        from keystone_tpu_torch.ops.gram import ata_int8

        gram_fn = ata_int8

    n = int(data.shape[0])
    n_ok = int(n_valid) if n_valid is not None else n
    chunk = int(plan.chunk_size or n)

    def chunks():
        for start in range(0, n, chunk):
            a, va = pad_to_chunk(data[start : start + chunk], chunk)
            b, _ = pad_to_chunk(labels[start : start + chunk], chunk)
            yield (a, b), max(0, min(n_ok - start, va))

    def update(state, staged, valid):
        a, b = staged
        feats = prefix_pipe(a) if prefix_pipe.nodes else a
        return est.fit_stats_update(state, feats, b, n_valid=valid, gram_fn=gram_fn)

    if init_state is None:
        init_state = est.fit_stats_init(sink.d, sink.k, plan.device)
    with _matmul_precision(getattr(est, "precision", None)):
        state = fold_staged(
            chunks(), update, init_state, plan.device, stage_depth=plan.stage_depth
        )
    reg = _metrics.get_registry()
    reg.counter("plan_fused_fits").inc()
    reg.counter("plan_fused_fit_chunks").inc(-(-n // chunk) if n else 0)
    reg.counter("plan_fused_fit_rows").inc(n_ok)
    return state


def serve_stream(
    dispatch: Callable,
    rows,
    bucket: int,
    device: torch.device,
    *,
    stage_depth: int | None = None,
):
    """The serving path's oversized-batch drain: a request batch larger
    than the biggest bucket streams through ``dispatch`` in
    exactly-``bucket``-sized chunks (tail zero-padded, pad rows trimmed
    — every dispatch hits the same bucket program) via the shared
    staging engine, so chunk k+1's host→device transfer overlaps chunk
    k's compute.

    Same contract as :func:`keystone_tpu_torch.core.batching.apply_in_chunks`
    (which does the work): ``dispatch`` maps a (bucket, ...) batch on
    ``device`` to a row-indexed tensor. Emits one ``source="serve"``
    stream row when a telemetry sink is active."""
    reg = _metrics.get_registry()
    steplog = _telemetry.active_step_log()
    t0 = time.perf_counter()
    # ambient span: nests under the serve.batch span when the
    # micro-batcher dispatched us
    with _spans.span(
        "serve.stream", rows=int(rows.shape[0]), bucket_size=bucket
    ):
        out = apply_in_chunks(
            dispatch, rows, bucket, device, stage_depth=stage_depth
        )
    reg.counter("serve_stream_batches").inc()
    if steplog is not None:
        wall = time.perf_counter() - t0
        n = int(rows.shape[0])
        steplog.record(
            "serve",
            rows=n,
            bucket=bucket,
            chunks=-(-n // bucket),
            batch_fill=round(n / (-(-n // bucket) * bucket), 4),
            wall_s=round(wall, 6),
            requests=1,
        )
    return out
