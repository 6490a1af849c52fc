"""Plan-aware executor — port of ``keystone_tpu/plan/executor.py``.

- :func:`run_plan` runs a plan on its device: the chain is cut into
  segments at materialization points (planner-chosen cache points and
  explicit ``Cacher`` nodes); a segment runs in chunks through the
  staging engine when the plan chose a chunk size and the segment maps
  rows to rows (checked once per segment on a 1-row probe, memoized on
  the plan node); at each cache point the intermediate is waited for,
  and the previous segment's dead intermediate is released at once. A
  multi-branch plan runs the shared prefix once and fans its output out
  to every branch, or recomputes it per branch when the budget refused
  the cache;
- :func:`fit_shared` — several chained estimators riding one
  featurization prefix pay for the prefix once;
- :func:`fit_stream` drives staged (data, labels) chunks through the fused
  sink's ``featurize → fit_stats_update`` step, with the int8 Gram (K1)
  when the planner chose it, and returns the accumulated state;
- :func:`serve_stream` drains a served batch larger than the biggest
  bucket through the bucket's program in staged chunks;
- :func:`shared_prefix_nodes` and :func:`apply_shared`: the per-chunk
  form of prefix sharing, one prefix apply feeding several branches.

Over a mesh whose data axis spans processes (``plan.shard``), each
process runs the plan on the row block of its data position of the
padded global batch (:func:`_stage_input`), on its own card, and an apply
returns a :class:`~keystone_tpu_torch.parallel.multihost.GlobalRows`;
:func:`fit_stream` folds this process's rows and merges the states over
the data axis's group, so every process finalizes the same model and the
model positions of one data row count its rows once.

Segments record ``plan.segment`` spans and chunked segments a
``source="plan"`` telemetry row when a sink is active; :func:`fit_stream`
counts the reference's ``plan_fused_fit*`` counters, :func:`serve_stream`
records the reference's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from keystone_tpu_torch.core.batching import apply_in_chunks, pad_to_chunk
from keystone_tpu_torch.core.pipeline import (
    Cacher,
    ChainedEstimator,
    ChainedLabelEstimator,
    FnTransformer,
    FunctionNode,
    Pipeline,
    _fit_entry,
    _guard_feats,
    node_label,
)
from keystone_tpu_torch.core.staging import fold_staged, to_device
from keystone_tpu_torch.observe import events as _events
from keystone_tpu_torch.observe import metrics as _metrics
from keystone_tpu_torch.observe import spans as _spans
from keystone_tpu_torch.observe import telemetry as _telemetry
from keystone_tpu_torch.plan.ir import Plan, PlanNode

# monotone id for chunk-stream telemetry records (steps.jsonl rows with
# source="plan": a planned pass has no train-step index to ride on)
_stream_seq = itertools.count(1)


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


def _segments(chain: list[PlanNode]) -> list[list[PlanNode]]:
    """Cut a chain at materialization points (after the flagged node)."""
    segs: list[list[PlanNode]] = [[]]
    for pn in chain:
        segs[-1].append(pn)
        if pn.materialize or isinstance(pn.op, Cacher):
            segs.append([])
    return [s for s in segs if s]


def _leaves(tree: Any) -> list:
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _free(tree: Any, keep: Any) -> None:
    """Release a dead planner-made intermediate's device memory now: each
    tensor's storage is emptied unless a ``keep`` tensor shares it (a
    pass-through segment can hand the same storage on)."""
    kept = {t.untyped_storage().data_ptr() for t in _leaves(keep) if isinstance(t, torch.Tensor)}
    for t in _leaves(tree):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            storage = t.untyped_storage()
            if storage.data_ptr() not in kept:
                storage.resize_(0)


def _wait(tree: Any) -> Any:
    """The ``Cacher`` semantic: wait for the devices holding ``tree``."""
    for device in {t.device for t in _leaves(tree) if isinstance(t, torch.Tensor)}:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return tree


def _run_chain(chain: list[PlanNode], data: Any, plan: Plan, *, own_input: bool = False) -> Any:
    """Execute one chain segment by segment, chunked where the plan chose
    a chunk size. ``own_input`` marks ``data`` as a planner-made
    intermediate that may be released once consumed."""
    reg = _metrics.get_registry()
    span_log = _spans.active_span_log()
    out = data
    owned = own_input
    for seg in _segments(chain):
        seg_pipe = Pipeline(nodes=tuple(pn.op for pn in seg))
        prev = out
        chunk_ok = False
        if (
            plan.chunk_size is not None
            and isinstance(out, (np.ndarray, torch.Tensor))
            and all(_chunkable_node(pn.op) for pn in seg)
        ):
            # a plan is static: the 1-row probe runs once per segment head
            chunk_ok = getattr(seg[0], "_chunk_probe_ok", None)
            if chunk_ok is None:
                chunk_ok = _row_indexed_output(seg_pipe, out, plan.device)
                seg[0]._chunk_probe_ok = chunk_ok
        with _spans.span(
            "plan.segment",
            log=span_log,
            bucket=None if chunk_ok else "compute",
            nodes=len(seg),
            chunked=bool(chunk_ok),
            head=seg[0].label,
        ):
            out = _exec_segment(seg, seg_pipe, out, plan, chunk_ok, reg)
        if seg[-1].materialize or isinstance(seg[-1].op, Cacher):
            with _spans.span("plan.materialize", log=span_log, bucket="wait_device"):
                out = _wait(out)
        reg.counter("plan_segments_executed").inc()
        if owned:
            _free(prev, keep=out)
        owned = True
    return out


def _rank_chunk(plan: Plan) -> int | None:
    """The rows of one chunk that one process runs: a sharded plan's
    chunk is split over the data axis."""
    if plan.chunk_size is None or not plan.shard:
        return plan.chunk_size
    from keystone_tpu_torch.parallel.mesh import data_axis_size

    return max(plan.chunk_size // data_axis_size(plan.mesh), 1)


def _stage_input(plan: Plan, data: Any):
    """This process's row block of the global batch for a sharded plan,
    as a ``GlobalRows`` (its rows stay where they were: the segments
    stage them onto this process's card), else ``data`` as it is.

    The batch is padded to a multiple of the data axis. Padding is legal
    only when every node is row-wise (the ``_chunkable_node`` contract: a
    whole-dataset ``FunctionNode`` would see the pad rows); an indivisible
    batch over a chain that is not row-wise runs whole on every process,
    with the refusal counted."""
    if not plan.shard or plan.mesh is None:
        return data
    if not isinstance(data, (np.ndarray, torch.Tensor)) or data.ndim < 1:
        return data
    from keystone_tpu_torch.parallel.mesh import data_axis_size, data_group, local_block
    from keystone_tpu_torch.parallel.multihost import GlobalRows

    reg = _metrics.get_registry()
    n_data = data_axis_size(plan.mesh)
    n = int(data.shape[0])
    if n % n_data:
        chains = [plan.prefix, *plan.branches]
        if not all(_chunkable_node(pn.op) for chain in chains for pn in chain):
            reg.counter("plan_shard_refused").inc()
            return data
        reg.counter("plan_shard_pad_rows").inc(-n % n_data)
    block, lo = local_block(data, plan.mesh)
    reg.counter("plan_shard_dispatches").inc()
    return GlobalRows(block, n, lo, data_group(plan.mesh))


def _exec_segment(seg, seg_pipe: Pipeline, data: Any, plan: Plan, chunk_ok: bool, reg) -> Any:
    """Execute one segment body, chunked or whole."""
    if not chunk_ok:
        return seg_pipe(to_device(data, plan.device))
    steplog = _telemetry.active_step_log()
    t0 = time.perf_counter()
    chunk = _rank_chunk(plan)
    out = apply_in_chunks(
        seg_pipe, data, chunk, plan.device, stage_depth=plan.stage_depth
    )
    reg.counter("plan_chunked_executions").inc()
    if steplog is not None:
        reg.gauge("plan_stage_depth").set(float(plan.stage_depth))
        wall = time.perf_counter() - t0
        rows = int(data.shape[0])
        flops = sum(pn.cost.flops for pn in seg) * rows
        steplog.step(
            step=next(_stream_seq),
            source="plan",
            wall_s=wall,
            flops=flops or None,
            rows=rows,
            rows_per_s=round(rows / wall, 3) if wall else None,
            chunks=-(-rows // chunk) if rows else 0,
            chunk_size=chunk,
            stage_depth=plan.stage_depth,
        )
    return out


def run_plan(plan: Plan, data: Any) -> Any:
    """Execute a plan on ``data`` (host or device rows) on the plan's
    device. A single-chain plan returns the chain's output; a
    multi-branch plan returns one output per branch. A sharded plan runs
    this process's row block and returns ``GlobalRows`` outputs."""
    staged = _stage_input(plan, data)
    if staged is data:
        return _run_plan_rows(plan, data)
    out = _run_plan_rows(plan, staged.local)
    if isinstance(out, list):
        return [dataclasses.replace(staged, local=o) for o in out]
    return dataclasses.replace(staged, local=out)


def _run_plan_rows(plan: Plan, data: Any) -> Any:
    if not plan.branches:
        return _run_chain(plan.prefix, data, plan)
    if plan.share_prefix and plan.prefix:
        feats = _wait(_run_chain(plan.prefix, data, plan))
        # the unit is one planned apply that shared its prefix; the
        # corpus-level passes-saved count belongs to the caller
        _metrics.get_registry().counter("plan_shared_prefix_applies").inc()
        outs = [_run_chain(b, feats, plan) for b in plan.branches]
        _free(feats, keep=outs)
        return outs
    return [_run_chain(plan.prefix + branch, data, plan) for branch in plan.branches]


def fit_shared(
    chains: Sequence[ChainedEstimator | ChainedLabelEstimator],
    data: Any,
    labels: Any = None,
    *,
    device: torch.device,
    budget_bytes: int | None = None,
    sample: Any | None = None,
    **kw: Any,
) -> list[Pipeline]:
    """Fit several chained estimators that share a featurization prefix,
    paying for the shared prefix ONCE (e.g. one featurizer bank feeding
    two solvers). Returns one fitted ``Pipeline`` per chain, in order,
    each what ``chain.fit(...)`` would have produced.

    The shared prefix is the longest common run of node objects across
    the chains' prefixes (object identity — share nodes to share work).
    Whether the shared intermediate is materialized is a budget decision
    (:func:`keystone_tpu_torch.plan.passes.choose_materialization`, priced
    at the fit's rows); when the budget refuses it, every chain fits the
    naive way. ``data`` and ``labels`` go to ``device`` (the card unless
    the caller asks for the CPU)."""
    from keystone_tpu_torch.plan import _assemble_fit_plan

    chains = list(chains)
    if not chains:
        return []
    data = to_device(data, device)
    if isinstance(labels, (np.ndarray, torch.Tensor)):
        labels = to_device(labels, device)
    plan, shared_nodes = _assemble_fit_plan(
        chains,
        device=device,
        sample=sample,
        budget_bytes=budget_bytes,
        # residency is priced at the real fit size: the shared
        # intermediate lives for the whole multi-branch fit
        n_rows=_exec_rows(data),
    )
    if not shared_nodes or not plan.share_prefix:
        return [_fit_one(c, data, labels, **kw) for c in chains]

    reg = _metrics.get_registry()
    data = _fit_entry(data)
    shared_pipe = Pipeline(nodes=tuple(shared_nodes))
    with _node_span(node_label(shared_pipe), "apply"):
        feats = _wait(_run_chain(plan.prefix, data, plan))
    _guard_feats(node_label(shared_pipe), feats)
    reg.counter("plan_prefix_shared").inc()
    reg.counter("plan_featurize_passes_saved").inc(len(chains) - 1)

    fitted: list[Pipeline] = []
    for chain in chains:
        rest = _prefix_nodes(chain)[len(shared_nodes) :]
        branch_feats = feats
        if rest:
            branch_feats = Pipeline(nodes=tuple(rest))(feats)
        with _node_span(node_label(chain.est), "fit"):
            if isinstance(chain, ChainedLabelEstimator):
                model = chain.est.fit(branch_feats, labels, **kw)
            else:
                model = chain.est.fit(branch_feats, **kw)
        fitted.append(Pipeline.of(chain.prefix, model))
    return fitted


def _exec_rows(data: Any) -> int:
    from keystone_tpu_torch.plan.costs import _rows

    return _rows(data)


def _fit_one(chain, data, labels, **kw):
    if isinstance(chain, ChainedLabelEstimator):
        return chain.fit(data, labels, **kw)
    return chain.fit(data, **kw)


def _node_span(name: str, phase: str):
    """Per-node observation bracket: a null context when no event sink is
    active (one global read), else the sink's event-emitting timer."""
    log = _events.active()
    if log is None:
        return contextlib.nullcontext()
    return log.node(name, phase)


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
    ``plan_shared_prefix_applies``. Over a mesh across processes, each
    process runs its row block of the padded batch (each chunk split over
    the data axis) and gets ``GlobalRows`` outputs."""
    from keystone_tpu_torch.core.runtime import resolve_device
    from keystone_tpu_torch.core.staging import run_staged

    target = chunk_size
    rows = None
    if mesh is not None:
        from keystone_tpu_torch.parallel import multihost
        from keystone_tpu_torch.parallel.mesh import (
            data_axis_size,
            data_group,
            data_sharding,
            local_block,
            shard_chunk_size,
        )

        target = shard_chunk_size(chunk_size, mesh)
        device = data_sharding(mesh)
        if mesh.spans_processes:
            n = int(data.shape[0])
            data, lo = local_block(data, mesh)
            rows, target = (n, lo, data_group(mesh)), target // data_axis_size(mesh)
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
    outs = [torch.cat([chunk[j] for chunk in per_chunk], dim=0) for j in range(len(branch_fns))]
    if rows is not None:
        return [multihost.GlobalRows(o, *rows) for o in outs]
    return outs


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
    ``plan_fused_fit_rows`` counter advances by exactly the new rows).

    A sharded plan folds the row block of this process's data position of
    ``data`` (the global batch, the same on every process), in chunks of
    its share of the plan's chunk, and merges the states over the data
    axis's group in data order: every process returns the same state, and
    the model positions of one data row count its rows once.
    ``init_state`` is then the global state so far, and only data
    position 0 seeds the fold with it."""
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
    if plan.shard:
        from keystone_tpu_torch.parallel import multihost
        from keystone_tpu_torch.parallel.mesh import data_axis_size, local_position

        rank = local_position(plan.mesh)
        lo, hi = multihost.row_block(n, rank, data_axis_size(plan.mesh))
        lo, hi = min(lo, n), min(hi, n)
        data, labels, n, n_ok = data[lo:hi], labels[lo:hi], hi - lo, max(0, min(n_ok - lo, hi - lo))
        if init_state is not None and rank != 0:
            init_state = None
    chunk = int(_rank_chunk(plan) or n or 1)

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
    if plan.shard:
        from keystone_tpu_torch.learn.merge import merge_over_group
        from keystone_tpu_torch.parallel.mesh import data_group

        state = merge_over_group(state, data_group(plan.mesh))
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
