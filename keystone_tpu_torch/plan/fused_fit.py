"""Fused streaming normal-equations fit: the planner's solver fast path.

Port of ``keystone_tpu/plan/fused_fit.py``:

- a fit whose estimator speaks the ``fit_stats_init/update/finalize``
  protocol (:mod:`keystone_tpu_torch.ops.linear`) is planned as a
  :class:`StreamingFitSink` node at the end of its featurize chain;
- the registered ``fuse_streaming_fit`` rewrite rule folds every row-wise
  featurize node INTO the sink, so the executor drives staged chunks
  through ``featurize_chunk → accumulate_gram`` and the features never
  materialize whole;
- the Gram operator is the planner's choice: the int8 Gram (kernel K1,
  :func:`keystone_tpu_torch.ops.gram.ata_int8`) when the probe's
  quantization error clears the threshold AND the device's int8 rate beats
  fp32, or when ``KEYSTONE_GRAM_OP=int8`` asks for it — else the exact
  fp32 Gram; a ``fit_operator`` decision records it either way. The
  class-weighted solver always gets fp32 (``exact_per_class_grams``).

Entry points::

    fitted = fit_streaming(chained_label_est, x, y, n_valid=n, device=dev)
    plan   = plan_fit(chained_label_est, x, y, device=dev)   # plan only
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from keystone_tpu_torch.core.pipeline import (
    ChainedLabelEstimator,
    Pipeline,
    Transformer,
    node_label,
)
from keystone_tpu_torch.observe import metrics as _metrics
from keystone_tpu_torch.parallel.mesh import current_mesh
from keystone_tpu_torch.plan.ir import NodeCost, Plan, PlanNode
from keystone_tpu_torch.plan.passes import rewrite_rule


@dataclasses.dataclass(frozen=True)
class StreamingFitSink:
    """The plan-IR fit consumer: an estimator speaking the fit_stats
    protocol plus the row-wise featurize prefix fused into it."""

    est: Any
    d: int  # feature width the accumulated state covers
    k: int  # label width
    widths: tuple | None = None  # feature-block boundaries (bank output)
    gram: str = "fp32"  # planner-chosen Gram operator
    prefix: tuple = ()  # row-wise transformers fused in front

    @property
    def name(self) -> str:
        tail = type(self.est).__name__
        if self.prefix:
            return f"streaming_fit[{len(self.prefix)}+{tail}]"
        return f"streaming_fit[{tail}]"


@rewrite_rule("fuse_streaming_fit", window=2)
def _fuse_streaming_fit(node, sink):
    """Fold one row-wise transformer into the streaming-fit sink; the
    planner walks the rules to fixpoint, so a whole featurize prefix
    collapses into the sink one node per walk."""
    if not isinstance(sink, StreamingFitSink):
        return None
    from keystone_tpu_torch.plan.executor import _chunkable_node

    if not isinstance(node, Transformer) or not _chunkable_node(node):
        return None
    return dataclasses.replace(sink, prefix=(node,) + sink.prefix)


@dataclasses.dataclass
class FitPlanInfo:
    """What the fit planner decided — carried on ``Plan.fit``."""

    fused: bool
    reason: str = ""
    d: int = 0
    k: int = 0
    widths: tuple | None = None
    gram: str = "fp32"
    quant_error: float | None = None
    n_valid: int | None = None


def _supports_protocol(est: Any) -> bool:
    return all(
        hasattr(est, m)
        for m in ("fit_stats_init", "fit_stats_update", "fit_stats_finalize")
    )


def _feature_shape(feats: Any) -> tuple[int, tuple | None]:
    """(total width, per-block widths or None) of a featurize output."""
    if isinstance(feats, (list, tuple)):
        widths = tuple(int(b.shape[-1]) for b in feats)
        return sum(widths), widths
    return int(feats.shape[-1]), None


def _hstack_host(feats: Any) -> np.ndarray:
    if isinstance(feats, (list, tuple)):
        feats = torch.cat(list(feats), dim=-1)
    return feats.detach().cpu().numpy().astype(np.float32)


def _choose_gram(
    plan: Plan, est: Any, probe_feats: Any, requested: str | None
) -> tuple[str, float | None]:
    """Operator selection for the Gram accumulation: int8 only when the
    request (argument > ``KEYSTONE_GRAM_OP``) allows it, the estimator
    takes a ``gram_fn`` (the weighted solver's per-class Grams stay
    exact), the probe's quantization error clears the threshold, and the
    device's int8 rate actually beats fp32. Every branch records the
    same ``fit_operator`` decision shape and counts ``plan_fit_operator``."""
    from keystone_tpu_torch.ops import gram as _gram
    from keystone_tpu_torch.ops.weighted_linear import BlockWeightedLeastSquaresEstimator
    from keystone_tpu_torch.plan.costs import int8_gram_speedup

    request = (requested or _gram.gram_op_request()).lower()
    exact_only = isinstance(est, BlockWeightedLeastSquaresEstimator)
    threshold = _gram.int8_error_threshold()
    speedup = int8_gram_speedup(plan.device_kind)
    err: float | None = None
    if exact_only:
        op, reason = "fp32", "exact_per_class_grams"
    elif request == "fp32":
        op, reason = "fp32", "requested"
    else:
        # gate on the operand the operator will actually see: the update
        # quantizes CENTERED chunks
        probe = _hstack_host(probe_feats)
        err = _gram.gram_quantization_error(probe - probe.mean(axis=0))
        if request == "int8":
            op, reason = "int8", "requested"
        elif err <= threshold and speedup > 1.0:
            op, reason = "int8", "cost_model"
        elif err > threshold:
            op, reason = "fp32", "quantization_error"
        else:
            op, reason = "fp32", "no_int8_advantage"
    plan.decide(
        "fit_operator",
        op=op,
        reason=reason,
        quantization_error=round(err, 6) if err is not None else None,
        threshold=threshold,
        int8_speedup=speedup,
    )
    _metrics.get_registry().counter("plan_fit_operator", op=op).inc()
    return op, err


_DEFAULT_FIT_CHUNK = 8192


def plan_fit(
    chain: ChainedLabelEstimator,
    data: Any,
    labels: Any,
    *,
    device: torch.device,
    n_valid: int | None = None,
    chunk_size: int | None = None,
    stage_depth: int | None = None,
    budget_bytes: int | None = None,
    sample: Any | None = None,
    gram: str | None = None,
    mesh: Any = None,
) -> Plan:
    """Build the fused streaming-fit plan for a chained label fit. The plan
    either fully fuses (one :class:`StreamingFitSink` node) or records why
    it can't (``fit_fallback``) — :func:`fit_streaming` then takes the
    classic materialized path. ``mesh`` (default: the ambient mesh) splits
    the rows over the processes of a data axis that spans processes: the
    chunk is then the global one, split over the processes."""
    from keystone_tpu_torch import plan as plan_mod
    from keystone_tpu_torch.plan import costs as _costs
    from keystone_tpu_torch.plan import passes as _passes
    from keystone_tpu_torch.plan.executor import _prefix_nodes

    est = chain.est
    prefix_nodes = _prefix_nodes(chain)
    plan = Plan(
        prefix=[],
        device=device,
        budget_bytes=(
            plan_mod.default_budget_bytes(device)
            if budget_bytes is None
            else budget_bytes
        ),
        device_kind=_costs.device_kind(device),
        mesh=mesh if mesh is not None else current_mesh(),
    )
    shards = plan_mod._shards(plan)
    n_rows = _costs._rows(data)
    info = FitPlanInfo(fused=False, n_valid=n_valid)
    plan.fit = info

    if not _supports_protocol(est):
        plan.decide("fit_fallback", reason="no_fit_stats_protocol")
        _passes.emit_plan(plan)
        return plan

    probe = _costs.slice_probe(sample if sample is not None else data)
    chain_nodes = [
        PlanNode(label=node_label(node, i), op=node)
        for i, node in enumerate(prefix_nodes)
    ]
    probe_feats = _costs.sample_chain(chain_nodes, probe, device)
    unprobed = [pn.label for pn in chain_nodes if pn.cost.source == "default"]
    if unprobed:
        plan.decide("fit_fallback", reason="unprobeable_prefix", nodes=unprobed)
        _passes.emit_plan(plan)
        return plan
    d, widths = _feature_shape(probe_feats)
    k = int(labels.shape[-1])
    info.d, info.k, info.widths = d, k, widths

    # state-residency guard: the accumulated stats must themselves fit,
    # and so must what the finalize builds from them where the estimator
    # prices that (the weighted solver's per-class systems are C·d²
    # again: at ImageNet's (D, C) = (4,096, 1,000) the 67 GB state alone
    # would pass an 80 GB card, the fit would not)
    state_bytes = int(est.fit_stats_state_bytes(d, k))
    peak = getattr(est, "fit_stats_peak_bytes", None)
    peak_bytes = int(peak(d, k)) if peak is not None else state_bytes
    if peak_bytes > plan.budget_bytes:
        plan.decide(
            "fit_fallback",
            reason="state_over_budget",
            state_bytes=state_bytes,
            peak_bytes=peak_bytes,
            budget_bytes=plan.budget_bytes,
        )
        _passes.emit_plan(plan)
        return plan

    sink = StreamingFitSink(est=est, d=d, k=k, widths=widths)
    chain_nodes.append(
        PlanNode(
            label=node_label(sink, len(chain_nodes)),
            op=sink,
            # the staged f32 feature row is the chunk-sizing unit; the
            # state is constant residency, priced separately above
            cost=NodeCost(
                flops=float(est.fit_stats_flops_per_row(d, k)),
                peak_bytes=4.0 * d,
                input_bytes=4.0 * d,
                source="modeled",
            ),
        )
    )
    plan.prefix = chain_nodes
    plan.rows = _costs._rows(probe)

    # rewrite to fixpoint: each walk folds one more prefix node into the sink
    for _ in range(len(chain_nodes) + 1):
        before = len(plan.decisions)
        _passes.select_operators(plan)
        if len(plan.decisions) == before:
            break

    fused_sink = plan.prefix[-1].op if plan.prefix else None
    if len(plan.prefix) != 1 or not isinstance(fused_sink, StreamingFitSink):
        plan.decide(
            "fit_fallback",
            reason="non_rowwise_prefix",
            unfused_nodes=[pn.label for pn in plan.prefix[:-1]],
        )
        _passes.emit_plan(plan)
        return plan

    op, err = _choose_gram(plan, est, probe_feats, gram)
    fused_sink = dataclasses.replace(fused_sink, gram=op)
    plan.prefix[-1].op = fused_sink
    info.fused, info.gram, info.quant_error = True, op, err

    _passes.choose_chunk_size(plan, n_rows, requested=chunk_size, shards=shards)
    if plan.chunk_size is None and n_rows > _DEFAULT_FIT_CHUNK * shards:
        # no cost basis for a choice, but an unchunked fused fit would
        # stage the whole batch at once — bound it anyway (each process
        # takes its share of a chunk)
        plan.chunk_size = _DEFAULT_FIT_CHUNK * shards
        plan.decide("chunk", size=plan.chunk_size, source="fit_default")
    _passes.choose_staging(plan, n_rows, requested_depth=stage_depth)
    _passes.choose_sharding(plan, shards)
    plan.decide(
        "fuse_fit",
        nodes_fused=len(fused_sink.prefix),
        materialize_features=False,
        d=d,
        k=k,
        state_bytes=state_bytes,
        gram=op,
    )
    _passes.emit_plan(plan)
    return plan


def fit_streaming(
    chain: ChainedLabelEstimator,
    data: Any,
    labels: Any,
    *,
    device: torch.device,
    n_valid: int | None = None,
    return_plan: bool = False,
    **kw: Any,
):
    """Fit a chained label estimator through the planned fused streaming
    path; returns the fitted :class:`Pipeline` (the contract of
    ``chain.fit``). When the plan can't fuse — an estimator without the
    protocol, a non-row-wise prefix, a state over the memory budget — the
    classic materialized fit runs on ``device`` instead, with the
    fallback recorded as a plan decision and counted under
    ``plan_fit_materialized`` (the fused path never touches it).

    Over a mesh across processes the fallback lays the batch out as the
    reference's caller does (:func:`~keystone_tpu_torch.parallel.mesh.shard_batch`):
    each process featurizes the row block of its data position and the
    estimator's ``GlobalRows`` branch fits the global batch (the rows
    counted under ``plan_fit_materialized_rows``). An estimator without
    that branch raises ``TypeError``."""
    from keystone_tpu_torch.core.staging import to_device

    plan = plan_fit(chain, data, labels, device=device, n_valid=n_valid, **kw)
    info: FitPlanInfo = plan.fit
    if not info.fused:
        reg = _metrics.get_registry()
        reg.counter("plan_fit_materialized").inc()
        if plan.mesh is not None and plan.mesh.spans_processes:
            from keystone_tpu_torch.parallel.mesh import shard_batch

            rows = shard_batch(data, plan.mesh)
            if n_valid is not None:
                rows = dataclasses.replace(rows, n_global=min(int(n_valid), rows.n_global))
            reg.counter("plan_fit_materialized_rows").inc(rows.n_valid)
            fitted = chain.fit(rows, shard_batch(labels, plan.mesh))
        else:
            fit_kw = {} if n_valid is None else {"n_valid": n_valid}
            fitted = chain.fit(
                to_device(data, device), to_device(labels, device), **fit_kw
            )
        return (fitted, plan) if return_plan else fitted

    from keystone_tpu_torch.plan import executor as _executor

    state = _executor.fit_stream(plan, data, labels, n_valid=n_valid)
    model = chain.est.fit_stats_finalize(state, widths=info.widths)
    fitted = Pipeline.of(chain.prefix, model)
    return (fitted, plan) if return_plan else fitted
