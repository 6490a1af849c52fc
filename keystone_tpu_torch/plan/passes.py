"""Optimizer passes over the plan IR — port of
``keystone_tpu/plan/passes.py``:

- the rewrite-rule registry; :func:`rewrite_nodes` (the classic
  ``core.fusion.optimize`` path) and :func:`select_operators` (the
  planner) share one chain walk, :func:`_rewrite_chain`, so they cannot
  drift on rule order or window semantics. The conv chain's rule
  registers itself from ``core/fusion.py``, the streaming fit's
  absorption rule from ``plan/fused_fit.py``;
- :func:`choose_materialization` — greedy automatic caching: cache an
  intermediate iff ``(reuse − 1) × recompute_cost`` is positive and its
  resident bytes fit the budget, taking candidates by benefit density
  (the paper's algorithm 1, with bytes resident standing in for Spark's
  storage fraction);
- :func:`choose_chunk_size` — the largest power-of-two chunk whose
  working set fits a quarter of the memory budget;
- :func:`choose_staging` — host→device staging depth from the transfer
  vs compute estimate;
- :func:`emit_plan` — one ``optimize`` event carrying every decision.

- :func:`choose_sharding` — row blocks over a mesh whose data axis spans
  processes (one card per process).

Passes mutate only the plan and record decisions.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Sequence

from keystone_tpu_torch.core.pipeline import node_label
from keystone_tpu_torch.observe import events as _events
from keystone_tpu_torch.observe import metrics as _metrics
from keystone_tpu_torch.plan.ir import NodeCost, Plan, PlanNode


@dataclasses.dataclass(frozen=True)
class RewriteRule:
    """A window rewrite: ``fn(*nodes) -> fused node | None``."""

    name: str
    window: int
    fn: Callable[..., Any]


_RULES: list[RewriteRule] = []


def rewrite_rule(name: str, window: int):
    """Decorator registering a node-window rewrite rule. Rules are tried in
    registration order at each chain position; the first match wins."""

    def register(fn):
        _RULES.append(RewriteRule(name=name, window=window, fn=fn))
        return fn

    return register


def registered_rules() -> tuple[RewriteRule, ...]:
    _ensure_rules_loaded()
    return tuple(_RULES)


def _ensure_rules_loaded() -> None:
    # rules live with their node definitions; importing the modules here
    # (lazily, to dodge the import cycle) guarantees registration
    import keystone_tpu_torch.core.fusion  # noqa: F401
    import keystone_tpu_torch.plan.fused_fit  # noqa: F401


def rewrite_nodes(nodes: Sequence[Any]) -> tuple[list[Any], list[dict]]:
    """Slide every registered rule over a raw transformer chain. Returns
    the rewritten node list and one decision record per application. The
    chain is lifted into a throwaway plan and walked by
    :func:`_rewrite_chain`, the planner's own walk; ``plan_rewrites`` is
    not counted (the classic path counts ``fusion_rewrites`` instead)."""
    chain = [PlanNode(label=node_label(n, i), op=n) for i, n in enumerate(nodes)]
    plan = Plan(prefix=chain, budget_bytes=0)
    _rewrite_chain(plan, chain, count_metrics=False)
    return [pn.op for pn in chain], plan.decisions


def select_operators(plan: Plan) -> Plan:
    """Rewrite pass over the plan's chains: apply registered rules,
    folding each replaced window's cost into the fused node and recording
    the decision in the plan and the ``plan_rewrites`` counter."""
    for chain in [plan.prefix, *plan.branches]:
        _rewrite_chain(plan, chain)
    return plan


def _rewrite_chain(plan: Plan, chain: list[PlanNode], count_metrics: bool = True) -> None:
    i = 0
    while i < len(chain):
        applied = None
        for rule in registered_rules():
            if i + rule.window > len(chain):
                continue
            window = chain[i : i + rule.window]
            if any(pn.materialize for pn in window[:-1]):
                continue  # never fuse across a chosen cache point
            fused = rule.fn(*(pn.op for pn in window))
            if fused is not None:
                applied = (rule, window, fused)
                break
        if applied is None:
            i += 1
            continue
        rule, window, fused = applied
        walls = [pn.cost.wall_s for pn in window if pn.cost.wall_s is not None]
        cost = NodeCost(
            flops=sum(pn.cost.flops for pn in window),
            bytes_accessed=sum(pn.cost.bytes_accessed for pn in window),
            output_bytes=window[-1].cost.output_bytes,
            peak_bytes=max(pn.cost.peak_bytes for pn in window),
            input_bytes=window[0].cost.input_bytes,
            collective_bytes=sum(pn.cost.collective_bytes for pn in window),
            wall_s=sum(walls) if walls else None,
            source=window[0].cost.source,
        )
        label = node_label(fused, i)
        chain[i : i + rule.window] = [
            PlanNode(
                label=label,
                op=fused,
                cost=cost,
                reuse=window[-1].reuse,
                materialize=window[-1].materialize,
                rewritten_from=tuple(pn.label for pn in window),
            )
        ]
        plan.decide(
            "rewrite", rule=rule.name, node=label, replaced=[pn.label for pn in window]
        )
        if count_metrics:
            _metrics.get_registry().counter("plan_rewrites", rule=rule.name).inc()
        i += 1


def choose_materialization(plan: Plan, rows: int | None = None) -> Plan:
    """Greedy automatic caching under the plan's memory budget.

    A node is a candidate iff its output is reused (``reuse > 1``) — in
    practice the tail of a shared featurization prefix. Benefit is the
    recompute time the cache saves, ``(reuse − 1) ×`` recomputing the
    whole upstream chain through the node; the residency penalty is its
    output's bytes at the execution size ``rows``. Candidates are taken
    in benefit-density order while they fit the budget. Unknown costs
    count as infinite benefit: with no information, sharing a reused
    prefix beats recomputing it."""
    rows = rows or max(plan.rows, 1)
    reg = _metrics.get_registry()
    cumulative: dict[int, float] = {}
    running, any_costed = 0.0, False
    for pn in plan.prefix:
        if pn.cost.source != "default":
            any_costed = True
            running += pn.cost.recompute_s(rows, plan.device_kind)
        cumulative[id(pn)] = running
    candidates = [pn for pn in plan.prefix if pn.reuse > 1 and not pn.materialize]

    def benefit(pn: PlanNode) -> float:
        if not any_costed:
            return float("inf")
        return (pn.reuse - 1) * cumulative[id(pn)]

    def resident(pn: PlanNode) -> float:
        return pn.cost.output_bytes * rows

    candidates.sort(key=lambda pn: benefit(pn) / max(resident(pn), 1.0), reverse=True)
    spent = 0.0
    for pn in candidates:
        bytes_needed = resident(pn)
        fits = spent + bytes_needed <= plan.budget_bytes
        if fits and benefit(pn) > 0.0:
            pn.materialize = True
            spent += bytes_needed
            plan.decide(
                "cache",
                node=pn.label,
                reuse=pn.reuse,
                benefit_s=round(benefit(pn), 6) if benefit(pn) != float("inf") else "unknown",
                resident_bytes=int(bytes_needed),
                budget_bytes=plan.budget_bytes,
            )
            reg.counter("plan_cache_inserted").inc()
        else:
            plan.decide(
                "no_cache",
                node=pn.label,
                reuse=pn.reuse,
                reason="over_budget" if not fits else "no_benefit",
                resident_bytes=int(bytes_needed),
                budget_bytes=plan.budget_bytes,
            )
    # a shared prefix whose tail the budget refused is recomputed per
    # consumer — the executor reads this flag
    plan.share_prefix = not plan.branches or (bool(plan.prefix) and plan.prefix[-1].materialize)
    return plan


def choose_chunk_size(
    plan: Plan,
    n_rows: int,
    *,
    requested: int | None = None,
    source: str = "requested",
    budget_fraction: float = 0.25,
    shards: int = 1,
) -> Plan:
    """Bound the per-chunk working set to ``budget_fraction`` of the
    memory budget using the plan's worst per-row peak bytes; chunk sizes
    are powers of two. A forced size records where it came from in
    ``source``: the caller (``requested``), a stored learned plan
    (``store``) or the live autotuner (``autotuner``).

    ``shards`` (the cards holding rows, ``plan._shards``) scales the
    bound: a chunk splits its rows over the shards, so each card's budget
    admits ``shards``× more rows per chunk, and the size is kept
    divisible by ``shards`` so every shard gets an even block."""
    if requested is not None:
        plan.chunk_size = requested
        plan.decide("chunk", size=requested, source=source)
        return plan
    peak_row = max(
        (pn.cost.peak_bytes for chain in [plan.prefix, *plan.branches] for pn in chain),
        default=0.0,
    )
    if peak_row <= 0.0 or plan.budget_bytes <= 0:
        return plan  # no basis for a choice — executor stays unchunked
    shards = max(int(shards), 1)
    limit = max(int(plan.budget_bytes * budget_fraction * shards / peak_row), 1)
    if limit >= n_rows:
        plan.decide("chunk", size=None, reason="fits_whole_batch")
        return plan
    size = 1 << max(limit.bit_length() - 1, 0)
    if shards > 1:
        size = max(size - size % shards, shards)
    plan.chunk_size = size
    plan.decide(
        "chunk",
        size=size,
        peak_bytes_per_row=int(peak_row),
        budget_bytes=plan.budget_bytes,
    )
    return plan


def choose_sharding(plan: Plan, shards: int) -> Plan:
    """Row blocks over the processes of the plan's mesh: with more than
    one shard, the chunk is rounded up to a shard multiple (the same
    number of chunks, an even block per process) and the plan runs each
    process's rows on its own card."""
    if shards <= 1:
        plan.shard = False
        return plan
    if plan.chunk_size and plan.chunk_size % shards:
        plan.chunk_size = -(-plan.chunk_size // shards) * shards
    plan.shard = True
    plan.decide("shard", shards=shards, axis="data", chunk_size=plan.chunk_size)
    _metrics.get_registry().counter("plan_shard_planned").inc()
    return plan


def choose_staging(
    plan: Plan,
    n_rows: int,
    *,
    requested_depth: int | None = None,
    depth_source: str = "requested",
) -> Plan:
    """Staging depth: double buffering (2) when a chunk's transfer hides
    behind its compute, deeper (≤ 4) when the chain is transfer-bound;
    ``requested_depth`` (from ``depth_source``) / ``KEYSTONE_STAGE_DEPTH``
    override."""
    from keystone_tpu_torch.core.staging import default_stage_depth

    chunk_rows = plan.chunk_size or max(n_rows, plan.rows, 1)
    compute_s = sum(
        pn.cost.recompute_s(chunk_rows, plan.device_kind)
        for chain in [plan.prefix, *plan.branches]
        for pn in chain
    )
    transfer_s = (
        plan.prefix[0].cost.h2d_s(chunk_rows, plan.device_kind)
        if plan.prefix
        else 0.0
    )
    if requested_depth is not None:
        depth, source = max(int(requested_depth), 0), depth_source
    elif os.environ.get("KEYSTONE_STAGE_DEPTH", "").strip():
        depth, source = default_stage_depth(), "env"
    elif transfer_s > 0.0 and compute_s > 0.0 and transfer_s > compute_s:
        depth = min(4, math.ceil(transfer_s / compute_s) + 1)
        source = "cost_model"
    else:
        depth, source = 2, "cost_model"
    plan.stage_depth = depth
    plan.decide(
        "stage",
        depth=depth,
        source=source,
        transfer_s_per_chunk=round(transfer_s, 9),
        compute_s_per_chunk=round(compute_s, 9),
        hidden=bool(transfer_s <= compute_s),
    )
    _metrics.get_registry().counter("plan_stage_decisions").inc()
    return plan


def emit_plan(plan: Plan) -> None:
    """Record the finished plan in the event log (one ``optimize`` event
    carrying every decision) so rewrites are observable per run."""
    log = _events.active()
    if log is not None and plan.decisions:
        log.emit(
            "optimize",
            source="planner",
            nodes=[pn.label for pn in plan.prefix],
            branches=[[pn.label for pn in b] for b in plan.branches],
            chunk_size=plan.chunk_size,
            budget_bytes=plan.budget_bytes,
            decisions=plan.decisions,
        )
