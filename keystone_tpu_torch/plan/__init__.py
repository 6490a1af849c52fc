"""Cost-based pipeline planner — port of ``keystone_tpu/plan``.

- :mod:`.ir` — plan IR: node chain + branches with per-node costs and
  decisions;
- :mod:`.costs` — cost attachment from the observe cost-profile registry
  or a sampled pass, and the device peak table;
- :mod:`.passes` — rewrite rules, automatic materialization under the
  budget, chunk-size and staging selection;
- :mod:`.fused_fit` — the fused streaming normal-equations fit;
- :mod:`.executor` — segmented chunked apply, shared-prefix fits, the
  streamed fit and the shared-prefix apply;
- :mod:`.store`, :mod:`.tune` — the learned-plan store and the online
  autotuner; :mod:`.cli` — ``python -m keystone_tpu_torch plan <model>``.

Entry points::

    plan = plan_pipeline(fitted_pipe, sample=probe, device=dev)
    out  = plan.execute(batch)
    out  = execute(fitted_pipe, batch, device=dev)
    fitted = fit_shared([chainA, chainB], data, y, device=dev)
    fitted = fit_streaming(chained_est, x, y, device=dev)

Env knobs: ``KEYSTONE_PLAN=1`` opts model entry points into planned
execution; ``KEYSTONE_PLAN_BUDGET_MB`` caps the memory budget;
``KEYSTONE_STAGE_DEPTH`` overrides the host→device staging depth;
``KEYSTONE_GRAM_OP`` / ``KEYSTONE_GRAM_INT8_MAX_ERR`` steer the fused
fit's Gram operator; ``KEYSTONE_PLAN_STORE`` names the learned-plan
store and ``KEYSTONE_TUNE=1`` turns the autotuner on.
"""

from __future__ import annotations

import os
from typing import Any, Sequence

import torch

from keystone_tpu_torch.core.pipeline import Transformer, node_label
from keystone_tpu_torch.parallel.mesh import current_mesh, data_axis_size
from keystone_tpu_torch.plan import costs as _costs
from keystone_tpu_torch.plan import executor as _executor
from keystone_tpu_torch.plan import passes as _passes
from keystone_tpu_torch.plan.executor import (
    apply_shared,
    fit_shared,
    fit_stream,
    run_plan,
    shared_prefix_nodes,
)
from keystone_tpu_torch.plan.fused_fit import fit_streaming, plan_fit
from keystone_tpu_torch.plan.ir import NodeCost, Plan, PlanNode, chain_from

ENV_ENABLE = "KEYSTONE_PLAN"
ENV_BUDGET_MB = "KEYSTONE_PLAN_BUDGET_MB"
_DEFAULT_BUDGET_BYTES = 1 << 30

__all__ = [
    "Plan",
    "PlanNode",
    "NodeCost",
    "plan_pipeline",
    "plan_fit",
    "execute",
    "fit_stream",
    "fit_shared",
    "apply_shared",
    "shared_prefix_nodes",
    "fit_streaming",
    "run_plan",
    "enabled",
    "default_budget_bytes",
]


def enabled() -> bool:
    """The ``KEYSTONE_PLAN`` gate: models route through the planner when
    truthy (unset/0/false/off → the classic paths)."""
    return os.environ.get(ENV_ENABLE, "").strip().lower() not in (
        "",
        "0",
        "false",
        "off",
        "no",
    )


def default_budget_bytes(device: torch.device) -> int:
    """Memory budget: the env override, else the card's total memory
    (``torch.cuda.mem_get_info``), else 1 GiB on the CPU."""
    mb = os.environ.get(ENV_BUDGET_MB, "").strip()
    if mb:
        try:
            return max(int(float(mb) * 2**20), 0)
        except ValueError:
            pass
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return _DEFAULT_BUDGET_BYTES


def plan_pipeline(
    pipe: Transformer,
    sample: Any | None = None,
    *,
    device: torch.device,
    budget_bytes: int | None = None,
    chunk_size: int | None = None,
    n_rows: int | None = None,
    stage_depth: int | None = None,
    mesh: Any = None,
) -> Plan:
    """Build and optimize a plan for a fitted (apply) pipeline on
    ``device``: costs from recorded profiles, else sampled on a bounded
    slice of ``sample``; then rewrite rules, materialization, chunk size
    (forced by ``chunk_size`` or chosen for ``n_rows`` rows) and staging
    depth. ``mesh`` (default: the ambient mesh) splits the rows over the
    processes of a data axis that spans processes (:func:`_shards`).

    Self-tuning (both env-gated, off by default): with a plan store
    (``KEYSTONE_PLAN_STORE``, :mod:`.store`) the learned record for this
    (pipeline fingerprint, device kind) seeds chunk size and stage depth;
    with the autotuner active (``KEYSTONE_TUNE=1``, :mod:`.tune`) its
    live ``chunk_rows`` knob takes precedence over the store, the chosen
    chunk becomes the knob's seed, and the tuner is bound to the store
    identity so committed improvements persist. Priority: explicit
    argument > live autotuner > stored record > cost model, each seeding
    recorded as a plan decision (``source=``)."""
    from keystone_tpu_torch.plan import store as _plan_store
    from keystone_tpu_torch.plan import tune as _tune

    chain = chain_from(pipe)
    fp = _plan_store.fingerprint([pn.label for pn in chain])
    device_kind = _costs.device_kind(device)
    learned = None
    if _plan_store.store_dir():
        try:
            learned = _plan_store.load(fp, device_kind=device_kind)
        except _plan_store.PlanStoreError as e:
            # refusal is loud but not fatal: plan untuned
            from keystone_tpu_torch.core.logging import get_logger

            get_logger("keystone_tpu_torch.plan").warning("%s", e)
    tuner = _tune.active()
    chunk_req, chunk_source = chunk_size, "requested"
    if chunk_req is None and tuner is not None:
        # fingerprint-scoped: only the pipeline that bound the chunk knob
        # reads it back
        live = tuner.chunk_value_for(fp)
        if live:
            chunk_req, chunk_source = int(live), "autotuner"
    if chunk_req is None and learned is not None:
        stored = (learned.get("plan") or {}).get("chunk_size")
        if stored:
            chunk_req, chunk_source = int(stored), "store"
    depth_req, depth_source = stage_depth, "requested"
    if (
        depth_req is None
        and not os.environ.get("KEYSTONE_STAGE_DEPTH", "").strip()
        and learned is not None
    ):
        stored = (learned.get("knobs") or {}).get("stage_depth")
        if stored is None:
            stored = (learned.get("plan") or {}).get("stage_depth")
        if stored is not None:
            depth_req, depth_source = int(stored), "store"
    probe = _costs.slice_probe(sample) if sample is not None else None
    _costs.attach(chain, probe, device)
    plan = Plan(
        prefix=chain,
        device=device,
        budget_bytes=(
            default_budget_bytes(device) if budget_bytes is None else budget_bytes
        ),
        device_kind=device_kind,
        rows=_costs._rows(probe) if probe is not None else 0,
        mesh=mesh if mesh is not None else current_mesh(),
    )
    if probe is not None:
        unprobed = [pn.label for pn in chain if pn.cost.source == "default"]
        if unprobed:
            plan.decide("cost_default", reason="unprobeable", nodes=unprobed)
    _passes.select_operators(plan)
    # budget decisions are priced at the real execution size
    _passes.choose_materialization(plan, rows=n_rows)
    if chunk_req is not None or n_rows is not None:
        _passes.choose_chunk_size(
            plan, n_rows or 0, requested=chunk_req, source=chunk_source,
            shards=_shards(plan),
        )
    _passes.choose_staging(
        plan, n_rows or 0, requested_depth=depth_req, depth_source=depth_source
    )
    _passes.choose_sharding(plan, _shards(plan))
    if learned is not None:
        plan.decide(
            "learned",
            fingerprint=fp,
            run=(learned.get("provenance") or {}).get("run"),
            saved_ts=learned.get("saved_ts"),
        )
    if tuner is not None:
        if plan.chunk_size:
            tuner.bind_chunk(plan.chunk_size, fingerprint=fp)
        tuner.bind_store(
            fp,
            device_kind,
            {
                "chunk_size": plan.chunk_size,
                "stage_depth": plan.stage_depth,
                "nodes": [pn.label for pn in plan.prefix],
            },
            # the store was consulted above: pass the payload through so
            # the hit/mismatch counters count real loads
            record=learned,
        )
    _passes.emit_plan(plan)
    return plan


def _shards(plan: Plan) -> int:
    """The cards that hold a plan's rows: the processes on its mesh's data
    axis. A one-process mesh counts 1, because all its rows sit on one
    card (the reference counts its data axis: there each position is a
    device of the one program)."""
    mesh = plan.mesh
    if mesh is None or not mesh.spans_processes:
        return 1
    return data_axis_size(mesh)


def execute(
    pipe: Transformer,
    data: Any,
    *,
    device: torch.device,
    sample: Any | None = None,
    budget_bytes: int | None = None,
    chunk_size: int | None = None,
    stage_depth: int | None = None,
    mesh: Any = None,
) -> Any:
    """One-shot planned execution: plan ``pipe`` (sampling costs on a
    slice of ``data`` unless a separate ``sample`` is given) and run it on
    ``device``; over a ``mesh`` across processes, on this process's rows
    (the output is then a ``GlobalRows``)."""
    plan = plan_pipeline(
        pipe,
        sample=data if sample is None else sample,
        device=device,
        budget_bytes=budget_bytes,
        chunk_size=chunk_size,
        n_rows=_costs._rows(data),
        stage_depth=stage_depth,
        mesh=mesh,
    )
    return run_plan(plan, data)


def _assemble_fit_plan(
    chains: Sequence[Any],
    *,
    device: torch.device,
    sample: Any | None = None,
    budget_bytes: int | None = None,
    n_rows: int | None = None,
) -> tuple[Plan, list[Any]]:
    """Plan a multi-branch fit: the shared-prefix nodes (reuse = number of
    chains on the tail) plus one branch per chain holding its remaining
    prefix nodes. The materialization pass then decides whether the
    shared intermediate earns residency."""
    shared = _executor.shared_prefix_nodes(chains)
    prefix = [PlanNode(label=node_label(node, i), op=node) for i, node in enumerate(shared)]
    if prefix:
        prefix[-1].reuse = len(chains)
    branches = []
    for chain in chains:
        rest = _executor._prefix_nodes(chain)[len(shared) :]
        branches.append(
            [PlanNode(label=node_label(node, len(shared) + i), op=node) for i, node in enumerate(rest)]
        )
    probe = _costs.slice_probe(sample) if sample is not None else None
    if probe is not None and prefix:
        out = _costs.sample_chain(prefix, probe, device)
        for branch in branches:
            _costs.sample_chain(branch, out, device)
    plan = Plan(
        prefix=prefix,
        branches=branches,
        device=device,
        budget_bytes=(
            default_budget_bytes(device) if budget_bytes is None else budget_bytes
        ),
        device_kind=_costs.device_kind(device),
        rows=_costs._rows(probe) if probe is not None else 0,
    )
    _passes.choose_materialization(plan, rows=n_rows)
    _passes.emit_plan(plan)
    return plan, shared
