"""Cost-based pipeline planner — port of ``keystone_tpu/plan``.

- :mod:`.ir` — plan IR: node chain with per-node costs and decisions;
- :mod:`.costs` — sampled per-node costs and the device peak table;
- :mod:`.passes` — rewrite rules, chunk-size and staging selection;
- :mod:`.fused_fit` — the fused streaming normal-equations fit;
- :mod:`.executor` — chunked planned apply, the streamed fit and the
  shared-prefix apply.

Entry points::

    plan = plan_pipeline(fitted_pipe, sample=probe, device=dev)
    out  = execute(fitted_pipe, batch, device=dev)
    fitted = fit_streaming(chained_est, x, y, device=dev)

Env knobs: ``KEYSTONE_PLAN=1`` opts model entry points into planned
execution; ``KEYSTONE_PLAN_BUDGET_MB`` caps the memory budget;
``KEYSTONE_STAGE_DEPTH`` overrides the host→device staging depth;
``KEYSTONE_GRAM_OP`` / ``KEYSTONE_GRAM_INT8_MAX_ERR`` steer the fused
fit's Gram operator.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from keystone_tpu_torch.core.pipeline import Transformer
from keystone_tpu_torch.plan import costs as _costs
from keystone_tpu_torch.plan import passes as _passes
from keystone_tpu_torch.plan.executor import apply_shared, fit_stream, run_plan, shared_prefix_nodes
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
) -> Plan:
    """Build and optimize a plan for a fitted (apply) pipeline: costs
    sampled on a bounded slice of ``sample``, then rewrite rules, chunk
    size (forced by ``chunk_size`` or chosen for ``n_rows`` rows) and
    staging depth."""
    chain = chain_from(pipe)
    probe = _costs.slice_probe(sample) if sample is not None else None
    if probe is not None:
        _costs.sample_chain(chain, probe, device)
    plan = Plan(
        prefix=chain,
        device=device,
        budget_bytes=(
            default_budget_bytes(device) if budget_bytes is None else budget_bytes
        ),
        device_kind=_costs.device_kind(device),
        rows=_costs._rows(probe) if probe is not None else 0,
    )
    if probe is not None:
        unprobed = [pn.label for pn in chain if pn.cost.source == "default"]
        if unprobed:
            plan.decide("cost_default", reason="unprobeable", nodes=unprobed)
    _passes.select_operators(plan)
    if chunk_size is not None or n_rows is not None:
        _passes.choose_chunk_size(plan, n_rows or 0, requested=chunk_size)
    _passes.choose_staging(plan, n_rows or 0, requested_depth=stage_depth)
    return plan


def execute(
    pipe: Transformer,
    data: Any,
    *,
    device: torch.device,
    sample: Any | None = None,
    budget_bytes: int | None = None,
    chunk_size: int | None = None,
    stage_depth: int | None = None,
) -> Any:
    """One-shot planned execution: plan ``pipe`` (sampling costs on a
    slice of ``data`` unless a separate ``sample`` is given) and run it on
    ``device``."""
    plan = plan_pipeline(
        pipe,
        sample=data if sample is None else sample,
        device=device,
        budget_bytes=budget_bytes,
        chunk_size=chunk_size,
        n_rows=_costs._rows(data),
        stage_depth=stage_depth,
    )
    return run_plan(plan, data)
