"""Plan IR — port of ``keystone_tpu/plan/ir.py``: a chain of
:class:`PlanNode` (one per pipeline node, each with a :class:`NodeCost`
from a recorded cost profile or a sampled pass) plus the branch structure
of a multi-consumer fit (several estimators riding one featurization
prefix) and the planner's decisions."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from keystone_tpu_torch.core.pipeline import Cacher, Pipeline, Transformer, node_label


@dataclasses.dataclass
class NodeCost:
    """Per-node cost estimate, normalized per input row.

    ``wall_s`` is a measured per-row apply time from a sampled profiling
    pass (the strongest signal); ``flops`` / ``bytes_accessed`` come from
    a recorded cost profile (:mod:`keystone_tpu_torch.observe.cost`) or are
    modeled from shapes (the streaming-fit sink), and are read only when
    ``wall_s`` is unset; ``peak_bytes`` is the node's per-row working set;
    ``input_bytes`` is what the node reads from its predecessor — for the
    chain's first node, the host batch that crosses PCIe per chunk;
    ``collective_bytes`` is what a sharded execution moves between
    devices (0 here: the port's executor runs on one device). ``source``
    records where the numbers came from (``profile``, ``sampled``,
    ``modeled`` or ``default``).
    """

    flops: float = 0.0
    bytes_accessed: float = 0.0
    output_bytes: float = 0.0
    peak_bytes: float = 0.0
    input_bytes: float = 0.0
    collective_bytes: float = 0.0
    wall_s: float | None = None
    source: str = "default"

    def recompute_s(self, rows: float, device_kind: str | None = None) -> float:
        """Estimated seconds to (re)compute this node over ``rows`` rows:
        the measured wall, else the roofline of its FLOPs and bytes (the
        bytes it reads and writes when no profile counted them)."""
        from keystone_tpu_torch.plan.costs import device_peaks

        if self.wall_s is not None:
            return self.wall_s * rows
        peak_flops, peak_bw, _, _ = device_peaks(device_kind)
        moved = self.bytes_accessed or (self.input_bytes + self.output_bytes)
        return max(self.flops * rows / peak_flops, moved * rows / peak_bw)

    def h2d_s(self, rows: float, device_kind: str | None = None) -> float:
        """Estimated seconds to move this node's input host→device."""
        from keystone_tpu_torch.plan.costs import device_peaks

        return self.input_bytes * rows / device_peaks(device_kind)[2]

    def collective_s(self, rows: float, device_kind: str | None = None) -> float:
        """Estimated seconds in cross-device collectives over ``rows``
        rows: 0 on one device, where ``collective_bytes`` is 0."""
        from keystone_tpu_torch.plan.costs import device_peaks

        return self.collective_bytes * rows / device_peaks(device_kind)[3]


@dataclasses.dataclass
class PlanNode:
    """One pipeline node inside a plan."""

    label: str
    op: Any  # Transformer (apply nodes), or the fused-fit sink
    cost: NodeCost = dataclasses.field(default_factory=NodeCost)
    reuse: int = 1  # number of downstream consumers of this node's output
    materialize: bool = False  # planner-chosen cache point after this node
    rewritten_from: tuple[str, ...] = ()  # labels the rewrite replaced


@dataclasses.dataclass
class Plan:
    """A planned pipeline: the optimized chain, the branch structure and
    the decisions that made it.

    ``prefix`` is the (possibly shared) node chain; ``branches`` holds
    per-consumer suffix chains for a multi-branch fit (empty for a linear
    pipeline). ``decisions`` is the observable record — every rewrite,
    cache point, chunk, staging and operator choice lands there."""

    prefix: list[PlanNode]
    branches: list[list[PlanNode]] = dataclasses.field(default_factory=list)
    share_prefix: bool = True
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu")
    )
    chunk_size: int | None = None
    budget_bytes: int = 0
    device_kind: str | None = None
    rows: int = 0  # rows the costs were normalized against (sample size)
    stage_depth: int = 2  # staged host→device chunks kept in flight
    fit: Any = None  # FitPlanInfo for a fused streaming fit (fused_fit)
    decisions: list[dict] = dataclasses.field(default_factory=list)
    mesh: Any = None  # parallel.mesh.Mesh the plan runs over (None: one device)
    shard: bool = False  # rows split over the processes of the mesh's data axis

    def decide(self, action: str, **fields: Any) -> dict:
        rec = {"action": action, **fields}
        self.decisions.append(rec)
        return rec

    def decision(self, action: str) -> dict | None:
        """The latest decision recorded under ``action``, or None."""
        for rec in reversed(self.decisions):
            if rec["action"] == action:
                return rec
        return None

    def pipeline(self) -> Pipeline:
        """The optimized linear chain as a plain ``Pipeline`` (rewrites
        applied, planner cache points as explicit :class:`Cacher` nodes).
        Only valid for single-chain plans."""
        if self.branches:
            raise ValueError("multi-branch plan has no single pipeline form")
        nodes: list[Transformer] = []
        for pn in self.prefix:
            nodes.append(pn.op)
            if pn.materialize and not isinstance(pn.op, Cacher):
                nodes.append(Cacher(name=pn.label))
        return Pipeline(nodes=tuple(nodes))

    def execute(self, data):
        from keystone_tpu_torch.plan import executor

        return executor.run_plan(self, data)

    def explain(self) -> str:
        """Human-readable plan dump (the ``plan`` CLI renders this)."""
        lines = [
            f"plan: {len(self.prefix)} node(s)"
            + (f" + {len(self.branches)} branch(es)" if self.branches else ""),
            f"  budget: {self.budget_bytes / 2**20:.0f} MiB"
            + (f"  chunk: {self.chunk_size}" if self.chunk_size else "  chunk: -")
            + f"  device: {self.device_kind or 'unknown'}"
            + f"  stage_depth: {self.stage_depth}",
            f"  {'#':>2} {'node':<28} {'flops/row':>10} {'out B/row':>10}"
            f" {'est s':>9} {'reuse':>5} {'cache':>5}",
        ]

        def row(i, pn):
            est = pn.cost.recompute_s(max(self.rows, 1), self.device_kind)
            lines.append(
                f"  {i:>2} {pn.label:<28} {pn.cost.flops:>10.3g}"
                f" {pn.cost.output_bytes:>10.3g} {est:>9.2g}"
                f" {pn.reuse:>5} {'yes' if pn.materialize else '-':>5}"
            )

        if self.fit is not None:
            f = self.fit
            lines.insert(
                1,
                f"  fit: {'fused streaming' if f.fused else 'materialized'}"
                + (
                    f"  d={f.d} k={f.k} gram={f.gram}"
                    if f.fused
                    else f"  ({f.reason or 'see decisions'})"
                ),
            )
        for i, pn in enumerate(self.prefix):
            row(i, pn)
        for b, branch in enumerate(self.branches):
            lines.append(f"  branch {b}:")
            for i, pn in enumerate(branch):
                row(i, pn)
        if self.decisions:
            lines.append("  decisions:")
            for d in self.decisions:
                fields = ", ".join(f"{k}={v}" for k, v in d.items() if k != "action")
                lines.append(f"    - {d['action']}: {fields}")
        else:
            lines.append("  decisions: none (plan == input pipeline)")
        return "\n".join(lines)


def nodes_of(pipe: Transformer) -> list[Transformer]:
    """Flat node list of a Pipeline, or the single transformer itself."""
    if isinstance(pipe, Pipeline):
        return list(pipe.nodes)
    return [pipe]


def chain_from(pipe: Transformer) -> list[PlanNode]:
    """Lift a (fitted) pipeline into an uncosted PlanNode chain."""
    return [
        PlanNode(label=node_label(node, i), op=node)
        for i, node in enumerate(nodes_of(pipe))
    ]
