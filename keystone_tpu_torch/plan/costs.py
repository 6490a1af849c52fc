"""Cost attachment — port of ``keystone_tpu/plan/costs.py``.

Two sources, in preference order:

1. The observe cost-profile registry
   (:mod:`keystone_tpu_torch.observe.cost`) — profiles recorded on request
   by an earlier instrumented run of the same pipeline, keyed by the
   shared node label (FLOPs from ``torch.utils.flop_counter`` plus the
   hand kernels' own operation counts, bytes from the card's allocator).
2. A sampled profiling pass: apply each node to a small probe slice and
   measure its wall time (synchronized on the card). The pass counts no
   FLOPs: a FLOP counter on the probe path cost most of a first fit.

All figures are normalized per input row so a plan sampled on 256 rows
prices a 60,000-row execution.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from keystone_tpu_torch.core.runtime import synchronize
from keystone_tpu_torch.core.staging import as_tensor, tree_map
from keystone_tpu_torch.observe import cost as _cost
from keystone_tpu_torch.plan.ir import NodeCost, PlanNode

# Peaks per device kind: (bf16 dense tensor FLOP/s, device-memory bytes/s,
# host→device bytes/s, device↔device bytes/s), keyed by a case-insensitive
# substring of the device name. The "h100" row is NVIDIA's H100 SXM
# datasheet (989 TFLOP/s bf16 dense, 3.35 TB/s HBM3, PCIe gen5 x16
# 64 GB/s, NVLink 450 GB/s each way) — datasheet figures, not
# measurements. The "cpu" row is a coarse fallback: the planner only
# compares relative magnitudes there.
DEVICE_PEAKS: dict[str, tuple[float, float, float, float]] = {
    "cpu": (5e10, 2e10, 2e10, 2e10),
    "h100": (9.89e14, 3.35e12, 6.4e10, 4.5e11),
}

# int8 tensor-core rate relative to bf16 — the Gram-operator selection's
# cost basis (plan/fused_fit.py). H100 datasheet: 1,979 TOP/s int8 vs 989
# TFLOP/s bf16, dense. CPUs and unknown devices get 1.0, so the planner
# never picks the quantized Gram where it cannot win.
INT8_GRAM_SPEEDUP: dict[str, float] = {
    "cpu": 1.0,
    "h100": 2.0,
}


def _lookup(table: dict, device_kind: str | None, default):
    if device_kind:
        kind = device_kind.lower()
        for key, value in table.items():
            if key in kind:
                return value
    return default


def device_peaks(device_kind: str | None) -> tuple[float, float, float, float]:
    """The peak tuple for a device name; unknown names get the "cpu" row."""
    return _lookup(DEVICE_PEAKS, device_kind, DEVICE_PEAKS["cpu"])


def peak_flops_for(device_kind: str | None) -> float | None:
    """bf16 dense peak FLOP/s for a known card's name, or None (the CPU,
    unknown devices) — the report's roofline basis."""
    if not device_kind:
        return None
    kind = device_kind.lower()
    for key, peaks in DEVICE_PEAKS.items():
        if key != "cpu" and key in kind:
            return peaks[0]
    return None


def int8_gram_speedup(device_kind: str | None) -> float:
    """int8-vs-bf16 rate for a device name; unknown names report 1.0."""
    return _lookup(INT8_GRAM_SPEEDUP, device_kind, 1.0)


def device_kind(device: torch.device) -> str:
    """``torch.cuda.get_device_name`` for a CUDA device, else "cpu"."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _leaves(tree: Any) -> list:
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _rows(batch: Any) -> int:
    for leaf in _leaves(batch):
        shape = getattr(leaf, "shape", None)
        if shape:
            return int(shape[0])
    return 1


def _nbytes(tree: Any) -> float:
    total = 0.0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, np.ndarray):
            total += leaf.nbytes
    return total


def cost_from_profile(profile: dict, rows: int) -> NodeCost:
    """A :class:`NodeCost` from one observe cost-registry profile entry
    (``cost_profiles.json`` schema), normalized per row."""
    rows = max(rows, 1)
    if not profile or "error" in profile:
        return NodeCost()
    return NodeCost(
        flops=float(profile.get("flops", 0.0)) / rows,
        bytes_accessed=float(profile.get("bytes_accessed") or 0.0) / rows,
        output_bytes=float(profile.get("output_bytes", 0.0)) / rows,
        peak_bytes=float(profile.get("peak_bytes") or 0.0) / rows,
        input_bytes=float(profile.get("input_bytes", 0.0)) / rows,
        collective_bytes=float(profile.get("collective_bytes", 0.0)) / rows,
        source="profile",
    )


def _profile_rows(profile: dict) -> int | None:
    """Rows the profile was recorded on, parsed from its input shapes
    (``"torch.float32[2048, 784]"``) so normalization uses the profile's
    own batch size, not the planner's probe size."""
    shapes = profile.get("input_shapes") or []
    for s in shapes:
        lb = s.find("[")
        if lb < 0:
            continue
        head = s[lb + 1 :].split(",")[0].rstrip("]").strip()
        if head.isdigit():
            return int(head)
    return None


def from_registry(chain: list[PlanNode], rows: int) -> int:
    """Fill chain costs from the process cost registry where labels
    match; returns how many nodes were costed."""
    registry = _cost.get_cost_registry()
    hit = 0
    for pn in chain:
        profile = registry.get(pn.label)
        if profile and "error" not in profile:
            pn.cost = cost_from_profile(profile, _profile_rows(profile) or rows)
            hit += 1
    return hit


def attach(chain: list[PlanNode], sample: Any | None, device: torch.device) -> None:
    """Cost a chain: registry profiles first, the sampled pass for the
    rest."""
    from_registry(chain, _rows(sample) if sample is not None else 1)
    if sample is not None and any(pn.cost.source == "default" for pn in chain):
        sample_chain(chain, sample, device)


def sample_chain(chain: list[PlanNode], probe: Any, device: torch.device) -> Any:
    """Sampled profiling pass: cost every un-costed node of ``chain`` on
    ``probe`` (feeding each node's output forward) — a warm-up application,
    then a second one timed. Returns the final output.

    A node the probe can't run (it raises ``TypeError``/``ValueError``, or
    a shape ``RuntimeError`` off the card) keeps its default cost, and the
    caller records that; on the card a ``RuntimeError`` propagates, so a
    device fault is never priced away. A sampled node carries no FLOP
    count: its measured wall time is what :meth:`NodeCost.recompute_s`
    reads."""
    rows = max(_rows(probe), 1)
    probe = tree_map(lambda a: as_tensor(a).to(device), probe)
    for pn in chain:
        if pn.cost.source != "default":
            probe = pn.op(probe)
            continue
        in_bytes = _nbytes(probe) / rows
        try:
            pn.op(probe)
            synchronize(device)
            t0 = time.perf_counter()
            out = pn.op(probe)
            synchronize(device)
            wall = time.perf_counter() - t0
        except RuntimeError:
            if device.type == "cuda":
                raise
            return probe
        except (TypeError, ValueError):
            return probe
        out_bytes = _nbytes(out) / rows
        pn.cost = NodeCost(
            output_bytes=out_bytes,
            peak_bytes=in_bytes + out_bytes,
            input_bytes=in_bytes,
            wall_s=wall / rows,
            source="sampled",
        )
        probe = out
    return probe


def slice_probe(data: Any, rows: int = 256) -> Any:
    """A bounded probe slice of ``data`` for the sampling pass."""
    if _rows(data) <= rows:
        return data
    return tree_map(lambda leaf: leaf[:rows], data)
