"""Per-node cost-profile registry — port of ``keystone_tpu/observe/cost.py``.

The JAX package asks the compiled executable for ``cost_analysis()`` and
``memory_analysis()``. The port runs the node once instead:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the call,
  plus the operation counts the hand kernels' wrappers report
  (:func:`keystone_tpu_torch.core.kernels.count_ops`). A kernel is a
  ``ctypes`` launch the counter never sees, and its plain version runs
  outside the counter, so a node whose work is K1 reads the same FLOPs
  on the card and on the CPU;
- bytes: the argument and output tensors' sizes on either device, and on
  the card the CUDA caching allocator's peak above its level before the
  call (``temp_bytes``, ``peak_bytes``, ``bytes_accessed``, the last the
  sum of arguments, outputs and temporaries: each buffer touched at
  least once). The CPU has no allocator statistics: those three are
  ``None`` there and the report prints ``-``.

Profiles are recorded only on request (:func:`record_pipeline_profile`,
the model entry points under an observe sink), never on the planner's
sampling path. They persist next to the event log
(``cost_profiles.json``), where :mod:`.report` joins them against the
wall-time events and :mod:`keystone_tpu_torch.plan.costs` seeds plans.

Profile schema per node label::

    {"flops": float, "kernel_ops": float, "bytes_accessed": float | None,
     "argument_bytes": int, "output_bytes": int, "temp_bytes": int | None,
     "peak_bytes": int | None, "input_shapes": [...],
     "error": str (only when analysis failed)}
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Callable

import torch

from keystone_tpu_torch.observe import events as _events

COST_FILE = "cost_profiles.json"


def _tensors(tree: Any, seen: set | None = None) -> list[torch.Tensor]:
    """Every tensor in a nested structure: tuples, lists, dicts and
    dataclass fields (a node's parameters)."""
    seen = set() if seen is None else seen
    if isinstance(tree, torch.Tensor):
        return [tree]
    if id(tree) in seen:
        return []
    seen.add(id(tree))
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x, seen)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x, seen)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [
            t for f in dataclasses.fields(tree) for t in _tensors(getattr(tree, f.name), seen)
        ]
    return []


def _nbytes(tree: Any) -> int:
    unique = {id(t): t for t in _tensors(tree)}
    return int(sum(t.numel() * t.element_size() for t in unique.values()))


def _shapes(tree: Any) -> list[str]:
    if isinstance(tree, torch.Tensor):
        return [f"{tree.dtype}{list(tree.shape)}"]
    if isinstance(tree, (list, tuple)):
        return [s for x in tree for s in _shapes(x)]
    return [type(tree).__name__]


def _device_of(tree: Any) -> torch.device | None:
    for t in _tensors(tree):
        return t.device
    return None


def analyze(fn: Callable, *args: Any, **kwargs: Any) -> dict:
    """Run ``fn(*args, **kwargs)`` once, without gradients, and extract
    its cost profile (module docstring). Failures are captured as an
    ``{"error": ...}`` profile rather than raised, as in the JAX package:
    a node that cannot be costed must not abort the rest."""
    from torch.utils.flop_counter import FlopCounterMode

    from keystone_tpu_torch.core.kernels import count_ops

    try:
        device = _device_of((args, kwargs))
        on_card = device is not None and device.type == "cuda"
        if on_card:
            torch.cuda.synchronize(device)
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        counter = FlopCounterMode(display=False)
        with torch.no_grad(), count_ops() as kernel_ops, counter:
            out = fn(*args, **kwargs)
        arg_b, out_b = _nbytes((args, kwargs)), _nbytes(out)
        profile: dict[str, Any] = {
            "flops": float(counter.get_total_flops()) + kernel_ops[0],
            "kernel_ops": kernel_ops[0],
            "bytes_accessed": None,
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": None,
            "peak_bytes": None,
        }
        if on_card:
            torch.cuda.synchronize(device)
            grown = max(int(torch.cuda.max_memory_allocated(device)) - base, 0)
            profile.update(
                bytes_accessed=float(arg_b + grown),
                temp_bytes=max(grown - out_b, 0),
                peak_bytes=arg_b + grown,
            )
        return profile
    except Exception as e:  # noqa: BLE001
        return {"error": f"{type(e).__name__}: {str(e)[:200]}"}


class CostProfileRegistry:
    """Thread-safe map of node label → cost profile for one process."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._profiles: dict[str, dict] = {}
        self.device_kind: str | None = None
        self.num_devices: int | None = None

    def record(self, label: str, profile: dict) -> dict:
        with self._lock:
            self._profiles[label] = profile
        return profile

    def get(self, label: str) -> dict | None:
        """One node's recorded profile (the planner's join point — the
        cost source of choice before it falls back to a sampled pass)."""
        with self._lock:
            return self._profiles.get(label)

    def profile_node(self, node: Callable, batch: Any, label: str | None = None) -> dict:
        """Cost-profile one node applied to ``batch``."""
        label = label or _events.node_label(node)
        profile = analyze(lambda n, b: n(b), node, batch)
        profile["input_shapes"] = _shapes(batch)
        return self.record(label, profile)

    def profile_pipeline(self, pipe, batch: Any) -> dict[str, dict]:
        """Profile each node of a fitted pipeline in sequence, feeding
        each node's output to the next so every profile reflects the
        shapes the node actually sees."""
        from keystone_tpu_torch.observe.instrument import InstrumentedNode

        nodes = getattr(pipe, "nodes", None)
        if nodes is None:
            nodes = (pipe,)
        self._note_devices(batch)
        out: dict[str, dict] = {}
        for i, node in enumerate(nodes):
            inner = node.inner if isinstance(node, InstrumentedNode) else node
            label = _events.node_label(inner, i)
            out[label] = self.profile_node(inner, batch, label=label)
            try:
                with torch.no_grad():
                    batch = inner(batch)
            except Exception as e:  # noqa: BLE001 — can't feed further nodes
                out[label].setdefault("error", f"apply failed: {type(e).__name__}")
                break
        return out

    def _note_devices(self, batch: Any) -> None:
        device = _device_of(batch)
        if device is not None and device.type == "cuda":
            self.device_kind = torch.cuda.get_device_name(device)
            self.num_devices = torch.cuda.device_count()
        else:
            self.device_kind, self.num_devices = "cpu", 1

    def snapshot(self) -> dict:
        with self._lock:
            profiles = dict(self._profiles)
        return {
            "device_kind": self.device_kind,
            "num_devices": self.num_devices,
            "profiles": profiles,
        }

    def save(self, run_dir: str) -> str:
        """Persist to ``<run_dir>/cost_profiles.json`` (atomic rename)."""
        path = os.path.join(run_dir, COST_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        os.replace(tmp, path)
        return path

    def reset(self) -> None:
        with self._lock:
            self._profiles.clear()


_registry = CostProfileRegistry()


def get_cost_registry() -> CostProfileRegistry:
    return _registry


def record_pipeline_profile(
    pipe,
    probe: Any,
    registry: CostProfileRegistry | None = None,
    save_dir: str | None = None,
    sync: bool = True,
) -> dict[str, dict]:
    """One-call operator-profile sample for a fitted pipeline: an
    instrumented apply of ``probe`` (per-node wall-time events into the
    active sink and metrics; ``sync`` waits for each node's device work)
    followed by per-node cost profiles, optionally persisted to
    ``save_dir``. A FRESH registry by default, so one run's
    ``cost_profiles.json`` carries no stale nodes. The probe passes
    through the pipeline twice: keep it bounded."""
    from keystone_tpu_torch.observe.instrument import instrument

    registry = registry or CostProfileRegistry()
    with torch.no_grad():
        instrument(pipe, sync=sync)(probe)
    profiles = registry.profile_pipeline(pipe, probe)
    if save_dir is not None:
        registry.save(save_dir)
    return profiles


def load_profiles(run_dir: str) -> dict:
    """Read a persisted ``cost_profiles.json``; empty snapshot shape when
    the run recorded none."""
    try:
        with open(os.path.join(run_dir, COST_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {"device_kind": None, "num_devices": None, "profiles": {}}
