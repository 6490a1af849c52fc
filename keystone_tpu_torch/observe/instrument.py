"""Explicit pipeline instrumentation: ``instrument(pipeline)`` — port of
``keystone_tpu/observe/instrument.py``.

:func:`instrument` wraps every node so

- each call is recorded to the metrics registry (call counter and timer
  per node) whether or not an event sink is active, and to the sink as a
  ``node`` event when one is;
- ``sync=True`` waits for the node's device work before stopping the
  clock (CUDA launches are asynchronous), so per-node wall time lands on
  the node that launched the work;
- outputs are untouched: the wrapper returns the node's result.

Under a CUDA graph capture nothing runs, so there is no wall time to
record, and a synchronize would break the capture: a captured call
counts ``node_captures`` and returns (the JAX package's tracing branch).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from keystone_tpu_torch.core.pipeline import Pipeline, Transformer
from keystone_tpu_torch.observe import events as _events
from keystone_tpu_torch.observe import metrics as _metrics


def _capturing() -> bool:
    """True while this thread's current CUDA stream is being captured."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _sync_outputs(out) -> None:
    """Wait for the CUDA devices that hold ``out``'s tensors."""
    leaves = out if isinstance(out, (list, tuple)) else (out,)
    for device in {t.device for t in leaves if isinstance(t, torch.Tensor)}:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


@dataclasses.dataclass(eq=False)
class InstrumentedNode(Transformer):
    """One wrapped pipeline node; see the module docstring."""

    inner: Transformer
    label: str = ""
    sync: bool = False

    def __call__(self, batch):
        reg = _metrics.get_registry()
        if _capturing():
            out = self.inner(batch)
            reg.counter("node_captures", node=self.label).inc()
            return out
        log = _events.active()
        t0 = time.perf_counter()
        try:
            out = self.inner(batch)
            if self.sync:
                _sync_outputs(out)
        except BaseException as e:
            wall = time.perf_counter() - t0
            reg.counter("node_errors", node=self.label).inc()
            if log is not None:
                log.emit("node", node=self.label, phase="apply", wall_s=wall,
                         status="failed", error=repr(e))
            raise
        wall = time.perf_counter() - t0
        reg.counter("node_calls", node=self.label).inc()
        reg.timer("node_seconds", node=self.label).observe(wall)
        if log is not None:
            log.emit("node", node=self.label, phase="apply", wall_s=wall, status="ok")
        return out

    def __repr__(self):
        return f"InstrumentedNode({self.label})"


def _wrap(node: Transformer, label: str, sync: bool) -> InstrumentedNode:
    if isinstance(node, InstrumentedNode):
        # no double wrapping, but honor a changed sync request
        if node.sync == sync:
            return node
        return dataclasses.replace(node, sync=sync)
    return InstrumentedNode(inner=node, label=label, sync=sync)


def instrument(pipe: Transformer, sync: bool = False) -> Transformer:
    """Wrap every node of ``pipe`` (or a single transformer) so calls are
    recorded per node. Idempotent: already-wrapped nodes are not wrapped
    again (their ``sync`` is updated if the request differs)."""
    if isinstance(pipe, Pipeline):
        return Pipeline(
            nodes=tuple(
                _wrap(node, _events.node_label(node, i), sync)
                for i, node in enumerate(pipe.nodes)
            )
        )
    return _wrap(pipe, _events.node_label(pipe), sync)
