"""Device mesh — port of the parts of ``keystone_tpu/parallel/mesh.py`` that
sequence-parallel attention reads.

The JAX package is single-controller: one process drives every device of a
mesh. The port keeps that model. A :class:`Mesh` is a (data, model) grid of
``torch.device``s driven by one process; ring and Ulysses attention move
shards between the devices along one axis with ``tensor.to(device)`` — a
peer copy between two cards, and no copy at all when two positions name the
same device.

A device may appear more than once in a mesh. That is the counterpart of
the JAX package's forced host devices (its tests run an 8-device CPU mesh on
one host): one card can run a whole n-position schedule, with the real
offsets and causal skips of every position, and one CPU can stand in for
eight positions in the tests.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Iterator, Sequence

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of devices. ``devices[i][j]`` is the device at
    data index i, model index j; ``shape`` maps each axis name to its size,
    as ``jax.sharding.Mesh.shape`` does."""

    devices: tuple  # tuple of tuples of torch.device
    axis_names: tuple = (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> dict:
        return {
            self.axis_names[0]: len(self.devices),
            self.axis_names[1]: len(self.devices[0]),
        }

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis`` at index 0 of the other axis — the
        positions a sequence-parallel body runs on (``shard_map``
        replicates over the other axis)."""
        if axis == self.axis_names[0]:
            return [row[0] for row in self.devices]
        if axis == self.axis_names[1]:
            return list(self.devices[0])
        raise ValueError(f"mesh has no axis {axis!r}; axes are {self.axis_names}")


def create_mesh(
    data: int | None = None,
    model: int = 1,
    *,
    devices: Sequence | None = None,
) -> Mesh:
    """A 2-axis ("data", "model") mesh over ``devices`` (default: every
    visible CUDA device; raises without CUDA). ``data=None`` puts every
    device not on the model axis on the data axis. ``devices`` may name one
    device several times (see the module docstring)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass devices=[...] (for example "
                "['cpu'] * 4) to build a mesh on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if model < 1:
        raise ValueError(f"model axis size must be >= 1, got {model}")
    if data is None:
        if len(devs) % model:
            raise ValueError(f"{len(devs)} devices not divisible by model={model}")
        data = len(devs) // model
    n = data * model
    if data < 1 or n > len(devs):
        raise ValueError(f"mesh {data}x{model} needs {n} devices, have {len(devs)}")
    grid = tuple(tuple(devs[i * model : (i + 1) * model]) for i in range(data))
    return Mesh(grid)


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None) -> Iterator[Mesh | None]:
    """Context manager installing ``mesh`` as the ambient default mesh:
    ``ring_attention`` and ``ulysses_attention`` called without a mesh, and
    a sequence-parallel ``TransformerLM`` built without one, take it."""
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def current_mesh() -> Mesh | None:
    """The innermost mesh installed by :func:`use_mesh`, else None."""
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None
