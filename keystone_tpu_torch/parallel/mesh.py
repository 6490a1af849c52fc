"""Device mesh — port of the parts of ``keystone_tpu/parallel/mesh.py`` that
sequence-parallel attention and the data-parallel workloads read.

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
import math
import threading
from typing import Iterator, Sequence

import numpy as np
import torch

from keystone_tpu_torch.core.runtime import resolve_device

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


def data_sharding(mesh: Mesh | None = None, ndim: int = 2) -> torch.device | None:
    """Where a batch of rank ``ndim`` lives on ``mesh`` (default: the
    ambient mesh): the device at data index 0, or None without a mesh.
    One process drives the whole mesh, so a batch is placed whole on that
    device; splitting its rows over several cards waits for the
    multi-process layer (ROADMAP A6). ``ndim`` is the reference's
    argument: every rank is placed alike."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return None
    return mesh.axis_devices(mesh.axis_names[0])[0]


def data_axis_size(mesh: Mesh | None) -> int:
    """Size of the "data" axis; 1 for no mesh or a mesh without one."""
    if mesh is None:
        return 1
    return int(mesh.shape.get(DATA_AXIS, 1))


def shard_chunk_size(chunk_size: int, mesh: Mesh | None) -> int:
    """``chunk_size`` rounded up to a multiple of the data-axis size."""
    n = data_axis_size(mesh)
    return -(-int(chunk_size) // n) * n


def pad_batch(x, multiple: int) -> tuple:
    """Zero-pad the leading axis of ``x`` (numpy array or tensor) to a
    multiple of ``multiple``; returns ``(padded, n_valid)``. Reductions
    downstream mask rows ≥ n_valid."""
    n = x.shape[0]
    target = math.ceil(n / multiple) * multiple if n else multiple
    if target == n:
        return x, n
    if isinstance(x, np.ndarray):
        return np.pad(x, [(0, target - n)] + [(0, 0)] * (x.ndim - 1)), n
    padded = x.new_zeros((target,) + tuple(x.shape[1:]))
    padded[:n] = x
    return padded, n


def shard_batch(x, mesh: Mesh | None = None, *, pad: bool = True, device=None):
    """Place a host batch for a data-parallel pass. Without a mesh (and
    none installed) the rows go to ``device``: the card unless the caller
    asks for the CPU. With a mesh they are zero-padded (when ``pad``) to a
    multiple of the data-axis size and placed on the mesh's first device
    (:func:`data_sharding`); spreading them over several cards waits for
    the multi-process layer (ROADMAP A6)."""
    mesh = mesh or current_mesh()
    x = torch.from_numpy(x) if isinstance(x, np.ndarray) else torch.as_tensor(x)
    if mesh is None:
        return x.to(resolve_device(device))
    n_data = data_axis_size(mesh)
    if pad and x.shape[0] % n_data:
        x, _ = pad_batch(x, n_data)
    return x.to(data_sharding(mesh, x.ndim))
