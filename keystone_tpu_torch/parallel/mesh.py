"""Device mesh — port of ``keystone_tpu/parallel/mesh.py``.

The JAX package is single-controller within a process: one process drives
every device of its mesh. A :class:`Mesh` here is a (data, model) grid of
``torch.device``s in one of two layouts:

- **one process.** Every position is driven by this process. Ring and
  Ulysses attention move shards between the positions along one axis with
  ``tensor.to(device)`` — a peer copy between two cards, and no copy at
  all when two positions name the same device. A batch is placed whole on
  the data axis's first device: all its rows sit on one card.
- **across processes.** After :func:`keystone_tpu_torch.parallel.multihost.initialize`,
  :func:`create_mesh` gives a data axis with one position per process,
  each naming that process's card (``ranks`` holds the rank of each
  position). :func:`shard_batch` then gives this process its row block of
  the padded global batch, on its own card, as a
  :class:`~keystone_tpu_torch.parallel.multihost.GlobalRows`.

A device may appear more than once in a one-process mesh. That is the
counterpart of the JAX package's forced host devices (its tests run an
8-device CPU mesh on one host): one card can run a whole n-position
schedule, with the real offsets and causal skips of every position, and
one CPU can stand in for eight positions in the tests.
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
    # the process rank at each data position when the data axis spans
    # processes; None for a mesh this process drives alone
    ranks: tuple | None = None

    @property
    def spans_processes(self) -> bool:
        return self.ranks is not None and len(self.ranks) > 1

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
    device several times (see the module docstring).

    In a process group of several processes and without ``devices``, the
    data axis spans the processes: one position per rank, each naming
    that rank's card. A model axis across processes is ROADMAP A6 part 2."""
    from keystone_tpu_torch.parallel import multihost

    if devices is None and multihost.process_count() > 1:
        world = multihost.process_count()
        if model != 1:
            raise NotImplementedError(
                f"create_mesh(model={model}) across processes: a model axis over "
                "processes is tensor parallelism (ROADMAP A6 part 2)"
            )
        if data not in (None, world):
            raise ValueError(f"a mesh across {world} processes has data={world}, got {data}")
        return Mesh(
            tuple((d,) for d in multihost.group_devices()), ranks=tuple(range(world))
        )
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
    """Where this process's rows of a batch of rank ``ndim`` live on
    ``mesh`` (default: the ambient mesh), or None without a mesh: this
    process's card on a mesh across processes, else the device at data
    index 0 (one process places a batch whole on one device). ``ndim`` is
    the reference's argument: every rank is placed alike."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return None
    if mesh.spans_processes:
        return mesh.devices[local_position(mesh)][0]
    return mesh.axis_devices(mesh.axis_names[0])[0]


def local_position(mesh: Mesh) -> int:
    """This process's position on the data axis of a mesh across
    processes."""
    from keystone_tpu_torch.parallel import multihost

    return mesh.ranks.index(multihost.process_index())


def local_block(x, mesh: Mesh) -> tuple:
    """This process's row block of ``x`` (numpy array or tensor) zero-padded
    to a multiple of the data axis of a mesh across processes: ``(block,
    lo)``, ``lo`` the global index of its first row."""
    from keystone_tpu_torch.parallel import multihost

    n_data = data_axis_size(mesh)
    placed, _ = pad_batch(x, n_data)
    lo, hi = multihost.row_block(int(placed.shape[0]), local_position(mesh), n_data)
    return placed[lo:hi], lo


def replicated_sharding(mesh: Mesh | None = None) -> torch.device | None:
    """Where this process keeps a value every position holds whole (the
    successor of Spark's ``broadcast``): the same device as its rows, or
    None without a mesh."""
    return data_sharding(mesh)


def data_sharding_fn(mesh: Mesh | None):
    """Per-chunk placement callable for the staging engine: maps a chunk
    — one tensor or a tuple of them (the fused fit stages (data, labels)
    pairs) — to the device of each leaf (None mesh → None, plain
    placement). The one home of the chunk → placement rule."""
    if mesh is None:
        return None
    device = data_sharding(mesh)

    def place(chunk):
        if isinstance(chunk, (list, tuple)):
            return type(chunk)(place(c) for c in chunk)
        return device

    return place


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
    multiple of the data-axis size. A one-process mesh places them on its
    first device (:func:`data_sharding`); a mesh across processes gives
    this process its row block, on its own card, as a
    :class:`~keystone_tpu_torch.parallel.multihost.GlobalRows` whose
    ``n_global`` counts the rows before padding."""
    mesh = mesh or current_mesh()
    x = torch.from_numpy(x) if isinstance(x, np.ndarray) else torch.as_tensor(x)
    if mesh is None:
        return x.to(resolve_device(device))
    n_data = data_axis_size(mesh)
    if not mesh.spans_processes:
        if pad and x.shape[0] % n_data:
            x, _ = pad_batch(x, n_data)
        return x.to(data_sharding(mesh, x.ndim))
    from keystone_tpu_torch.parallel import multihost

    if not pad and x.shape[0] % n_data:
        raise ValueError(f"{x.shape[0]} rows do not split over {n_data} processes; pass pad=True")
    block, lo = local_block(x, mesh)
    return multihost.GlobalRows(block.to(data_sharding(mesh, x.ndim)), int(x.shape[0]), lo)
