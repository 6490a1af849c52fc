"""Device mesh — port of ``keystone_tpu/parallel/mesh.py``.

The JAX package is single-controller within a process: one process drives
every device of its mesh. A :class:`Mesh` here is a grid of
``torch.device``s over named axes — ("data", "model") by default, or any
names, as the reference's 3-axis ``("pipe", "data", "model")`` — in one of
two layouts:

- **one process.** Every position is driven by this process. Ring and
  Ulysses attention, the tensor-parallel block and the pipeline move
  values between the positions along one axis with ``tensor.to(device)``
  — a peer copy between two cards, and no copy at all when two positions
  name the same device. A batch is placed whole on the data axis's first
  device: all its rows sit on one card.
- **across processes.** After :func:`keystone_tpu_torch.parallel.multihost.initialize`,
  :func:`create_mesh` gives a (data, model) grid with one position per
  process, each naming that process's card (``ranks`` holds the rank at
  each position): rank ``r`` sits at ``(r // model, r % model)``, with the
  ranks of one host kept together so the model axis stays within a host
  (the reference's hybrid mesh keeps DCN on the data axis only). Every
  rank builds one process group per axis and position of the other axes,
  all in the same order (:meth:`Mesh.axis_group`). :func:`shard_batch`
  gives this process the row block of its data position of the padded
  global batch, on its own card, as a
  :class:`~keystone_tpu_torch.parallel.multihost.GlobalRows`: the model
  positions of one data row hold the same rows, and the fits, the merges
  and the evaluator reduce over the data axis's group
  (:func:`data_group`), so each row counts once. :func:`process_mesh`
  lays the processes over any axes, such as the reference's 3-axis
  ``("pipe", "data", "model")``.

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


def _nested(grid, fn) -> tuple:
    """``grid`` (nested sequences or a numpy array) as nested tuples of
    ``fn(leaf)``."""
    if isinstance(grid, np.ndarray):
        grid = grid.tolist()
    if isinstance(grid, (list, tuple)):
        return tuple(_nested(g, fn) for g in grid)
    return fn(grid)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of devices over named axes. ``devices`` nests one level per
    axis (``devices[i][j]`` is the device at data index i, model index j of
    the default mesh); ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does. ``devices`` may be given as nested
    lists or a numpy array of devices or device strings."""

    devices: tuple  # nested tuples of torch.device, one level per axis
    axis_names: tuple = (DATA_AXIS, MODEL_AXIS)
    # the process rank at each position (nested like ``devices``) when the
    # mesh spans processes; None for a mesh this process drives alone
    ranks: tuple | None = None
    # axis name -> the process group of this rank's line along it
    _groups: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "devices", _nested(self.devices, torch.device))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if self.ranks is not None:
            object.__setattr__(self, "ranks", _nested(self.ranks, int))
        if self.grid.ndim != len(self.axis_names):
            raise ValueError(f"a device grid of {self.grid.ndim} dims for axes {self.axis_names}")

    @property
    def grid(self) -> np.ndarray:
        """The devices as a numpy object array, one dim per axis."""
        return _grid(self.devices, len(self.axis_names))

    @property
    def rank_grid(self) -> np.ndarray | None:
        return None if self.ranks is None else _grid(self.ranks, len(self.axis_names))

    @property
    def spans_processes(self) -> bool:
        return self.ranks is not None and self.rank_grid.size > 1

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.grid.shape))

    def _axis(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}; axes are {self.axis_names}")
        return self.axis_names.index(axis)

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis`` at index 0 of the other axes — the
        positions a sequence-parallel body runs on (``shard_map``
        replicates over the other axes)."""
        a = self._axis(axis)
        index = [0] * len(self.axis_names)
        index[a] = slice(None)
        return list(self.grid[tuple(index)])

    def coords(self, rank: int | None = None) -> dict:
        """``{axis: index}`` of the position process ``rank`` (default:
        this one) holds on a mesh across processes."""
        from keystone_tpu_torch.parallel import multihost

        rank = multihost.process_index() if rank is None else rank
        where = np.argwhere(self.rank_grid == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} holds {len(where)} positions of {self.ranks}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def axis_group(self, axis: str):
        """The :class:`~keystone_tpu_torch.parallel.collectives.AxisGroup` of
        this process's line along ``axis`` on a mesh across processes (its
        ranks in axis order and this rank's index there), or None when the
        axis has one position. Built for every axis when the mesh is."""
        self._axis(axis)
        return self._groups.get(axis)


def _grid(nested, ndim: int) -> np.ndarray:
    """Nested tuples as an object array of up to ``ndim`` dims."""
    shape = []
    level = nested
    while len(shape) < ndim and isinstance(level, tuple):
        shape.append(len(level))
        level = level[0]
    out = np.empty(shape, dtype=object)
    for index in np.ndindex(*shape):
        v = nested
        for i in index:
            v = v[i]
        out[index] = v
    return out


def build_groups(mesh: Mesh) -> Mesh:
    """Make ``mesh``'s process groups: one per axis and position of the
    other axes, every rank creating every group in the same order
    (``torch.distributed.new_group`` requires it). A line of all ranks in
    rank order is the default group; an axis of one position gets none."""
    from keystone_tpu_torch.parallel import multihost
    from keystone_tpu_torch.parallel.collectives import AxisGroup

    ranks = mesh.rank_grid
    me = multihost.process_index()
    world = multihost.process_count()
    for a, axis in enumerate(mesh.axis_names):
        if ranks.shape[a] == 1:
            continue
        moved = np.moveaxis(ranks, a, -1).reshape(-1, ranks.shape[a])
        for line in moved:
            members = tuple(int(r) for r in line)
            if members == tuple(range(world)):
                pg = None
            else:
                import torch.distributed as dist

                pg = dist.new_group(list(members))
            if me in members:
                mesh._groups[axis] = AxisGroup(pg, members, members.index(me))
    return mesh


def host_groups(hosts: Sequence[str]) -> dict:
    """The ranks of each host, hosts in order of first appearance — the
    counterpart of the reference's ``_slice_groups`` (its DCN slices are
    the port's hosts)."""
    groups: dict = {}
    for rank, host in enumerate(hosts):
        groups.setdefault(host, []).append(rank)
    return groups


def mesh_order(hosts: Sequence[str], model: int) -> list:
    """The ranks in the order :func:`create_mesh` lays them on a (data,
    model) grid: host by host when every host holds a whole number of
    model lines (so each model line stays within a host and only the data
    axis crosses hosts), else rank order."""
    groups = host_groups(hosts)
    if len(groups) > 1 and all(len(g) % model == 0 for g in groups.values()):
        return [r for g in groups.values() for r in g]
    return list(range(len(hosts)))


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
    mesh spans the processes, one position per rank, each naming that
    rank's card: rank ``r`` at ``(r // model, r % model)`` of the order
    :func:`mesh_order` gives, and one process group per axis line."""
    from keystone_tpu_torch.parallel import multihost

    if model < 1:
        raise ValueError(f"model axis size must be >= 1, got {model}")
    if devices is None and multihost.process_count() > 1:
        world = multihost.process_count()
        if data is None:
            if world % model:
                raise ValueError(f"{world} processes not divisible by model={model}")
            data = world // model
        if data * model != world:
            raise ValueError(
                f"a mesh across {world} processes has data x model = {world}, "
                f"got {data}x{model}"
            )
        return process_mesh({DATA_AXIS: data, MODEL_AXIS: model})
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass devices=[...] (for example "
                "['cpu'] * 4) to build a mesh on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if data is None:
        if len(devs) % model:
            raise ValueError(f"{len(devs)} devices not divisible by model={model}")
        data = len(devs) // model
    n = data * model
    if data < 1 or n > len(devs):
        raise ValueError(f"mesh {data}x{model} needs {n} devices, have {len(devs)}")
    grid = tuple(tuple(devs[i * model : (i + 1) * model]) for i in range(data))
    return Mesh(grid)


def process_mesh(axes: dict) -> Mesh:
    """A mesh across the processes of the group over the named ``axes``
    (name → size, outermost first, as ``{"pipe": 2, "data": 1, "model":
    2}``), one position per rank, each naming that rank's card: the ranks
    fill the grid in row-major order of :func:`mesh_order` (the last axis
    stays within a host where the hosts allow it), and every rank builds
    the process groups of every axis (:func:`build_groups`). The sizes
    multiply to the group's size. :func:`create_mesh` builds its (data,
    model) mesh across processes this way; a 3-axis mesh is the
    reference's ``Mesh(devices.reshape(p, d, m), ("pipe", "data",
    "model"))``."""
    from keystone_tpu_torch.parallel import multihost

    names, sizes = tuple(axes), tuple(int(n) for n in axes.values())
    world = multihost.process_count()
    if math.prod(sizes) != world or min(sizes, default=0) < 1:
        raise ValueError(f"a mesh across {world} processes over {dict(axes)}")
    order = mesh_order(multihost.group_hosts(), sizes[-1])
    devs = multihost.group_devices()
    ranks = np.asarray(order, dtype=object).reshape(sizes)
    grid = np.empty(sizes, dtype=object)
    for index in np.ndindex(*sizes):
        grid[index] = devs[ranks[index]]
    return build_groups(Mesh(grid, names, ranks=ranks))


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
        from keystone_tpu_torch.parallel import multihost

        return multihost.local_device()
    return mesh.axis_devices(mesh.axis_names[0])[0]


def local_position(mesh: Mesh) -> int:
    """This process's position on the data axis of a mesh across
    processes."""
    return mesh.coords().get(DATA_AXIS, 0)


def model_sharding(mesh: Mesh | None = None, ndim: int = 2) -> tuple | None:
    """The layout of a weight or feature-block matrix whose last axis is
    split over "model": a partition spec, one entry per dim (the axis name
    or None), as the reference's ``P(None, ..., "model")``; None without a
    mesh. :func:`keystone_tpu_torch.models.lm.sharding.shard_params` lays
    the LM's weights out by such specs."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return None
    return (None,) * (ndim - 1) + (MODEL_AXIS,)


def local_block(x, mesh: Mesh) -> tuple:
    """This process's row block of ``x`` (numpy array or tensor) zero-padded
    to a multiple of the data axis of a mesh across processes: ``(block,
    lo)``, ``lo`` the global index of its first row. The block is the one
    of this process's data position: every model (and pipe) position of
    one data row holds the same rows, as the reference's ``data_sharding``
    replicates over ``model``."""
    from keystone_tpu_torch.parallel import multihost

    n_data = data_axis_size(mesh)
    placed, _ = pad_batch(x, n_data)
    lo, hi = multihost.row_block(int(placed.shape[0]), local_position(mesh), n_data)
    return placed[lo:hi], lo


def data_group(mesh: Mesh | None):
    """The processes that hold a batch's row blocks once each: this
    process's line along the data axis of a mesh across processes (an
    :class:`~keystone_tpu_torch.parallel.collectives.AxisGroup` of one
    process when the axis has one position), None without such a mesh
    (every process, in rank order). A reduction over the rows runs over
    this group, so the replicas of a data row along the other axes count
    its rows once; every line computes the same bytes."""
    if mesh is None or not mesh.spans_processes:
        return None
    group = mesh.axis_group(DATA_AXIS) if DATA_AXIS in mesh.axis_names else None
    if group is None:
        from keystone_tpu_torch.parallel import multihost
        from keystone_tpu_torch.parallel.collectives import AxisGroup

        return AxisGroup(None, (multihost.process_index(),), 0)
    return group


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
    return multihost.GlobalRows(block.to(data_sharding(mesh, x.ndim)), int(x.shape[0]), lo,
                                data_group(mesh))
